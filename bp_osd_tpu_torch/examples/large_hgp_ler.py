"""OSDW logical error rates of the larger HGP codes [[625,25,8]] and
[[900,36,10]] (hypergraph products of the MKMN seeds), under the flagship
experiment's configuration (``examples/large_hgp_ler.py``): p = 0.05,
Z-biased, adaptive min-sum, osd_cs order 42, max_iter 0 -> N.

    python -m bp_osd_tpu_torch.examples.large_hgp_ler \\
        [--runs 10000] [--codes 625|900|both] [--output-dir .]

writes ``hgp_<625|900>_decode_results_torch.json`` into the output directory.
"""

from __future__ import annotations

import argparse
import os

from ..codes import hgp, mkmn_20_5_8, mkmn_24_6_10
from ..sim import css_decode_sim
from .qldpc_decode_example import OSD_OPTIONS

CODES = {"625": mkmn_20_5_8, "900": mkmn_24_6_10}


def main(argv=None) -> dict:
    """Run the experiment; returns ``{code name: the sim's JSON output dict}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=OSD_OPTIONS["target_runs"])
    ap.add_argument("--codes", choices=("625", "900", "both"), default="both")
    ap.add_argument("--output-dir", default=".")
    args = ap.parse_args(argv)
    names = list(CODES) if args.codes == "both" else [args.codes]
    results = {}
    for name in names:
        qcode = hgp(CODES[name]())
        print(f"--- [[{qcode.N},{qcode.K}]] (hgp of mkmn seed {name}) ---", flush=True)
        path = os.path.join(args.output_dir, f"hgp_{name}_decode_results_torch.json")
        sim = css_decode_sim(hx=qcode.hx, hz=qcode.hz,
                             **dict(OSD_OPTIONS, target_runs=args.runs, output_file=path,
                                    run_sim=0))
        results[name] = sim.run_decode_sim()
    return results


if __name__ == "__main__":
    main()
