"""Headline qLDPC decode experiment: the [[400,16,6]] symmetric hypergraph
product of the 12x16 MKMN seed code, decoded under a Z-biased channel at
p = 0.05 with adaptive min-sum BP and osd_cs order 42 (the configuration of
``examples/qldpc_decode_example.py``).

    python -m bp_osd_tpu_torch.examples.qldpc_decode_example \\
        [--runs 10000] [--batch-size 2000] [--output qldpc_decode_results_torch.json]
"""

from __future__ import annotations

import argparse

from ..codes import hgp, mkmn_16_4_6
from ..sim import css_decode_sim

# css_decode_sim options of the flagship experiment (and of large_hgp_ler)
OSD_OPTIONS = {
    "error_rate": 0.05,
    "target_runs": 10000,
    "xyz_error_bias": [0, 0, 1],
    "bp_method": "ms",
    "ms_scaling_factor": 0,
    "osd_method": "osd_cs",
    "osd_order": 42,
    "channel_update": None,
    "seed": 42,
    "max_iter": 0,
    "batch_size": 2000,
}


def main(argv=None) -> str:
    """Run the experiment; returns the sim's JSON output dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=OSD_OPTIONS["target_runs"])
    ap.add_argument("--batch-size", type=int, default=OSD_OPTIONS["batch_size"])
    ap.add_argument("--output", default="qldpc_decode_results_torch.json")
    args = ap.parse_args(argv)
    qcode = hgp(mkmn_16_4_6())  # symmetric hypergraph product of the seed code
    sim = css_decode_sim(hx=qcode.hx, hz=qcode.hz,
                         **dict(OSD_OPTIONS, target_runs=args.runs,
                                batch_size=args.batch_size, output_file=args.output,
                                run_sim=0))
    return sim.run_decode_sim()


if __name__ == "__main__":
    main()
