"""Generate and save the hypergraph-product benchmark code
(``examples/generate_hgp_codes.py``): builds the HGP code of an MKMN-style
classical seed, canonicalizes its logicals, validates it, and saves the
matrices as text files.  Code construction only: it runs on the CPU and
launches no kernel.

    python -m bp_osd_tpu_torch.examples.generate_hgp_codes [--out hgp_codes_torch]

writes ``hgp_<code params>_{hx,hz,lx,lz}.txt`` into the output directory.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..codes import hgp, mkmn_16_4_6

OUT_DIR = "hgp_codes_torch"


def generate(seed_matrix, out_dir=OUT_DIR):
    """Build, canonicalize, validate and save ``hgp(seed_matrix)``; returns
    the code."""
    os.makedirs(out_dir, exist_ok=True)
    qcode = hgp(seed_matrix, compute_distance=True)
    qcode.canonical_logicals()
    if not qcode.test(show_tests=False):
        raise RuntimeError(f"hgp code {qcode.code_params} fails its own checks")
    stem = os.path.join(out_dir, f"hgp_{qcode.code_params}")
    for name in ("hx", "hz", "lx", "lz"):
        np.savetxt(f"{stem}_{name}.txt", getattr(qcode, name).toarray(), fmt="%d")
    print(f"saved {qcode.code_params} to {out_dir}")
    return qcode


def main(argv=None):
    """Generate the [[400,16,6]] code of the MKMN (16, 4, 6) seed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    return generate(mkmn_16_4_6(), out_dir=args.out)


if __name__ == "__main__":
    main()
