"""The control of the check that decides ``correct``: it must come out not
correct.

The configurations state float32 BP messages, so the control is the
reference itself, put in the program's place and computed with bfloat16
messages (the nearest precision below float32 outside matrix products).  For
each seed this makes the cell's pool at the cell's own size, as a run does,
takes the same check batches from the seed, decodes them with the control,
and compares them with the float32 reference exactly as a run compares the
program's outputs:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

One JSON line a seed: the compared numbers and whether the check passed.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(name: str, seed: int, device=None, cell=None) -> dict:
    """The control's compared numbers on one seed of cell ``name``."""
    import numpy as np
    import torch

    from benchmark import cell as cell_mod
    from benchmark import codes, spec, traffic

    c = cell or spec.cell(name)
    ref = spec.reference(c)
    dev = torch.device(device or "cuda")
    H, proto, lift = codes.build(c.config["code"], c.home)
    pool = traffic.make_pool(H, c.traffic, seed, dev)
    rng = np.random.default_rng([int(seed), 1])
    P = pool.shape[0]
    hold = rng.choice(P, size=min(int(c.traffic["check_batches"]), P), replace=False).tolist()
    synd = {j: pool[j].clone() for j in hold}
    del pool
    nums, _, _ = cell_mod.check(c, ref, H, proto, lift, synd, {}, rng, dev,
                                program_dtype=torch.bfloat16)
    ok, checks = cell_mod.judged(nums)
    return {"workload": name, "seed": seed, "correct": ok,
            "checks": {k: v["value"] for k, v in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    for s in args.seeds.split(","):
        print(json.dumps(control(args.workload, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
