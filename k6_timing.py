"""Time kernel K6 (the lifted BP decode, ``csrc/bp_lifted.cu``) on the card.

    python3 k6_timing.py [--tree DIR] [--reps 7] [--sweep] [--out FILE]

At the [[10000,420]] lifted product of ``bench_large.py`` (lift 400,
min-sum 0.625, max_iter 100), with ``--tree``'s ``bp_osd_tpu_torch``
(default: this checkout; its kernels are built into that tree), on

- 512 rows at p = 0.005 and 512 at p = 0.028, the batches of
  ``chip_smoke.py`` phase 8 (errors drawn with numpy from seeds 20261018
  and 20261019, syndromes on the card);
- one row of a uniform random syndrome, which runs all 100 iterations
  (the latency of a lone slow row, reported a iteration),

it holds K6 to the plain version ``_bp_rows`` bit for bit and times it with
CUDA events (median of ``--reps`` after a warm-up) beside its bound
(``utils/measure.py:k6_bound``), with the launch plan.  ``--sweep`` also
times every team size of ``ops/cuda_lifted_bp.py:TEAM_SIZES`` (forced
through ``_THREADS``; trees whose wrapper has it).  Prints one JSON line
with the card's name and power limit (and writes it to ``--out``).  Two
checkouts timed in turns in one call compare on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SEED = 20261016  # chip_smoke.py's: phase 8 draws its batches from SEED + 2 and SEED + 3
PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]
LIFT, B, MAX_ITER, MSF = 400, 512, 100, 0.625


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k6_timing.py needs a CUDA card; torch.cuda.is_available() is false")
    import bp_osd_tpu_torch
    import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6
    from bp_osd_tpu_torch.codes import lifted_hgp
    from bp_osd_tpu_torch.decoder.bp import llr_from_channel
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, _bp_rows
    from bp_osd_tpu_torch.ops import _build
    from bp_osd_tpu_torch.utils.measure import card_line, check, cuda_ms, k6_bound, same

    assert os.path.dirname(os.path.dirname(os.path.abspath(bp_osd_tpu_torch.__file__))) == tree
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = lifted_hgp(PROTO, lift=LIFT)
    H_f = torch.as_tensor(q.hx.toarray(), dtype=torch.float32, device=dev)
    g = LiftedGraph(q.hx_proto, LIFT, dev)
    code_s = time.perf_counter() - t0

    def batch(p, seed):
        rng = np.random.default_rng(seed)
        err = torch.as_tensor((rng.random((B, g.n)) < p).astype(np.float32), device=dev)
        return torch.remainder(err @ H_f.T, 2).to(torch.uint8)

    gen = torch.Generator(dev).manual_seed(SEED + 21)
    lone = (torch.rand(1, g.m, generator=gen, device=dev) < 0.5).to(torch.uint8)
    cases = {"p0.005": (batch(0.005, SEED + 2), 0.005), "p0.028": (batch(0.028, SEED + 3), 0.028),
             "lone_row": (lone, 0.028)}

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def run(synd, l0):
        return k6.bp_lifted(g, synd, l0, "minimum_sum", MAX_ITER, MSF)

    def timed(synd, l0, want):
        got = run(synd, l0)
        torch.cuda.synchronize()
        for name, a, b in zip(("hard", "llr", "converged", "iterations"), got, want):
            check(same(bits(a), bits(b)), f"K6 {name} differs from _bp_rows")
        return cuda_ms(lambda: run(synd, l0), args.reps)

    out = {"tree": os.path.basename(tree), "card": card_line(), "torch": torch.__version__,
           "build_s": round(build_s, 1), "code_s": round(code_s, 1),
           "plan": k6.bp_lifted_plan(g), "cases": {}}
    plain = {}
    for name, (synd, p) in cases.items():
        l0 = llr_from_channel(np.full(g.n, p)).to(dev).expand(synd.shape[0], g.n)
        want = _bp_rows(g, synd, l0, "minimum_sum", MAX_ITER, MSF)
        plain[name] = (synd, l0, want)
        ms = timed(synd, l0, want)
        bound = k6_bound(g, want[3], prior_rows=1, device_route=False)
        its = int(want[3].sum())
        out["cases"][name] = {"rows": int(synd.shape[0]), "row_iterations": its,
                              "converged": int(want[2].sum()), "ms": ms,
                              "ms_per_row_iteration": ms / its, "bound_ms": bound.ms,
                              "bound_by": bound.by, "share_of_bound": bound.ms / ms}
    if args.sweep and hasattr(k6, "_THREADS"):
        out["sweep"] = {}
        for T in k6.TEAM_SIZES:
            k6._THREADS = T
            try:
                entry = {"plan": k6.bp_lifted_plan(g)}
                for name, (synd, l0, want) in plain.items():
                    entry[f"{name}_ms"] = timed(synd, l0, want)
                entry["lone_row_ms_per_iteration"] = entry["lone_row_ms"] / MAX_ITER
            finally:
                k6._THREADS = 0
            out["sweep"][str(T)] = entry
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
