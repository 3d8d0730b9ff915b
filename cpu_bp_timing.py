"""Time the port's plain product-sum BP on the CPU at the flagship code.

    python cpu_bp_timing.py [--threads 8] [--batch 16384] [--max-iter 20]
                            [--reps 3] [--tree DIR]

Decodes ``--batch`` fresh [[400,16,6]] syndromes (p = 0.05, seeded) with
``bp_decode(TannerGraph(H, device="cpu"), ..., bp_method="product_sum")``
at ``--threads`` torch threads, and times ``decoder/bp.py:_elementwise``
on ``torch.atanh`` over one ``[batch, m, wr]`` message tensor.  Prints one
JSON line: the median and every wall in milliseconds (host clock, after one
warm-up call).  ``--tree`` imports ``bp_osd_tpu_torch`` from another
checkout, so two trees can be timed in turns on one host.  These are CPU
timings of plain torch, not numbers of any accelerator.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def walls(fn, reps: int) -> list[float]:
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--max-iter", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    from bp_osd_tpu_torch.codes import hgp, mkmn_16_4_6
    from bp_osd_tpu_torch.decoder import TannerGraph, bp_decode, llr_from_channel
    from bp_osd_tpu_torch.decoder.bp import _elementwise

    torch.set_num_threads(args.threads)
    H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
    graph = TannerGraph(H, device="cpu")
    rng = np.random.default_rng(20261017)
    errors = (rng.random((args.batch, graph.n)) < 0.05).astype(np.uint8)
    synd = torch.from_numpy((errors @ H.T % 2).astype(np.uint8))
    llr0 = llr_from_channel(np.full(graph.n, 0.05))
    bp_ms = walls(lambda: bp_decode(graph, synd, llr0, bp_method="product_sum",
                                    max_iter=args.max_iter), args.reps)
    x = torch.from_numpy(rng.uniform(-1, 1, (args.batch, graph.m, graph.wr)).astype(np.float32))
    atanh_ms = walls(lambda: _elementwise(torch.atanh, x), args.reps)
    print(json.dumps({
        "tree": os.path.abspath(args.tree), "torch": torch.__version__,
        "threads": torch.get_num_threads(), "cpu_count": os.cpu_count(),
        "batch": args.batch, "max_iter": args.max_iter,
        "bp_ms": float(np.median(bp_ms)), "bp_walls_ms": bp_ms,
        "atanh_elements": x.numel(), "atanh_ms": float(np.median(atanh_ms)),
        "atanh_walls_ms": atanh_ms,
    }))


if __name__ == "__main__":
    main()
