"""OSDW logical error rates at lifted-product scale (n = 10^4): the
[[10000,420]] (3,4)-regular lifted product at lift 400, Z-biased errors,
shift-routed lifted BP and OSD on the failures through
``BpOsdDecoder(hx, proto=hx_proto, lift=400)``, logical failures checked
against the code's lx basis (the experiment of
``examples/lifted_product_ler.py``).  Each point draws its errors from
``numpy.random.default_rng(42)`` in batches of 512, as that script does.

    python -m bp_osd_tpu_torch.examples.lifted_product_ler \\
        [--runs 4096] [--points 0.005 0.01 0.02 0.03] [--lift 400] \\
        [--output lifted_product_decode_results_torch.json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..codes import lifted_hgp
from ..decoder import BpOsdDecoder
from ..sim.css_decode_sim import _mod2mul

PROTO = [
    [(0,), (0,), (0,), (0,)],
    [(0,), (1,), (2,), (3,)],
    [(0,), (2,), (4,), (6,)],
]
LIFT = 400
P_POINTS = (0.005, 0.010, 0.020, 0.030)
B = 512
MAX_ITER = 100
OSD_ORDER = 15
SEED = 42


def run_point(qcode: lifted_hgp, p: float, runs: int, device=None) -> dict:
    """One physical error rate: ``max(runs // 512, 1)`` batches of 512."""
    dec = BpOsdDecoder(qcode.hx, proto=qcode.hx_proto, lift=qcode.lift, error_rate=p,
                       max_iter=MAX_ITER, bp_method="minimum_sum", ms_scaling_factor=0.625,
                       osd_method="osd_cs", osd_order=OSD_ORDER, device=device)
    dev = dec.device
    H = torch.as_tensor(np.asarray(qcode.hx.toarray(), np.float32), device=dev)
    lx = torch.as_tensor(np.asarray(qcode.lx.toarray(), np.float32), device=dev)
    n = H.shape[1]
    steps = max(runs // B, 1)
    rng = np.random.default_rng(SEED)
    fails = {"bp": 0, "osd0": 0, "osdw": 0}
    converged = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        err = torch.as_tensor((rng.random((B, n)) < p).astype(np.uint8), device=dev)
        dec.decode_batch(_mod2mul(err, H), outputs="device")
        converged += int(dec.converge_batch.sum())
        for kind, corr in (("bp", dec.bp_decoding_batch), ("osd0", dec.osd0_decoding_batch),
                           ("osdw", dec.osdw_decoding_batch)):
            # a residual that anticommutes with any lx row is a logical failure
            fails[kind] += int((_mod2mul(err ^ corr, lx) == 1).any(1).sum())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    N = steps * B
    point = {"runs": N, "bp_converged_frac": round(converged / N, 4),
             "osd_samples": N - converged,
             "runtime_s": round(time.perf_counter() - t0, 1)}
    for kind, f in fails.items():
        f /= N
        point[f"{kind}_logical_error_rate"] = round(f, 5)
        point[f"{kind}_error_bar"] = round(float(np.sqrt(max(f * (1 - f), 1e-12) / N)), 5)
    return point


def main(argv=None) -> dict:
    """Run every point; writes and returns the results dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4096)
    ap.add_argument("--points", type=float, nargs="+", default=list(P_POINTS))
    ap.add_argument("--lift", type=int, default=LIFT)
    ap.add_argument("--output", default="lifted_product_decode_results_torch.json")
    args = ap.parse_args(argv)
    t0 = time.time()
    qcode = lifted_hgp(PROTO, lift=args.lift)
    n = qcode.hx.shape[1]
    print(f"[[{n},{qcode.K}]] m={qcode.hx.shape[0]} K={qcode.lx.shape[0]} built with "
          f"logicals in {time.time() - t0:.1f}s", flush=True)
    results = {}
    for p in args.points:
        results[str(p)] = run_point(qcode, p, args.runs)
        print(f"p={p}: {results[str(p)]}", flush=True)
    out = {
        "code": f"[[{n},{qcode.K}]] (3,4)-regular lifted product, lift {args.lift}",
        "error_model": "Z-biased iid (flagship artifact convention)",
        "bp_method": "minimum_sum", "ms_scaling_factor": 0.625,
        "max_iter": MAX_ITER, "osd_method": "osd_cs",
        "osd_order": OSD_ORDER, "seed": SEED,
        "points": results,
    }
    with open(args.output, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
