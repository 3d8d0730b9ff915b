"""Surface-code threshold sweep: batched BP+OSD logical error rates over a
distance x physical-error-rate grid (``examples/threshold_sweep.py``).

    python -m bp_osd_tpu_torch.examples.threshold_sweep \\
        [--runs 10000] [--distances 3 5 7 9] [--output threshold_sweep_results_torch.json]

writes one JSON line per (d, p) point; plot LER against p per distance to
read off the threshold crossing.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..codes import surface_code
from ..sim import css_decode_sim

DISTANCES = (3, 5, 7, 9)
ERROR_RATES = (0.04, 0.06, 0.08, 0.09, 0.10, 0.11, 0.12)


def sweep(distances=DISTANCES, error_rates=ERROR_RATES, target_runs=10000,
          batch_size=2500, out=sys.stdout):
    for d in distances:
        qcode = surface_code(d)
        for p in error_rates:
            sim = css_decode_sim(
                hx=qcode.hx,
                hz=qcode.hz,
                error_rate=float(p),
                target_runs=target_runs,
                batch_size=batch_size,
                bp_method="ms",
                ms_scaling_factor=0.625,
                osd_method="osd_cs",
                osd_order=10,
                channel_update=None,
                tqdm_disable=1,
                check_code=0,
                seed=d * 1000 + int(p * 1000),
                run_sim=0,
            )
            result = json.loads(sim.run_decode_sim())
            point = {
                "d": d,
                "N": result["N"],
                "p": p,
                "osd0_ler": result["osd0_logical_error_rate"],
                "osd0_ler_eb": result["osd0_logical_error_rate_eb"],
                "osdw_ler": result["osdw_logical_error_rate"],
                "osdw_ler_eb": result["osdw_logical_error_rate_eb"],
                "runs": result["run_count"],
            }
            print(json.dumps(point), file=out, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10000)
    ap.add_argument("--distances", type=int, nargs="+", default=list(DISTANCES))
    ap.add_argument("--output", default="threshold_sweep_results_torch.json")
    args = ap.parse_args(argv)
    with open(args.output, "w") as f:
        sweep(distances=args.distances, target_runs=args.runs, out=f)


if __name__ == "__main__":
    main()
