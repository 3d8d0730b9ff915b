"""Run one cell of the benchmark of ``bp_osd_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, metrics and bounds are in
``BENCHMARK.json``; see :mod:`benchmark.cell` for what a run does.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``); the last lines of standard error give each number the
check compared beside its limit.  Without a CUDA card, or with fewer cards
than the cell asks for, the run prints no result and exits 2; if the JAX
package or JAX is loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (Linux: from
    ``/proc/self/stat``; elsewhere, now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# load from one process with few threads: the decode's host work is serial
os.environ.setdefault("OMP_NUM_THREADS", "1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark import cell, spec

    c = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        cell.log(f"{args.workload} needs {c.chips} CUDA card(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START, cell=c)
    loaded = cell.forbidden_modules()
    if loaded:
        cell.log(f"the run loaded {loaded}: the benchmark runs the port alone")
        return 3
    for k, v in out["checks"].items():
        cell.log(f"check {k} {v['value']} {v['op']} {v['limit']}")
    cell.log(f"correct {out['correct']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
