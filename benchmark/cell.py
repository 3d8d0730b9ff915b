"""One run of one cell: set-up, the measured window, the check and the
result line.

The timed path is ``BpOsdDecoder(...).decode_batch(synd, outputs="device")``
in a closed loop: a batch is submitted, ``torch.cuda.synchronize()`` ends
it, its latency is the host clock between the two, and the next batch is
submitted after that.  The window cycles through the pool of syndromes that
set-up made (:mod:`.traffic`).

After the window, with the peak memory read and the program freed,
``check_batches`` decodes of the window, a uniform sample drawn from the
seed, are compared with the reference (:mod:`.reference`, or the
configuration's own, :func:`.spec.reference`), which the benchmark runs on
the same parity-check matrix and syndromes at the configuration's whole
``decoder`` entry:

- ``bp_rows_differ``: rows whose hard decision, ``converged`` or
  iterations differ from the reference's BP (limit 0);
- ``osd_rows_differ``: rows whose osd0 or osdw differ: on rows BP
  converged, from the reference's hard decision; on up to
  ``check_osd_rows`` failing rows drawn from the seed, from the reference's
  osd_cs (limit 0);
- ``osdw_unsatisfied``: rows whose osdw does not satisfy its syndrome
  (limit 0);
- ``rows_checked``: the rows compared (at least one); ``osd_rows_checked``:
  the failing rows compared with the reference's osd_cs (at least one).

``correct`` holds when no batch raised and every number is within its
limit.  The same reference counts the needed work of the failing rows'
eliminations, which the traced run's roofline shares use (:mod:`.work`).
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import codes, spec, traffic
from .trace import Window, record
from .work import bp_work, osd_cs_work

FORBIDDEN = ("jax", "jaxlib", "flax", "bp_osd_tpu")  # top-level module names


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_program(cell: spec.Cell, H, proto, lift, dev):
    """The system under test: ``BpOsdDecoder`` at the configuration's
    options and the traffic's error rate."""
    from bp_osd_tpu_torch.decoder.bposd import BpOsdDecoder

    opts = dict(cell.config["decoder"])
    return BpOsdDecoder(H, error_rate=float(cell.traffic["p"]), proto=proto, lift=lift,
                        device=dev, **opts)


def warm_up(dec, pool: torch.Tensor, batches: int, dev) -> int:
    """Decode the first ``batches`` pool batches, and more until one with a
    row BP leaves to OSD has run, so every kernel of the cell's path has
    loaded and the allocator holds the blocks of those batches' shapes;
    returns the batches decoded."""
    done = 0
    seen_osd = False
    while done < pool.shape[0] and (done < batches or not seen_osd):
        dec.decode_batch(pool[done], outputs="device")
        _sync(dev)
        seen_osd |= bool((~dec.converge_batch).any())
        done += 1
    return done


class Loop(NamedTuple):
    """What the window leaves: its length, each batch's latency and pool
    batch, the batches that raised, the last decode's ``converged`` and
    iterations of every pool batch, and the decodes held for the check, by
    pool batch."""

    seconds: float
    latency: list
    pool_index: list
    raised: int
    conv: dict
    iters: dict
    held: dict


def window(dec, pool: torch.Tensor, seconds: float, keep: int, rng, dev,
           marker: bool = False) -> Loop:
    """The closed loop for ``seconds``, with the host's garbage collector off
    (the harness's bookkeeping keeps a few references a batch, no more).
    ``keep`` decodes of the window, a uniform sample drawn from ``rng``
    (reservoir sampling), are held whole for the check."""
    P = pool.shape[0]
    lat, idx, conv, iters, slots = [], [], {}, {}, []
    raised = 0
    gc.disable()
    try:
        t_w0 = t_end = time.perf_counter()
        i = 0
        while i == 0 or t_end - t_w0 < seconds:
            j = i % P
            i += 1
            t0 = time.perf_counter()
            try:
                if marker:
                    torch.cuda._sleep(0)
                dec.decode_batch(pool[j], outputs="device")
                _sync(dev)
            except Exception as exc:  # a batch that raises counts as failed rows
                t_end = time.perf_counter()
                lat.append(t_end - t0)
                raised += 1
                log(f"batch {i - 1} raised: {type(exc).__name__}: {exc}")
                continue
            t_end = time.perf_counter()
            lat.append(t_end - t0)
            idx.append(j)
            conv[j], iters[j] = dec.converge_batch, dec.iter_batch
            slot = len(idx) - 1 if len(idx) <= keep else int(rng.integers(len(idx)))
            if slot < keep:
                out = (j, (dec.bp_decoding_batch, dec.converge_batch, dec.iter_batch,
                           dec.osd0_decoding_batch, dec.osdw_decoding_batch))
                if slot == len(slots):
                    slots.append(out)
                else:
                    slots[slot] = out
    finally:
        gc.enable()
    return Loop(t_end - t_w0, lat, idx, raised, conv, iters, dict(slots))


def check(cell: spec.Cell, reference, H, proto, lift, synd: dict, held: dict, rng, dev, *,
          program_dtype=None):
    """Compare the held outputs with ``reference`` (the module
    :func:`.spec.reference` gives); returns the compared numbers and the
    reference's mean elimination operations a failing row.  ``program_dtype``
    puts the reference itself, at that precision, in the program's place
    (the control)."""
    opts = cell.config["decoder"]
    p = float(cell.traffic["p"])
    fg = reference.FloodGraph(H, dev)
    llr0 = reference.prior(p, fg.n)
    lg = reference.LiftedGraph(proto, lift, dev) if proto is not None else None

    def bp(s, dtype):
        if lg is not None:
            return reference.lifted_bp(lg, s, llr0, opts, dtype=dtype)
        return reference.flood_bp(fg, s, llr0, opts, dtype=dtype)

    if program_dtype is not None:  # the control: the reference at lower precision
        held = {}
        for j, s in synd.items():
            r = bp(s, program_dtype)
            f = ~r.converged
            o = reference.osd_cs(fg, s[f], r.llr[f], opts)
            osd0, osdw = r.hard.clone(), r.hard.clone()
            osd0[f], osdw[f] = o.osd0, o.osdw
            held[j] = (r.hard, r.converged, r.iterations, osd0, osdw)

    nums = dict(bp_rows_differ=0, osd_rows_differ=0, osdw_unsatisfied=0, rows_checked=0,
                osd_rows_checked=0)
    fail_rows = []  # (pool batch, row) of rows the reference leaves to OSD
    refs = {}
    for j in sorted(held):
        s = synd[j].to(dev)
        hard, conv, iters, osd0, osdw = (x.to(dev) for x in held[j])
        r = bp(s, torch.float32)
        refs[j] = r
        bad = ((hard != r.hard).any(1) | (conv != r.converged)
               | (iters.to(torch.int32) != r.iterations))
        nums["bp_rows_differ"] += int(bad.sum())
        nums["rows_checked"] += int(s.shape[0])
        ok = r.converged
        off = ((osd0 != r.hard).any(1) | (osdw != r.hard).any(1)) & ok
        nums["osd_rows_differ"] += int(off.sum())
        unsat = (reference.syndromes_of(fg, osdw) != s).any(1)
        nums["osdw_unsatisfied"] += int(unsat.sum())
        fail_rows += [(j, int(i)) for i in torch.nonzero(~ok).flatten().tolist()]
    take = int(cell.traffic["check_osd_rows"])
    if len(fail_rows) > take:
        pick = np.sort(rng.choice(len(fail_rows), size=take, replace=False))
        fail_rows = [fail_rows[k] for k in pick]
    elim_mean = None
    if fail_rows:
        s = torch.stack([synd[j][i] for j, i in fail_rows]).to(dev)
        llr = torch.stack([refs[j].llr[i] for j, i in fail_rows])
        o = reference.osd_cs(fg, s, llr, opts)
        got0 = torch.stack([held[j][3][i].to(dev) for j, i in fail_rows])
        gotw = torch.stack([held[j][4][i].to(dev) for j, i in fail_rows])
        nums["osd_rows_differ"] += int(((got0 != o.osd0).any(1) | (gotw != o.osdw).any(1)).sum())
        nums["osd_rows_checked"] += len(fail_rows)
        elim_mean = float(o.elim_ops.double().mean())
    return nums, elim_mean, fg.rank


LIMITS = {  # name: (comparison, limit)
    "bp_rows_differ": ("<=", 0),
    "osd_rows_differ": ("<=", 0),
    "osdw_unsatisfied": ("<=", 0),
    "rows_checked": (">=", 1),
    "osd_rows_checked": (">=", 1),
}


def judged(nums: dict) -> tuple[bool, dict]:
    out, ok = {}, True
    for k, (op, lim) in LIMITS.items():
        v = nums[k]
        good = v <= lim if op == "<=" else v >= lim
        ok &= good
        out[k] = {"value": v, "op": op, "limit": lim}
    return ok, out


def run(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device=None, cell: spec.Cell | None = None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``t_start`` is the process's start on the ``time.perf_counter`` clock;
    ``device`` and ``cell`` let tests run a small cell on the CPU."""
    cell = cell or spec.cell(name)
    ref = spec.reference(cell)
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    H, proto, lift = codes.build(cell.config["code"], cell.home)
    dec = build_program(cell, H, proto, lift, dev)
    pool = traffic.make_pool(H, cell.traffic, seed, dev)
    warm = warm_up(dec, pool, int(cell.traffic["warmup_batches"]), dev)
    rng = np.random.default_rng([int(seed), 1])
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"{name}: seed {seed}, set-up {setup_s:.3f} s ({warm} warm-up batches), "
        f"window {seconds} s, trace {int(trace)}")

    def go():
        return window(dec, pool, seconds, int(cell.traffic["check_batches"]), rng, dev,
                      marker=trace)

    if trace:
        loop, events = record(go)
    else:
        loop = go()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    B = pool.shape[1]
    done = len(loop.pool_index)
    attempted = len(loop.latency) * B
    # each pool batch decodes alike every time (the check holds the held
    # ones to the reference), so its last decode stands for its others
    runs = np.bincount(loop.pool_index, minlength=pool.shape[0])
    js = sorted(loop.conv)
    fails = torch.stack([(~loop.conv[j]).sum() for j in js]).cpu().numpy() if js else np.zeros(0)
    its = torch.stack([loop.iters[j].long().sum() for j in js]).cpu().numpy() if js else np.zeros(0)
    window_fails = int((runs[js] * fails).sum())
    window_its = int((runs[js] * its).sum())
    window_osd_batches = int((runs[js] * (fails > 0)).sum())
    held = loop.held
    synd = {j: pool[j].clone() for j in held}
    loop.conv.clear()
    loop.iters.clear()
    del dec, pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    nums, elim_mean, rank = check(cell, ref, H, proto, lift, synd, held, rng, dev)
    log(f"{name}: reference check {time.perf_counter() - t_ref:.3f} s")
    failed = loop.raised * B + nums["osdw_unsatisfied"]
    ok, checks = judged(nums)
    correct = ok and loop.raised == 0

    m, n = H.shape
    edges = int(H.sum())
    metrics = {}
    result_device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                     "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                     "count": cell.chips if dev.type == "cuda" else 0,
                     "memory_peak_bytes": int(peak)}
    if trace:
        opts = cell.config["decoder"]
        work = {"bp": bp_work(m, n, edges, done, done * B, window_its)}
        if window_fails and elim_mean is not None:
            work["osd"] = osd_cs_work(m, n, rank, int(opts["osd_order"]), window_osd_batches,
                                      window_fails, elim_mean * window_fails)
        win = Window(loop.seconds, done, events, work)
        for mtr in cell.per_layer:
            v = spec.reader(mtr["name"], cell.home)(win)
            if v is not None:
                metrics[mtr["name"]] = {"value": float(v), "unit": mtr["unit"]}
        result_device.update(busy_s=win.busy_s, window_s=loop.seconds)
        extra = {"breakdown": win.breakdown()}
    else:
        lat_ms = np.asarray(loop.latency) * 1e3
        values = {"syndromes_per_s": done * B / loop.seconds,
                  "batch_ms_p95": float(np.percentile(lat_ms, 95)),
                  "setup_s": setup_s}
        for mtr in cell.end_to_end:
            metrics[mtr["name"]] = {"value": float(values[mtr["name"]]), "unit": mtr["unit"]}
        extra = {"window": {
            "batches": len(lat_ms), "seconds": loop.seconds,
            "batch_ms_quartiles": np.percentile(lat_ms, [25, 50, 75]).tolist(),
            "batch_ms_max": float(lat_ms.max()),
            "osd_rows_per_batch": window_fails / max(done, 1),
            "osd_batch_share": window_osd_batches / max(done, 1)}}
    return {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": result_device, **extra,
            "card": card_line() if dev.type == "cuda" else "cpu",
            "checks": checks}
