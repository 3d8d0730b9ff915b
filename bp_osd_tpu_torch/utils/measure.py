"""Measurement and gates shared by ``chip_smoke.py`` and ``bench_torch.py``.

- The card: :func:`card_line` (``nvidia-smi``'s name and power limit) and
  :func:`card` (the same as a dict, with the card count).
- Timing: :func:`cuda_ms` (CUDA events), :func:`host_ms` (host clock
  between synchronisations), :func:`spread` (median, quartiles, extremes
  and count of samples) and :func:`trace_step` (one call under
  ``torch.profiler``: each kernel's device time, the device's busy time and
  its idle share of the call's wall).
- Bounds: the least time a call could take on an H100 SXM at 700 W
  (:func:`bound_ms`), for K1 and K6 from the iterations their rows ran
  (:func:`k1_bound`, :func:`k6_bound`, :func:`staged_k1_bound`, over the launches of the
  pipeline's :func:`~bp_osd_tpu_torch.decoder.pipeline.stage_caps`) and
  for the OSD kernels from the elimination work their rows need
  (:class:`ElimWork`, :func:`elim_work`, :func:`osd_cs_bound`,
  :func:`osd_e_bound`, :func:`elim_bound`).
- Gates: :func:`check` (raises :class:`GateFailed`), :func:`same`,
  :func:`satisfies`, :func:`k1_stages`/:func:`k1_equal` (K1 stage by stage
  against its plain version), :func:`corpus_check` and
  :func:`artifact_sigmas` (a harness LER against its committed artifact).

Nothing here runs when the module is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from ..decoder.pipeline import stage_caps

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_S = 3.35e12  # H100 SXM device memory
F32_OPS_S = 67e12  # float32 outside the tensor cores
INT_OPS_S = 64 * 132 * 1.98e9  # INT32 lanes x SMs x boost clock

# each hand-written kernel: its wrapper's name, its id, its source and the
# names of its CUDA functions as a profiler reports them (a substring each)
KERNELS = {
    "bp_flood": ("K1", "bp_flood.cu", ("bp_flood_team_kernel", "bp_flood_global_kernel")),
    "osd_cs": ("K2", "osd_cs.cu", ("osd_cs_warp_kernel",)),
    "osd_e": ("K3", "osd_cs.cu", ("osd_e_warp_kernel",)),
    "eliminate": ("K4", "osd_cs.cu", ("gf2_elim_warp_kernel", "gf2_elim_kernel")),
    "osd_large": ("K5", "osd_large.cu", ("osd_large_kernel",)),
    "bp_lifted": ("K6", "bp_lifted.cu", ("bp_lifted_kernel",)),
}


class GateFailed(SystemExit):
    """A gate refused a result; uncaught, it exits non-zero with its message."""


def check(ok, what: str) -> None:
    if not ok:
        raise GateFailed(f"FAILED: {what}")


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.equal(a, b))


def satisfies(err: torch.Tensor, H_f: torch.Tensor, synd: torch.Tensor) -> bool:
    """Every row of ``err`` has syndrome ``synd`` under ``H_f`` (f32 0/1)."""
    return same(torch.remainder(err.float() @ H_f.T, 2).to(torch.uint8), synd)


def artifact(name: str) -> dict:
    """A committed result file of ``examples/``."""
    with open(os.path.join(ROOT, "examples", name)) as f:
        return json.load(f)


def sigmas(ler: float, eb: float, ref_ler: float, ref_eb: float) -> float:
    """Distance of two binomial estimates in combined standard errors."""
    return abs(ler - ref_ler) / float(np.hypot(eb, ref_eb))


def artifact_sigmas(out: dict, art: dict) -> float:
    """A harness output's OSDW LER against an artifact's, in combined
    standard errors (:func:`sigmas`)."""
    return sigmas(out["osdw_logical_error_rate"], out["osdw_logical_error_rate_eb"],
                  art["osdw_logical_error_rate"], art["osdw_logical_error_rate_eb"])


# ---- the card ---------------------------------------------------------------

def card_line() -> str:
    """``nvidia-smi``'s ``name, power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def card() -> dict:
    """The first card's name and power limit (:func:`card_line`) and the
    number of cards."""
    name, limit = (s.strip() for s in card_line().rsplit(",", 1))
    return {"name": name, "power_limit": limit, "count": torch.cuda.device_count()}


# ---- timing -----------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sync() -> None:
    """Wait for every card (nothing without one)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def host_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn()`` with every card synchronised
    before and after, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def spread(samples) -> dict:
    """Median, 25th and 75th percentiles (linear interpolation), least,
    greatest and count of ``samples``."""
    x = np.asarray(samples, dtype=np.float64)
    if x.size == 0:
        raise ValueError("spread of no samples")
    p25, med, p75 = np.percentile(x, [25, 50, 75])
    return {"median": float(med), "p25": float(p25), "p75": float(p75),
            "min": float(x.min()), "max": float(x.max()), "n": int(x.size)}


def _busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def trace_step(fn):
    """Run ``fn()`` once under ``torch.profiler`` (CPU and, with a card, CUDA
    activity), every card synchronised before and after.  Returns ``fn``'s
    result and a dict: the host wall ``wall_ms``; from the trace's device
    events (kernels, copies, sets) their busy time ``device_busy_ms`` (the
    union of their intervals), ``device_idle_share`` (1 - busy / wall) and
    ``kernel_ms``, each hand-written kernel's device time by the wrapper
    names of :data:`KERNELS`.  When the trace holds no device event those
    three read ``"not measured"``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=activities) as prof:
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    device, kernel_us = [], {k: 0.0 for k in KERNELS}
    for e in events:
        if e.get("ph") != "X" or str(e.get("cat", "")).lower() not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        device.append((ts, ts + dur))
        name = str(e.get("name", ""))
        for k, (_, _, names) in KERNELS.items():
            if any(s in name for s in names):
                kernel_us[k] += dur
    result = {"wall_ms": wall_ms}
    if not device:
        result.update(device_busy_ms="not measured", device_idle_share="not measured",
                      kernel_ms="not measured")
        return out, result
    busy_ms = _busy_us(device) / 1e3
    result.update(device_busy_ms=busy_ms, device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                  kernel_ms={k: v / 1e3 for k, v in kernel_us.items()})
    return out, result


# ---- the kernels' launch counts ---------------------------------------------

def wrappers() -> dict:
    """The kernel wrappers by name (:data:`KERNELS`)."""
    from ..ops.cuda_bp import bp_flood
    from ..ops.cuda_gf2 import eliminate
    from ..ops.cuda_lifted_bp import bp_lifted
    from ..ops.cuda_osd import osd_cs, osd_e
    from ..ops.cuda_osd_large import osd_large

    return {"bp_flood": bp_flood, "osd_cs": osd_cs, "osd_e": osd_e, "eliminate": eliminate,
            "osd_large": osd_large, "bp_lifted": bp_lifted}


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0."""
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
        w.launches_on.clear()
    ws["eliminate"].warp_launches = 0


def launches() -> dict:
    """Every wrapper's launches since :func:`reset_launches`;
    ``eliminate_warp`` counts K4's warp kernel alone."""
    ws = wrappers()
    return {**{k: w.launches for k, w in ws.items()},
            "eliminate_warp": ws["eliminate"].warp_launches}


# ---- bounds -------------------------------------------------------------------

class Bound(NamedTuple):
    """The least time of a call on the H100 SXM: the larger of its bytes over
    the memory rate and its operations over their type's peak (float and
    integer work may overlap, so the larger of those two)."""

    ms: float
    by: str  # "bytes" or "operations"
    nbytes: float
    float_ops: float
    int_ops: float

    def detail(self) -> str:
        return (f"{self.ms:.4f} ms ({self.by}: {self.int_ops:.4g} integer + "
                f"{self.float_ops:.4g} float operations, {self.nbytes:.4g} bytes)")


def bound_ms(nbytes: float, float_ops: float = 0.0, int_ops: float = 0.0) -> Bound:
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(float_ops / F32_OPS_S, int_ops / INT_OPS_S)
    return Bound(1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
                 float(nbytes), float(float_ops), float(int_ops))


def bound_sum(bounds) -> Bound:
    """The bound of several calls: their bytes and operations added."""
    bounds = list(bounds)
    return bound_ms(*(sum(getattr(b, f) for b in bounds)
                      for f in ("nbytes", "float_ops", "int_ops")))


def k1_bound(graph, rows: int, sample_its: int, *, prior_rows: int, v2c_in: bool, emit: bool):
    """K1's bound for ``rows`` rows that ran ``sample_its`` iterations in
    all.  A sample-iteration is 2E + n + m float operations (v2c subtract,
    variable add, prior add, scale) and 7E + n integer ones (sign,
    magnitude, the two-minimum update, sign apply, parity; hard decision)."""
    m, n, E = graph.m, graph.n, graph.m * graph.wr
    nbytes = (rows * m + 4 * prior_rows * n + 4 * (E + n * graph.wc + m)
              + rows * (n + 4 * n + 1 + 4) + 4 * rows * E * (int(v2c_in) + int(emit)))
    return bound_ms(nbytes, sample_its * (2 * E + n + m), sample_its * (7 * E + n))


def k6_bound(graph, iterations: torch.Tensor, *, prior_rows: int, device_route: bool) -> Bound:
    """K6's min-sum bound for the rows of one launch that ran
    ``iterations [B]``, counted as :func:`k1_bound` counts a
    sample-iteration of the same arithmetic on the lifted graph (E = m * wr
    edges): 2E + n + m float and 7E + n integer operations.  Bytes:
    the syndromes, ``prior_rows`` prior rows, the tables and the outputs
    once; on the device-memory route also the row state (E + n floats)
    written and read once a sample-iteration."""
    m, n, E = graph.m, graph.n, graph.m * graph.wr
    rows = int(iterations.numel())
    sample_its = int(iterations.long().sum())
    tables = 4 * (2 * graph.mp * graph.wr + 3 * graph.np_ * graph.depth)
    nbytes = (rows * m + 4 * prior_rows * n + tables + rows * (n + 4 * n + 1 + 4)
              + (8 * (E + n) * sample_its if device_route else 0))
    return bound_ms(nbytes, sample_its * (2 * E + n + m), sample_its * (7 * E + n))


def staged_k1_bound(graph, iterations: torch.Tensor, max_iter: int,
                    stage1_iters=None) -> Bound:
    """K1's bound over the staged pipeline's launches (:func:`stage_caps` of
    ``stage1_iters``) that decoded rows whose final ``iterations`` these
    are: stage i takes the rows that ran past cap i - 1 and runs each to at
    most cap i; stage 1 reads one prior row (the pipeline's expanded prior),
    later stages one a row."""
    its = iterations.long()
    caps = stage_caps(max_iter, stage1_iters)
    parts, prev = [], 0
    for i, cap in enumerate(caps):
        live = its > prev
        rows = int(live.sum())
        if rows == 0:
            break
        sample_its = int((its[live].clamp(max=cap) - prev).sum())
        parts.append(k1_bound(graph, rows, sample_its, prior_rows=1 if i == 0 else rows,
                              v2c_in=i > 0, emit=cap < max_iter))
        prev = cap
    return bound_sum(parts) if parts else bound_ms(0.0)


class ElimWork(NamedTuple):
    """What the Gauss-Jordan elimination of the OSD kernels does on some rows
    (the column elimination of ``decoder/osd.py:_eliminate``, counted), one
    entry a row: ``steps`` columns taken while fewer than rank pivots are
    found, ``pivots`` of them with a pivot, ``pivot_tests`` the columns after
    t (syndrome included) tested at the pivot steps (the sum of n - t),
    ``hits`` the columns after t that carry the pivot row, ``xor_words`` the
    words XORed into them (hits x nonzero words of S) and ``cm_sectors`` the
    32-byte sectors those words span in the column-major layout (hits x the
    8-word groups of S that hold a nonzero word)."""

    steps: np.ndarray
    pivots: np.ndarray
    pivot_tests: np.ndarray
    hits: np.ndarray
    xor_words: np.ndarray
    cm_sectors: np.ndarray
    n1: int
    Wm: int

    def rows(self, sel) -> "ElimWork":
        return ElimWork(*(getattr(self, f)[sel] for f in self._fields[:6]), self.n1, self.Wm)

    @property
    def ops(self) -> int:
        """The integer operations the elimination needs: at every step the
        pivot search (an AND-NOT and a test of each of column t's Wm words),
        at a pivot step the hit tests (shift and test, 2 each) and the XORs
        (1 a nonzero word of S into each hit column)."""
        return int(2 * self.Wm * self.steps.sum() + 2 * self.pivot_tests.sum()
                   + self.xor_words.sum())

    @property
    def ops_all_columns(self) -> int:
        """The earlier, larger count: every step tests all n + 1 columns (2
        operations a test) and XORs Wm words into every column holding the
        pivot bit, column t included."""
        return (2 * int(self.steps.sum()) * self.n1
                + int((self.hits + self.pivots).sum()) * self.Wm)

    def traffic(self) -> tuple[float, float]:
        """Device-memory bytes of the pivot steps' hit tests and XORs in the
        column-major layout (a test reads one 32-byte sector for its 4 bytes;
        an XOR reads and writes the sectors S spans in a column) and in the
        word-major one (4 bytes a test, coalesced; each XORed word its own
        sector, read and written)."""
        tests = float(self.pivot_tests.sum())
        return (32 * tests + 64 * float(self.cm_sectors.sum()),
                4 * tests + 64 * float(self.xor_words.sum()))


def elim_work(graph, perm: torch.Tensor, synd: torch.Tensor) -> ElimWork:
    """:class:`ElimWork` of the elimination of these rows, counted on their
    device."""
    from ..decoder.osd import _pack_rows_bits, _popcount32, _wrap_i32

    cols = torch.cat([graph.H_cols[perm.long()], _pack_rows_bits(synd)[:, None, :]], 1)
    B, n1, Wm = cols.shape
    dev = cols.device
    used = torch.zeros(B, Wm, dtype=torch.int32, device=dev)
    rr = torch.zeros(B, dtype=torch.int64, device=dev)
    ar = torch.arange(B, device=dev)
    word_ids = torch.arange(Wm, device=dev)
    col_ids = torch.arange(n1, device=dev)
    groups = -(-Wm // 8)
    acc = torch.zeros(6, B, dtype=torch.int64, device=dev)
    for t in range(n1 - 1):
        live = rr < graph.rank
        if not bool(live.any()):
            break
        ct = cols[:, t, :]
        elig = ct & ~used
        nz = elig != 0
        has = nz.any(1) & live
        w = nz.to(torch.int32).argmax(1)
        word = elig[ar, w]
        bit = _popcount32((word & -word) - 1)
        bit = torch.where(has, bit, 0)
        pmask = torch.where(word_ids[None, :] == w[:, None],
                            _wrap_i32(torch.ones_like(bit) << bit)[:, None], 0)
        pmask = torch.where(has[:, None], pmask, 0)
        S = ct & ~pmask & -has.to(torch.int32)[:, None]
        sel = (cols.gather(2, w[:, None, None].expand(B, n1, 1)).squeeze(2)
               >> bit[:, None].to(torch.int32)) & 1
        sel = sel * has[:, None]
        hits_after = (sel * (col_ids > t)).sum(1)
        s_nz = S != 0
        s_groups = torch.nn.functional.pad(s_nz, (0, 8 * groups - Wm)).view(B, groups, 8).any(2)
        acc += torch.stack([live.long(), has.long(), has.long() * (n1 - 1 - t), hits_after,
                            hits_after * s_nz.sum(1), hits_after * s_groups.sum(1)])
        cols ^= (-sel)[:, :, None] & S[:, None, :]
        used |= pmask
        rr += has.to(torch.int64)
    return ElimWork(*acc.cpu().numpy(), n1, Wm)


def osd_bound(graph, perm: torch.Tensor, synd: torch.Tensor, *, search_ops_per_row: float,
              in_bytes: float, out_bytes: float,
              work: ElimWork | None = None) -> tuple[Bound, Bound]:
    """An OSD kernel's bound on these rows: the operations the elimination
    needs (:attr:`ElimWork.ops`), the search's ``search_ops_per_row``
    integer operations, and its bytes; then the same with the earlier count
    :attr:`ElimWork.ops_all_columns`.  ``work`` is these rows'
    :func:`elim_work` where it is already counted."""
    work = elim_work(graph, perm, synd) if work is None else work
    search = perm.shape[0] * search_ops_per_row
    return tuple(bound_ms(in_bytes + out_bytes, 0.0, ops + search)
                 for ops in (work.ops, work.ops_all_columns))


def osd_cs_bound(graph, perm, synd, pairs, work: ElimWork | None = None):
    """:func:`osd_bound` of osd_cs (K2, K5) on these rows: the weight-1
    sweep over the n - rank T columns and the weight-2 sweep over
    ``pairs``; perm, syndromes, packed H and pairs in, osd0 and osdw out."""
    rows, n, m, Wm = perm.shape[0], graph.n, graph.m, -(-graph.m // 32)
    n_pairs = len(pairs) if pairs is not None else 0
    return osd_bound(graph, perm, synd,
                     search_ops_per_row=(n - graph.rank) * (2 * Wm + 1) + n_pairs * (3 * Wm + 1),
                     in_bytes=rows * (4 * n + m) + 4 * n * Wm + 8 * n_pairs,
                     out_bytes=2 * rows * n, work=work)


def osd_e_bound(graph, perm, synd, order: int, work: ElimWork | None = None):
    """:func:`osd_bound` of osd_e (K3) at ``order`` on these rows: 2^order
    patterns a row."""
    rows, n, m, Wm = perm.shape[0], graph.n, graph.m, -(-graph.m // 32)
    return osd_bound(graph, perm, synd, search_ops_per_row=(1 << order) * (2 * Wm + 1),
                     in_bytes=rows * (4 * n + m) + 4 * m * graph.num_words,
                     out_bytes=2 * rows * n, work=work)


def elim_bound(graph, perm, synd, work: ElimWork | None = None):
    """:func:`osd_bound` of the elimination alone (K4) on these rows, with
    its five outputs written (reduced H, syndrome, pivot lists, mask)."""
    rows, n, m, Wm = perm.shape[0], graph.n, graph.m, -(-graph.m // 32)
    return osd_bound(graph, perm, synd, search_ops_per_row=0,
                     in_bytes=rows * (4 * n + m) + 4 * n * Wm,
                     out_bytes=rows * (4 * m * graph.num_words + 4 * m + 8 * graph.rank + n),
                     work=work)


def bound_text(b: tuple[Bound, Bound], ms: float) -> str:
    """A kernel's two bounds (:func:`osd_bound`) beside its time."""
    return (f"bound {b[0].detail()}, {100 * b[0].ms / ms:.2f}% of it (every column counted: "
            f"{b[1].ms:.4f} ms, {100 * b[1].ms / ms:.2f}%)")


# ---- gates --------------------------------------------------------------------

class Stage(NamedTuple):
    """One K1 launch of the staged pipeline: its positional and keyword
    arguments, its outputs, the iterations its rows ran in all, and the
    rows of the batch it decoded."""

    args: tuple
    kw: dict
    out: tuple
    sample_its: int
    rows: torch.Tensor


def k1_stages(graph, synd: torch.Tensor, llr0: torch.Tensor, max_iter: int,
              stage1_iters=None, **bp_kw) -> list[Stage]:
    """K1 (``ops/cuda_bp.py:bp_flood``) at each launch the staged pipeline
    makes on these rows (:func:`stage_caps` of ``stage1_iters``): stage 1 on
    every row with the prior ``llr0 [B, n]`` as given, each later stage on
    the rows the one before left unconverged, resumed from its message
    state.  ``bp_kw`` are ``bp_flood``'s ``method`` and
    ``ms_scaling_factor``.  Rows off the card run K1's plain version,
    ``bp_decode_plain``, stage by stage the same way."""
    if synd.device.type == "cuda":
        from ..ops.cuda_bp import bp_flood as run
    else:
        from ..decoder.bp import bp_decode_plain as run

    caps = stage_caps(max_iter, stage1_iters)
    stages = []
    rows = torch.arange(synd.shape[0], device=synd.device)
    v2c = None
    for i, cap in enumerate(caps):
        it0 = caps[i - 1] if i else 0
        emit = cap < max_iter
        kw = dict(max_iter=cap, it0=it0, emit_state=emit, v2c_init=v2c, **bp_kw)
        args = (graph, synd[rows], llr0 if i == 0 else llr0[rows])
        out = run(*args, **kw)
        stages.append(Stage(args, kw, out, int((out[3] - it0).sum()), rows))
        going = ~out[2]
        if not bool(going.any()):
            break
        rows, v2c = rows[going], (out[4][going] if emit else None)
    return stages


def k1_merged(stages: list[Stage]) -> tuple:
    """The staged launches' ``(hard, llr, converged, iterations)`` merged
    into the batch's row order, as the pipeline merges them."""
    hard, llr, conv, iters = (x.clone() for x in stages[0].out[:4])
    for st in stages[1:]:
        hard[st.rows], llr[st.rows], conv[st.rows], iters[st.rows] = st.out[:4]
    return hard, llr, conv, iters


def k1_equal(got, want, what: str) -> None:
    """Each output of a K1 launch equal to its plain version's, bit for bit
    (``v2c`` only where both emitted it)."""
    for name, a, b in zip(("hard", "llr", "converged", "iterations", "v2c"), got, want):
        check(same(a, b) if a is not None and b is not None else a is b,
              f"K1 {what}: {name} differs from the plain version")


def k1_stages_equal_plain(stages: list[Stage], what: str) -> None:
    """Each staged K1 launch against ``bp_decode_plain`` on its own inputs."""
    from ..decoder.bp import bp_decode_plain

    for i, st in enumerate(stages):
        k1_equal(st.out, bp_decode_plain(*st.args, **st.kw),
                 f"{what} stage {i + 1} ({st.args[1].shape[0]} rows)")


def corpus_check(osdw: torch.Tensor, converged: torch.Tensor, iterations: torch.Tensor,
                 data, what: str) -> None:
    """``tests/data/flagship_corpus.npz`` (``data``) reproduced: osdw bit
    for bit, its weights, BP's converged flags and iterations."""
    n = int(data["meta"][2])
    check(np.array_equal(osdw.cpu().numpy(), np.unpackbits(data["osdw_packed"], axis=1)[:, :n]),
          f"{what}: osdw != corpus")
    check(np.array_equal(osdw.sum(1).cpu().numpy(), data["weights"])
          and np.array_equal(converged.cpu().numpy(), data["converged"])
          and np.array_equal(iterations.cpu().numpy(), data["iterations"]),
          f"{what}: weights/converged/iterations != corpus")
