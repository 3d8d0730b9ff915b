"""Wrapper of kernel K1, ``csrc/bp_flood.cu``: flooding BP.

Replaces ``bp_osd_tpu/ops/pallas_bp.py:bp_decode_pallas``.  It takes CUDA
tensors only; its plain torch version is in
:mod:`bp_osd_tpu_torch.decoder.bp`.  A graph whose
per-sample state fits a block's shared memory (:func:`k1_fits`) runs in one
of two plans, chosen by ``csrc/bp_flood.cu:bp_flood_plan`` from the batch,
the card's SM count and the graph alone (:func:`bp_flood_plan`):

- throughput, wherever the launch fills the card (``B`` at or above the
  SMs times the resident teams an SM of the graph's team): persistent
  blocks that hold the tables once and decode one sample per team of
  warps, rows handed out by a counter;
- latency, below that for min-sum graphs the latency kernel takes
  (:func:`latency_team`) at ``ceil(B / SMs)`` <= 2: a block an SM of
  ``32 * ceil(m / 32)`` threads, a check and three variables a thread
  with the check's row in registers, holding one row, or two in the
  ``B - SMs`` blocks of a launch of more rows than SMs, the same threads
  serving both.  Each launch in it adds its rows to the recorder's counter
  ``bp_flood.latency_rows``.

A larger graph keeps each sample's state in a device-memory scratch slice,
one block per sample, launched in row chunks of at most ``_SCRATCH_BYTES``,
but for the min-sum graphs the wide plan takes (:func:`wide_plan`), at any
batch: :func:`wide_grid` persistent blocks of 1024 threads, one an SM, each
decoding a row at a time (the next from a counter), its tables with 16-bit
entries loaded once and the row's totals, priors and compressed check
messages in shared memory, a few checks and up to 8 variables a thread.
Each launch in it adds its rows to the recorder's counter
``bp_flood.wide_rows`` and its rows' iterations to the device counter
``bp_flood.wide_row_iters``.
The plan queries and launches run with the tensors' card current.
``bp_flood.launches`` counts kernel launches (``bp_flood.launches_on`` by
card).  Given ``row_iters``, a one-slot int64 counter on the card (a slot of
a :func:`~bp_osd_tpu_torch.utils.profiling.device_counter`), the kernel
adds each row's iterations past ``it0`` to it as the row finishes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..decoder.tanner import TannerGraph
from ..utils import profiling
from . import _build, count_launch, launch_counter, require_cuda

__all__ = ["bp_flood", "bp_flood_plan", "bp_flood_smem_bytes", "bp_flood_table_bytes",
           "bp_flood_team_bytes", "k1_fits", "latency_smem_bytes", "latency_team", "team_shape",
           "wide_grid", "wide_plan", "wide_smem_bytes"]

_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_SCRATCH_BYTES = 1 << 30  # device-memory placement: scratch per launch
_MAX_ROW_WEIGHT = 27  # the team kernel keeps a check's sign bits in one word
_MAX_CHECKS_PER_THREAD = 8
_WIDE_THREADS = 1024  # the wide kernel's block
# Warps of a sample team in the team kernel; 0 takes the choice of
# ``csrc/bp_flood.cu:bp_flood_plan`` for the graph and batch (either plan),
# another count forces the throughput plan with teams of that size (for a
# graph the team kernel does not take, the device-memory placement).  Tests
# and measurements set it to run other team sizes; the result does not
# depend on it.
_TEAM_WARPS = 0


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bp_flood_smem_bytes(m: int, n: int, wr: int, wc: int) -> int:
    """One sample's whole state in K1's first design (tables, syndrome, v2c,
    c2v, totals, prior), the boundary of the shared-memory placement, as
    ``csrc/bp_flood.cu:bp_flood_smem_bytes`` computes it (``chip_smoke.py``
    holds the two equal on the card)."""
    E = m * wr
    return 4 * (E + n * wc + m + 2 * E + 2 * n)


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def bp_flood_table_bytes(m: int, n: int, wr: int, wc: int) -> int:
    """Shared memory of the tables a team-kernel block loads once (chk_var
    ``[m][wr]`` and var_edge ``[n][wc]`` with rows padded to a multiple of 4
    words, check degrees), as ``csrc/bp_flood.cu`` computes it."""
    return 4 * _round4(m * _round4(wr) + n * _round4(wc) + m)


def bp_flood_team_bytes(m: int, n: int, wr: int, product_sum: bool) -> int:
    """Shared memory of one sample team in the team kernel: c2v ``[m][wr]``
    with rows padded to a multiple of 4 (twice for product-sum), the totals
    with a pad slot, and two row slots."""
    return 4 * ((2 if product_sum else 1) * m * _round4(wr) + _round4(n + 3))


def team_shape(m: int) -> tuple[int, int]:
    """``(threads, checks a thread)`` of the smallest team
    ``csrc/bp_flood.cu:bp_flood_plan`` considers: the fewest warps that keep
    a thread at <= 8 checks."""
    warps = -(-m // (32 * _MAX_CHECKS_PER_THREAD))
    return 32 * warps, -(-m // (32 * warps))


def latency_team(m: int, n: int, wr: int, wc: int, k: int) -> int | None:
    """Threads of the latency kernel's block, ``32 * ceil(m / 32)``: a check
    and three variables a thread, ``k`` rows a block (the rows of the
    busiest SM), as ``csrc/bp_flood.cu:latency_shape`` sizes it before its
    occupancy query; None where the kernel does not take it
    (more than 1024 checks, more than three variables a thread, rows of
    more than 8 slots, columns of more than 4, more than 2 rows a block)."""
    T = 32 * -(-m // 32)
    if wr > 8 or wc > 4 or T > 1024 or n > 3 * T or k > 2:
        return None
    return T


def latency_smem_bytes(threads: int, rows: int, wr: int) -> int:
    """Shared memory of a latency-kernel block of ``threads`` and ``rows``
    rows, with ``kS`` = ``wr`` rounded up to 4 or 8 slots: the variable
    rows ``[threads * 3]`` (an int4 each), then a region a row: the totals
    ``[threads * 3 + 2]`` (two pad targets), c2v warp-tiled ``[threads /
    32][kS][32]`` and, with two rows, the row's priors ``[threads * 3]``;
    every part a multiple of 16 bytes, as ``csrc/bp_flood.cu:latency_smem``
    computes it."""
    kS = 8 if wr > 4 else 4
    region = 4 * _round4(threads * 3 + 2) + 4 * kS * threads + (4 * threads * 3 if rows > 1 else 0)
    return 16 * threads * 3 + rows * region


def wide_smem_bytes(m: int, n: int, wc: int) -> int:
    """Shared memory of a wide-kernel block: the check rows ``[m][8]`` and
    the variable columns ``[wc][n]`` of 16-bit entries, the totals ``[n +
    1]``, the priors ``[n]`` and an int4 message a check ``[m + 1]``, every
    part a multiple of 16 bytes, as ``csrc/bp_flood.cu:wide_smem`` computes
    it."""
    def r16(x):
        return -(-x // 16) * 16

    return 16 * m + r16(2 * wc * n) + r16(4 * (n + 1)) + r16(4 * n) + 16 * (m + 1)


def wide_plan(graph, B: int, product_sum: bool = False) -> bool:
    """Whether K1's wide plan takes a launch of ``B`` rows, as
    ``csrc/bp_flood.cu:bp_flood_plan`` decides it before its occupancy
    query: a min-sum graph that the team kernel does not take
    (:func:`k1_fits`, so neither the throughput nor the latency plan), rows
    of <= 8 slots, columns of <= 4, at most 4 checks and 8 variables a
    thread of 1024, 16-bit table entries, :func:`wide_smem_bytes` within a
    block, and at least one row: its blocks are persistent, so any batch."""
    m, n, wr, wc = graph.m, graph.n, graph.wr, graph.wc
    return (not product_sum and not k1_fits(graph) and wr <= 8 and wc <= 4
            and m <= 4 * _WIDE_THREADS and n <= 8 * _WIDE_THREADS
            and n + 1 <= 65536 and 8 * (m + 1) <= 65536
            and wide_smem_bytes(m, n, wc) <= _SMEM_LIMIT and B > 0)


def wide_grid(B: int, sms: int) -> int:
    """Blocks of a wide-plan launch of ``B`` rows on a card of ``sms`` SMs,
    as ``bp_flood_plan`` sizes it: one an SM (its shared memory and 1024
    threads allow no second), and no more than the rows.  Rows past the grid
    are handed out by a counter."""
    return min(B, sms)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k1_fits(graph, product_sum: bool = False) -> bool:
    """Whether K1 decodes ``graph`` in shared memory (the team kernel): one
    sample's whole state in the first design's layout fits a block, the row
    weight is at most 27, a team of at most 1024 threads owns the checks,
    and the tables and one team fit a block.  Otherwise the state goes to
    device memory."""
    m, n, wr, wc = graph.m, graph.n, graph.wr, graph.wc
    threads, cpt = team_shape(m)
    return (bp_flood_smem_bytes(m, n, wr, wc) <= _SMEM_LIMIT
            and wr <= _MAX_ROW_WEIGHT and threads <= 1024 and cpt <= _MAX_CHECKS_PER_THREAD
            and bp_flood_table_bytes(m, n, wr, wc) + bp_flood_team_bytes(m, n, wr, product_sum)
            <= _SMEM_LIMIT)


def bp_flood_plan(graph, B: int, *, product_sum: bool = False) -> dict:
    """K1's launch for ``B`` rows on the current card, from
    ``csrc/bp_flood.cu:bp_flood_plan``: team threads, teams a block, blocks
    an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), grid, dynamic
    shared memory, registers a thread, whether it is the latency plan or
    the wide plan (both a block of rows), and the samples resident on an
    SM."""
    plan = (ctypes.c_int * 7)()
    err = _build.load().bp_flood_plan(int(B), graph.m, graph.n, graph.wr, graph.wc,
                                      int(product_sum), int(_TEAM_WARPS), plan)
    if err != 0:
        raise RuntimeError(f"bp_flood_plan failed: CUDA error {err}")
    keys = ("team_threads", "teams_per_block", "blocks_per_sm", "grid", "smem_bytes",
            "registers")
    out = dict(zip(keys, plan))
    out["latency"], out["wide"] = plan[6] == 1, plan[6] == 2
    out["resident_per_sm"] = out["teams_per_block"] * out["blocks_per_sm"]
    return out


def bp_flood(
    graph: TannerGraph,
    synd: torch.Tensor,
    llr0: torch.Tensor,
    *,
    method: str,
    max_iter: int,
    ms_scaling_factor: float,
    skip: torch.Tensor | None = None,
    v2c_init: torch.Tensor | None = None,
    it0: int = 0,
    emit_state: bool = False,
    row_iters: torch.Tensor | None = None,
):
    """Flooding BP on CUDA tensors; same arguments and results as its plain
    version in :mod:`bp_osd_tpu_torch.decoder.bp`.

    ``synd [B, m]`` uint8, ``llr0 [B, n]`` f32 (a broadcast ``[n]`` row is
    read with stride 0), ``skip [B]`` bool, ``v2c_init [B, m * wr]`` f32,
    ``row_iters [1]`` int64.
    """
    if max_iter <= it0:
        raise ValueError(f"max_iter={max_iter} must exceed it0={it0}")
    dev = synd.device
    B, m, n, wr, wc = synd.shape[0], graph.m, graph.n, graph.wr, graph.wc
    E = m * wr
    _check(synd, "synd", torch.uint8, (B, m), dev)
    if llr0.dim() == 2 and llr0.stride() == (0, 1):
        llr0, stride = llr0[0], 0  # one prior row broadcast over the batch
    else:
        stride = n
    _check(llr0, "llr0", torch.float32, (B, n) if stride else (n,), dev)
    if skip is not None:
        skip = skip.to(torch.uint8)
        _check(skip, "skip", torch.uint8, (B,), dev)
    if v2c_init is not None:
        _check(v2c_init, "v2c_init", torch.float32, (B, E), dev)
    if row_iters is not None:
        _check(row_iters, "row_iters", torch.int64, (1,), dev)
    require_cuda("bp_flood", dev)
    graph = graph.to(dev)

    lib = _build.load()
    hard = torch.empty(B, n, dtype=torch.uint8, device=dev)
    llr = torch.empty(B, n, dtype=torch.float32, device=dev)
    conv = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    v2c = torch.empty(B, E, dtype=torch.float32, device=dev) if emit_state else None
    if B:
        # the plan reads the current card, and the launch runs in its context
        with torch.cuda.device(dev):
            ps = method == "product_sum"
            fits = k1_fits(graph, ps)
            # the wide plan where the rule takes the launch and the library's
            # plan agrees (it plans the team kernel for any graph that fits)
            wide = (not fits and not _TEAM_WARPS and wide_plan(graph, B, ps)
                    and bp_flood_plan(graph, B)["wide"])
            wide_iters = (profiling.device_counter(("bp_flood.wide_row_iters",), dev)
                          if wide else None)
            if fits or wide:
                rows, scratch = B, None
                # the team kernel's rows, and the wide kernel's past its grid
                counter = (None if wide and wide_grid(B, _sms(dev.index)) == B
                           else torch.zeros(1, dtype=torch.int32, device=dev))
            else:
                per_row = lib.bp_flood_scratch_words(m, n, wr)
                rows = max(1, min(B, _SCRATCH_BYTES // (4 * per_row)))
                scratch = torch.empty(rows * per_row, dtype=torch.int32, device=dev)
                counter = None
            chk_var = graph.chk_var.contiguous()
            var_edge = graph.var_edge.contiguous()
            alpha = float(ms_scaling_factor) if method == "minimum_sum" else 1.0
            stream = torch.cuda.current_stream(dev).cuda_stream

            def ptr(t, row0):  # the chunk's rows of a [B, ...] tensor, or None
                return None if t is None else t[row0:].data_ptr()

            plan = (ctypes.c_int * 7)()
            for row0 in range(0, B, rows):
                err = lib.bp_flood_launch(
                    ptr(synd, row0), llr0[row0:].data_ptr() if stride else llr0.data_ptr(),
                    stride, ptr(skip, row0), ptr(v2c_init, row0),
                    chk_var.data_ptr(), var_edge.data_ptr(), graph.chk_deg.data_ptr(),
                    ptr(hard, row0), ptr(llr, row0), ptr(conv, row0), ptr(iters, row0),
                    ptr(v2c, row0), ptr(scratch, 0), ptr(counter, 0), ptr(row_iters, 0),
                    ptr(wide_iters, 0), min(rows, B - row0), m, n, wr, wc, int(max_iter),
                    int(it0), int(ps), alpha, int(_TEAM_WARPS), stream, plan,
                )
                if err != 0:
                    raise RuntimeError(f"bp_flood launch failed: CUDA error {err}")
                count_launch(bp_flood, dev)
                if plan[6] == 1:  # the latency plan took the launch's rows
                    profiling.count("bp_flood.latency_rows", min(rows, B - row0))
                elif plan[6] == 2:
                    profiling.count("bp_flood.wide_rows", B)
    return hard, llr, conv.to(torch.bool), iters, v2c


launch_counter(bp_flood)
