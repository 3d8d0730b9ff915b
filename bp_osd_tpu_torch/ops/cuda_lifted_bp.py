"""Wrapper of kernel K6, ``csrc/bp_lifted.cu``: the whole shift-routed BP
decode of a lifted-product batch in one launch.

K6 replaces no Pallas kernel: the JAX package runs this decode as the XLA
``jax.lax.while_loop`` of ``bp_osd_tpu/decoder/lifted_bp.py:173-212``.  It
takes CUDA tensors only; its plain torch version is in
:mod:`bp_osd_tpu_torch.decoder.lifted_bp`.  A graph whose row state
(min-sum: three words a check and the totals; product-sum: the messages and
the totals) fits a block's shared memory beside K6's tables (:func:`k6_route`
``"shared"``, min-sum up to lift 942 of the [[10000,420]] code's protograph)
keeps it there; a larger one keeps it in a device-memory slice of each
persistent block.  Either way a call is one launch, whatever the batch.  The threads a row come from the
graph alone (:func:`k6_threads`, once a card and graph), and the plan and
the launch run with the tensors' card current.  ``bp_lifted.launches``
counts kernel launches (``bp_lifted.launches_on`` by card).
"""

from __future__ import annotations

import ctypes
import functools
from fractions import Fraction

import numpy as np
import torch

from ..decoder.lifted_bp import LiftedGraph
from . import _build, count_launch, launch_counter, require_cuda
from .cuda_bp import _MAX_ROW_WEIGHT, _SMEM_LIMIT

__all__ = ["TEAM_SIZES", "bp_lifted", "bp_lifted_plan", "bp_lifted_smem_bytes",
           "bp_lifted_state_words", "bp_lifted_table_words", "full_rows", "k6_route",
           "k6_threads"]

# Tests and measurements set these to run every graph on the device-memory
# route, or every row with _THREADS threads (0: k6_threads' choice); the
# result depends on neither.
_FORCE_DEVICE_ROUTE = False
_THREADS = 0

TEAM_SIZES = (128, 256, 512, 1024)  # the threads a row k6_threads chooses from
_MAX_CHECKS_PER_THREAD = 64  # a thread's syndrome bits sit in one 64-bit register


def bp_lifted_table_words(mp: int, np_: int, wr: int, depth: int) -> int:
    """Words of K6's tables in shared memory: the edges ``[np][depth]`` as
    four words each, the slots ``[mp][wr]`` as two, the degree of each block
    row and variable block, and the row slot."""
    return 4 * np_ * depth + 2 * mp * wr + mp + np_ + 1


def bp_lifted_state_words(mp: int, np_: int, L: int, wr: int, product_sum: bool = False) -> int:
    """One row's state in K6 (in shared memory, or a block's device-memory
    scratch): min-sum keeps each check's compressed message, three words,
    and the ``np L`` totals; product-sum the ``mp L wr`` messages and the
    totals."""
    m = mp * L
    return (m * wr if product_sum else 3 * m) + np_ * L


def bp_lifted_smem_bytes(mp: int, np_: int, L: int, wr: int, depth: int, product_sum: bool,
                         device_route: bool) -> int:
    """Dynamic shared memory of one K6 block, as
    ``csrc/bp_lifted.cu:bp_lifted_smem_bytes`` computes it (``chip_smoke.py``
    holds the two equal on the card): the tables
    (:func:`bp_lifted_table_words`) and, on the shared route, the row's
    state (:func:`bp_lifted_state_words`)."""
    state = 0 if device_route else bp_lifted_state_words(mp, np_, L, wr, product_sum)
    return 4 * (bp_lifted_table_words(mp, np_, wr, depth) + state)


def k6_route(graph: LiftedGraph, product_sum: bool = False) -> str:
    """``"shared"`` when K6's tables and one row's state fit a block's
    232,448 bytes of shared memory, else ``"device"`` (the state in device
    memory); ``_FORCE_DEVICE_ROUTE`` forces ``"device"``."""
    shared = bp_lifted_smem_bytes(graph.mp, graph.np_, graph.L, graph.wr, graph.depth,
                                  product_sum, False)
    return "device" if _FORCE_DEVICE_ROUTE or shared > _SMEM_LIMIT else "shared"


def k6_threads(m: int, n: int, wr: int, depth: int, rows_per_sm: dict) -> int:
    """The threads a row K6 runs a graph with, from :data:`TEAM_SIZES`:
    ``rows_per_sm[T]`` is how many rows of ``T`` threads an SM holds (the
    occupancy query; 0 or absent where none fits).  A row-iteration costs
    about the work of its busiest thread between the two barriers, ``path =
    ceil(m / T) wr + ceil(n / T) depth`` slot and edge updates; the choice is
    the most rows an SM per path, and of equal rates the larger team (its
    row finishes sooner, and a batch waits for its slowest rows: at the
    [[10000,420]] code one 1024-thread row an SM beat two 512-thread rows on
    every batch timed).  A thread owns at most 64 checks.  Depends on the
    graph alone, so every batch size runs the same kernel build."""
    best = None
    for T in TEAM_SIZES:
        rows, cpt = rows_per_sm.get(T, 0), -(-m // T)
        if rows < 1 or cpt > _MAX_CHECKS_PER_THREAD:
            continue
        key = (Fraction(rows, cpt * wr + -(-n // T) * depth), T)
        if best is None or key > best[0]:
            best = (key, T)
    if best is None:
        raise ValueError(f"K6 fits no team of {TEAM_SIZES} threads on this graph "
                         f"(m={m}, n={n})")
    return best[1]


def bp_lifted_plan(graph: LiftedGraph, *, product_sum: bool = False) -> dict:
    """K6's launch at this graph on the current card: its route, threads a
    row (``_THREADS``, else :func:`k6_threads`'s choice), rows an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the card's SMs,
    registers and local memory bytes a thread and dynamic shared memory.
    Queried once a card, shape and team size; the query also raises the
    kernel's shared-memory limit on the card, which the launch needs."""
    route = k6_route(graph, product_sum)
    key = (torch.cuda.current_device(), graph.mp, graph.np_, graph.L, graph.wr, graph.depth,
           bool(product_sum), route == "device", full_rows(graph))
    threads = int(_THREADS) or _choice(*key)
    plan = _plan(*key, threads)
    if plan["rows_per_sm"] < 1:
        raise RuntimeError(f"K6 with {threads} threads a row fits no SM at {graph}")
    return {"route": route, "threads": threads, **plan}


def full_rows(graph: LiftedGraph) -> bool:
    """Whether every block row has ``wr`` slots: K6 then unrolls its slot
    loop without guards (row weights 4 to 8)."""
    return all(len(row) == graph.wr for row in graph.edges)


@functools.lru_cache(maxsize=None)
def _plan(card: int, mp: int, np_: int, L: int, wr: int, depth: int, product_sum: bool,
          device_route: bool, full: bool, threads: int) -> dict:
    out = (ctypes.c_int * 5)()
    err = _build.load().bp_lifted_plan(mp, np_, L, wr, depth, int(product_sum),
                                       int(device_route), int(full), threads, out)
    if err != 0:
        raise RuntimeError(f"bp_lifted_plan failed at {threads} threads a row: CUDA error {err}")
    return dict(zip(("rows_per_sm", "sms", "registers", "smem_bytes", "local_bytes"), out))


@functools.lru_cache(maxsize=None)
def _choice(card: int, mp: int, np_: int, L: int, wr: int, depth: int, product_sum: bool,
            device_route: bool, full: bool) -> int:
    m, n = mp * L, np_ * L
    rows = {T: _plan(card, mp, np_, L, wr, depth, product_sum, device_route, full,
                     T)["rows_per_sm"]
            for T in TEAM_SIZES if -(-m // T) <= _MAX_CHECKS_PER_THREAD}
    return k6_threads(m, n, wr, depth, rows)


def _check_args(graph: LiftedGraph, synd: torch.Tensor, llr0: torch.Tensor) -> None:
    """Dtype, shape and contiguity of both inputs (``llr0`` may be one prior
    row broadcast with stride 0), and one device for both."""
    if llr0.device != synd.device:
        raise ValueError(f"llr0 is on {llr0.device}, synd on {synd.device}")
    B = synd.shape[0] if synd.dim() == 2 else -1
    for name, t, dtype, shape in (("synd", synd, torch.uint8, (B, graph.m)),
                                  ("llr0", llr0, torch.float32, (B, graph.n))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        broadcast = name == "llr0" and t.stride() == (0, 1)
        if not (t.is_contiguous() or broadcast):
            raise ValueError(f"{name} must be contiguous")


def bp_lifted(graph: LiftedGraph, synd: torch.Tensor, llr0: torch.Tensor, method: str,
              max_iter: int, ms_scaling_factor: float):
    """Lifted BP of ``synd [B, m]`` uint8 (checked 0/1, checks ordered
    ``(I, l)``) from ``llr0 [B, n]`` f32 (a broadcast ``[n]`` row is read
    with stride 0), CUDA tensors, as
    :func:`~bp_osd_tpu_torch.decoder.lifted_bp._bp_decode_lifted` passes
    them: ``method`` normalised (``"minimum_sum"`` or ``"product_sum"``) and
    ``max_iter >= 1``.  Returns ``(hard [B, n] uint8, llr [B, n] f32,
    converged [B] bool, iterations [B] int32)``, as the plain version
    does."""
    _check_args(graph, synd, llr0)
    if method not in ("minimum_sum", "product_sum"):
        raise ValueError(f"bp_method must be 'minimum_sum' or 'product_sum', got {method!r}")
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    dev = synd.device
    require_cuda("bp_lifted", dev)
    graph = graph.to(dev)
    B, n = synd.shape[0], graph.n
    if llr0.stride() == (0, 1):
        llr0, stride = llr0[0], 0  # one prior row broadcast over the batch
    else:
        stride = n
    if graph.wr > _MAX_ROW_WEIGHT:
        raise ValueError(f"K6 takes row weights up to {_MAX_ROW_WEIGHT}, got {graph.wr}")

    hard = torch.empty(B, n, dtype=torch.uint8, device=dev)
    llr = torch.empty(B, n, dtype=torch.float32, device=dev)
    conv = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        product_sum = method == "product_sum"
        # the plan reads the current card, and the launch runs in its context
        with torch.cuda.device(dev):
            plan = bp_lifted_plan(graph, product_sum=product_sum)
            grid = min(B, plan["sms"] * plan["rows_per_sm"])
            scratch = None
            if plan["route"] == "device":
                words = bp_lifted_state_words(graph.mp, graph.np_, graph.L, graph.wr,
                                              product_sum)
                scratch = torch.empty(grid * words, dtype=torch.float32, device=dev)
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            alpha = 1.0 if product_sum else float(np.float32(ms_scaling_factor))
            slots = graph.slot_table.contiguous()
            blocks = graph.block_edges.contiguous()
            err = _build.load().bp_lifted_launch(
                synd.data_ptr(), llr0.data_ptr(), stride, slots.data_ptr(), blocks.data_ptr(),
                hard.data_ptr(), llr.data_ptr(), conv.data_ptr(), iters.data_ptr(),
                scratch.data_ptr() if scratch is not None else None, counter.data_ptr(),
                B, grid, plan["threads"], graph.mp, graph.np_, graph.L, graph.wr, graph.depth,
                int(full_rows(graph)), int(max_iter), int(product_sum), alpha,
                torch.cuda.current_stream(dev).cuda_stream,
            )
            if err != 0:
                raise RuntimeError(f"bp_lifted launch failed: CUDA error {err}")
            count_launch(bp_lifted, dev)
    return hard, llr, conv.to(torch.bool), iters


launch_counter(bp_lifted)
