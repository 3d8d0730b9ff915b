"""Wrapper of kernel K5, ``csrc/osd_large.cu``: osd0 / osd_cs for codes whose
matrix does not fit in a block's shared memory, one block per sample.

Replaces ``bp_osd_tpu/ops/pallas_osd_large.py:osd_cs_large_pallas``.  It
takes CUDA tensors only; its plain torch version is in
:mod:`bp_osd_tpu_torch.decoder.osd` (the same as K2's).
Each sample's ``(n + 1) x ceil(m/32)`` matrix lives in a scratch buffer that
this wrapper allocates, word-major (word ``w`` of every column contiguous);
the kernel eliminates it a panel of :func:`osd_large_panel` columns at a
time in shared memory and takes each panel's pivots to the later columns
in one trailing pass.  Rows are launched in
chunks so the scratch stays within ``_SCRATCH_BYTES``, with the tensors'
card current.  ``osd_large.launches`` counts kernel launches
(``osd_large.launches_on`` by card); while the recorder of
:mod:`bp_osd_tpu_torch.utils.profiling` is on, the kernel adds its pivots
and its trailing passes to the counters ``osd_large.pivots`` and
``osd_large.panel_passes``.
"""

from __future__ import annotations

import ctypes

import torch

from ..decoder.tanner import TannerGraph
from ..utils import profiling
from . import _build, count_launch, launch_counter, require_cuda
from .cuda_bp import _SMEM_LIMIT
from .cuda_osd import _check_inputs, pairs_on

__all__ = ["osd_large", "osd_large_panel", "osd_large_plan", "osd_large_smem_bytes"]

_SCRATCH_BYTES = 3 << 30  # 3 GiB: 512 samples of the [[10000,420]] code
# columns a panel, at most: the kernel takes up to 32 (a panel's pivots are
# the bits of a word).  A wider panel means fewer trailing passes and block
# barriers for the same pivots, and more columns for warp 0 alone between
# two barriers; on an H100 the widest ran every lift-400 case fastest, each
# step of 4 from 20 to 32 columns 2-5% faster (BP-failing rows at p = 0.028:
# a lone row 6.6 -> 5.7 ms, 129 rows 16.9 -> 15.2 ms)
_MAX_PANEL = 32
_PANEL = 0  # a panel width to force (tests only); 0: osd_large_panel
_MAX_INDEX = 32767  # pivot rows and hit columns are int16 in shared memory
_CHUNK = 4096  # columns of a trailing pass at once (``kChunk``)
_COUNTERS = ("osd_large.pivots", "osd_large.panel_passes")


def osd_large_smem_bytes(m: int, n: int, lam: int, panel: int) -> int:
    """Shared memory of one K5 block, as ``csrc/osd_large.cu:osd_large_smem_bytes``
    computes it (``chip_smoke.py`` holds the two equal on the card): after
    the 32 warps' reduction slots, three panels of ``panel`` columns at an
    odd stride of ``Wm | 1`` words, two panel records (the nonzero words of
    each S_i as int16, ``panel * Wm / 2`` words, the union's words and
    masks, ``2 Wm``, and ``13 panel + 4`` words of tables), the syndromes, a
    chunk's hit bits and g, the T columns and four flag words; then two
    chunks' hit lists and the pivot row of each column as int16."""
    Wm = -(-m // 32)
    record = (panel * Wm + 1) // 2 + 13 * panel + 2 * Wm + 4
    return (8 * 32 + 4 * (3 * panel * (Wm | 1) + 2 * record + 2 * Wm + 2 * _CHUNK
                          + max(lam, 1) + 4) + 2 * (2 * _CHUNK + n))


def _row_words(m: int, n: int) -> int:
    """Scratch words of one sample: ``ceil(m/32)`` words of n + 1 columns,
    the stride rounded up to a multiple of four (16-byte loads)."""
    return -(-m // 32) * ((n + 4) // 4 * 4)


def osd_large_panel(m: int, n: int, lam: int) -> int:
    """K5's panel width: the most columns, up to ``_MAX_PANEL`` (and n),
    whose three panels and two records fit a block's shared memory with
    the rest; 0 if none does."""
    for panel in range(min(_MAX_PANEL, n), 0, -1):
        if osd_large_smem_bytes(m, n, lam, panel) <= _SMEM_LIMIT:
            return panel
    return 0


def osd_large_plan(graph: TannerGraph, osd_order: int) -> dict:
    """K5's launch at this graph on the current card: panel width, dynamic
    shared memory, registers a thread and resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    m, n = graph.m, graph.n
    lam = max(0, min(int(osd_order), n - graph.rank))
    panel = _PANEL or osd_large_panel(m, n, lam)
    out = (ctypes.c_int * 2)()
    err = _build.load().osd_large_plan(n, -(-m // 32), lam, panel, out)
    if err != 0:
        raise RuntimeError(f"osd_large_plan failed: CUDA error {err}")
    return {"panel": panel, "smem_bytes": osd_large_smem_bytes(m, n, lam, panel),
            "registers": out[0], "blocks_per_sm": out[1]}


def osd_large(graph: TannerGraph, perm: torch.Tensor, synd: torch.Tensor, *,
              osd_order: int, pairs=None, skip: torch.Tensor | None = None):
    """osd_cs on reliability order ``perm [B, n]`` int32; ``osd_order == 0``
    is osd0.  Same arguments and results as
    :func:`bp_osd_tpu_torch.ops.cuda_osd.osd_cs`: ``(osd0, osdw)`` uint8
    ``[B, n]`` in original coordinates, zero on skipped rows."""
    dev = perm.device
    B, m, n, r = perm.shape[0], graph.m, graph.n, graph.rank
    Wm = -(-m // 32)
    lam = max(0, min(int(osd_order), n - r))
    skip = _check_inputs(perm, synd, skip, B, m, n, dev)
    require_cuda("osd_large", dev)
    graph = graph.to(dev)
    n_pairs = lam * (lam - 1) // 2
    pairs_t = pairs_on(pairs, n_pairs, dev)
    per_row = _row_words(m, n)
    if per_row >= 2**31 or max(m, n) > _MAX_INDEX:
        raise ValueError(f"a {m} x {n} matrix is beyond the kernel's indexing "
                         f"(int16 rows and columns, 32-bit words)")
    panel = _PANEL or osd_large_panel(m, n, lam)
    if panel == 0:
        raise ValueError(f"n={n}, m={m} needs {osd_large_smem_bytes(m, n, lam, 1)} bytes of "
                         f"shared memory per block, more than the {_SMEM_LIMIT} a block may use")

    lib = _build.load()
    e0 = torch.empty(B, n, dtype=torch.uint8, device=dev)
    ew = torch.empty(B, n, dtype=torch.uint8, device=dev)
    if B:
        with torch.cuda.device(dev):  # the plan and the launch use the current card
            rows = max(1, min(B, _SCRATCH_BYTES // (4 * per_row)))
            scratch = torch.empty(rows * per_row, dtype=torch.int32, device=dev)
            h_cols = graph.H_cols.contiguous()
            stream = torch.cuda.current_stream(dev).cuda_stream
            stats = profiling.device_counter(_COUNTERS, dev)
            for row0 in range(0, B, rows):
                err = lib.osd_large_launch(
                    h_cols.data_ptr(), perm.data_ptr(), synd.data_ptr(),
                    skip.data_ptr() if skip is not None else None,
                    pairs_t.data_ptr() if pairs_t is not None else None,
                    scratch.data_ptr(), e0.data_ptr(), ew.data_ptr(),
                    row0, min(rows, B - row0), m, n, Wm, r, lam, n_pairs, int(lam > 0),
                    panel, stats.data_ptr() if stats is not None else None, stream,
                )
                if err != 0:
                    raise RuntimeError(f"osd_large launch failed: CUDA error {err}")
                count_launch(osd_large, dev)
    return e0, ew


launch_counter(osd_large)
