"""Wrapper of kernel K5, ``csrc/osd_large.cu``: osd0 / osd_cs for codes whose
matrix does not fit in a block's shared memory, one block per sample.

Replaces ``bp_osd_tpu/ops/pallas_osd_large.py:osd_cs_large_pallas``.  CUDA
tensors go to the kernel; CPU tensors to the plain torch version,
:func:`bp_osd_tpu_torch.decoder.osd.osd_decode_plain` (the same as for K2).
Each sample's ``(n + 1) x ceil(m/32)`` matrix lives in a scratch buffer that
this wrapper allocates, word-major (word ``w`` of every column contiguous);
the kernel works on a window of two panels of :func:`osd_large_panel`
columns in shared memory.  Rows are launched in chunks so the scratch stays
within ``_SCRATCH_BYTES``, with the tensors' card current.
``osd_large.launches`` counts kernel launches (``osd_large.launches_on`` by
card).
"""

from __future__ import annotations

import ctypes

import torch

from ..decoder.osd import osd_decode_plain
from ..decoder.tanner import TannerGraph
from . import _build, count_launch, launch_counter
from .cuda_bp import _SMEM_LIMIT, _check
from .cuda_osd import pairs_on

__all__ = ["osd_large", "osd_large_panel", "osd_large_plan", "osd_large_smem_bytes"]

_SCRATCH_BYTES = 3 << 30  # 3 GiB: 512 samples of the [[10000,420]] code
# columns a panel, at most: on the H100 panels of 8-16 columns ran the
# [[10000,420]] code fastest, 64 the slowest (chip_smoke.py phase 7)
_MAX_PANEL = 16
_PANEL = 0  # a panel width to force (tests only); 0: osd_large_panel
_MAX_INDEX = 32767  # pivot rows and hit columns are int16 in shared memory


def osd_large_smem_bytes(m: int, n: int, lam: int, panel: int) -> int:
    """Shared memory of one K5 block, as ``csrc/osd_large.cu:osd_large_smem_bytes``
    computes it (``chip_smoke.py`` holds the two equal on the card): two
    panels of ``panel`` columns at an odd stride of ``Wm | 1`` words, S twice
    (words and indices), the syndromes, the T columns and ten event words, then the pivot row of each column and the hit list as
    int16, after the 32 warps' reduction slots."""
    Wm = -(-m // 32)
    return 8 * 32 + 4 * (2 * panel * (Wm | 1) + 6 * Wm + max(lam, 1) + 10) + 2 * (2 * n + 1)


def _row_words(m: int, n: int) -> int:
    """Scratch words of one sample: ``ceil(m/32)`` words of n + 1 columns."""
    return -(-m // 32) * (n + 1)


def osd_large_panel(m: int, n: int, lam: int) -> int:
    """K5's panel width: the most columns, up to 16 (and n), whose two
    panels fit a block's shared memory with the rest; 0 if none does."""
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
    if perm.device.type == "cpu":
        return osd_decode_plain(graph, perm, synd, method="osd_cs",
                                osd_order=osd_order, pairs=pairs, skip=skip)
    if perm.device.type != "cuda":
        raise ValueError(f"osd_large takes CPU or CUDA tensors, got {perm.device}")
    dev = perm.device
    graph = graph.to(dev)
    B, m, n, r = perm.shape[0], graph.m, graph.n, graph.rank
    Wm = -(-m // 32)
    lam = max(0, min(int(osd_order), n - r))
    _check(perm, "perm", torch.int32, (B, n), dev)
    _check(synd, "synd", torch.uint8, (B, m), dev)
    if skip is not None:
        skip = skip.to(torch.uint8)
        _check(skip, "skip", torch.uint8, (B,), dev)
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
            for row0 in range(0, B, rows):
                err = lib.osd_large_launch(
                    h_cols.data_ptr(), perm.data_ptr(), synd.data_ptr(),
                    skip.data_ptr() if skip is not None else None,
                    pairs_t.data_ptr() if pairs_t is not None else None,
                    scratch.data_ptr(), e0.data_ptr(), ew.data_ptr(),
                    row0, min(rows, B - row0), m, n, Wm, r, lam, n_pairs, int(lam > 0),
                    panel, stream,
                )
                if err != 0:
                    raise RuntimeError(f"osd_large launch failed: CUDA error {err}")
                count_launch(osd_large, dev)
    return e0, ew


launch_counter(osd_large)
