"""Wrapper of kernel K5, ``csrc/osd_large.cu``: osd0 / osd_cs for codes whose
matrix does not fit in a block's shared memory.

Replaces ``bp_osd_tpu/ops/pallas_osd_large.py:osd_cs_large_pallas``.  It
takes CUDA tensors only; its plain torch version is in
:mod:`bp_osd_tpu_torch.decoder.osd` (the same as K2's).
Each sample's ``(n + 1) x ceil(m/32)`` matrix lives in a scratch buffer that
this wrapper allocates, word-major (word ``w`` of every column contiguous);
the kernel eliminates it a panel of :func:`osd_large_panel` columns at a
time in shared memory and takes each panel's pivots to the later columns
in one trailing pass.  Rows are launched in
chunks so the scratch stays within ``_SCRATCH_BYTES``, with the tensors'
card current.  A launch runs in one of two plans, chosen by
:func:`osd_large_cluster` from its rows, the card's SMs and the graph alone:

- a block a sample, wherever the launch's rows times two exceed the SMs
  (a heavy batch fills the card): the block's warp 0 factorises the panels
  and its other 31 warps make every trailing pass;
- the cluster plan below that: a thread-block cluster of C = 8, 4 or 2
  blocks a sample, the most whose clusters the card holds all at once
  (``cudaOccupancyMaxActiveClusters``).  Block 0 factorises the panels and
  takes the next panel past the last two, as the lone block does; blocks
  1..C-1 make the far trailing passes, each over its share of the later
  columns, with the panel's record read from block 0's shared memory.  A
  lone lift-400 row's elimination is warp 0's chain of dependent pivots,
  which then shares its SM with no trailing pass.

Both factorise a panel alike (warp 0, left-looking in the panel) and give
the same bits (XOR commutes; the far passes are the same passes on other
SMs).  ``osd_large.launches`` counts kernel launches
(``osd_large.launches_on`` by card); while the recorder of
:mod:`bp_osd_tpu_torch.utils.profiling` is on, each launch adds its rows to
the counter ``osd_large.rows`` and, in the cluster plan, to
``osd_large.cluster_rows``, and the kernel adds its pivots and its trailing
passes to the counters ``osd_large.pivots`` and ``osd_large.panel_passes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..decoder.tanner import TannerGraph
from ..utils import profiling
from . import _build, count_launch, launch_counter, require_cuda
from .cuda_bp import _SMEM_LIMIT
from .cuda_osd import _check_inputs, pairs_on

__all__ = ["osd_large", "osd_large_cluster", "osd_large_clusters", "osd_large_panel",
           "osd_large_plan", "osd_large_smem_bytes"]

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
_CLUSTERS = (8, 4, 2)  # blocks a sample the cluster plan tries, the most first


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


def osd_large_cluster(B: int, sms: int, clusters) -> int:
    """Blocks a sample for a K5 launch of ``B`` rows on a card of ``sms``
    SMs: the most C in 8, 4, 2 with ``B * C <= sms`` whose B clusters the
    card holds at once (``clusters(C) >= B``, ``clusters`` giving the
    clusters of C blocks resident together, as :func:`osd_large_clusters`
    reads them); else 1, a block a sample.  Each band wins on the card
    (H100, BP-failing lift-400 rows and the gross code's space-time matrix,
    in turns against a block a sample): 1 and 8 rows, clusters of 8, 23-49%
    faster; 16 rows, clusters of 4, 29-48%; 31-66 rows, clusters of 2,
    3-13%; 129 rows, clusters of 2 in two waves, 5-6% slower.  No floor on n: the gross code (n 2736) gains as the lifted one
    (n 10000) does."""
    for c in _CLUSTERS:
        if B * c <= sms and clusters(c) >= B:
            return c
    return 1


def osd_large_clusters(graph: TannerGraph, osd_order: int, cluster: int) -> dict:
    """The cluster plan's launch at this graph on the current card with
    ``cluster`` blocks a sample: registers a thread and the clusters
    resident at once (``cudaOccupancyMaxActiveClusters``)."""
    m, n = graph.m, graph.n
    lam = max(0, min(int(osd_order), n - graph.rank))
    regs, held = _clusters(torch.cuda.current_device(), n, -(-m // 32), lam,
                           _PANEL or osd_large_panel(m, n, lam), cluster)
    return {"registers": regs, "clusters": held}


@functools.lru_cache(maxsize=None)
def _clusters(device: int, n: int, Wm: int, lam: int, panel: int,
              cluster: int) -> tuple[int, int]:
    """(registers a thread, clusters resident at once) of the cluster plan
    at this shape on ``device``, the current card.  The CUDA runtime's answer
    depends on nothing else, so it is asked once, not at every launch."""
    out = (ctypes.c_int * 2)()
    err = _build.load().osd_large_clusters(n, Wm, lam, panel, cluster, out)
    if err != 0:
        raise RuntimeError(f"osd_large_clusters failed: CUDA error {err}")
    return out[0], out[1]


def osd_large(graph: TannerGraph, perm: torch.Tensor, synd: torch.Tensor, *,
              osd_order: int, pairs=None, skip: torch.Tensor | None = None):
    """osd_cs on reliability order ``perm [B, n]`` int32; ``osd_order == 0``
    is osd0.  Same arguments and results as
    :func:`bp_osd_tpu_torch.ops.cuda_osd.osd_cs`: ``(osd0, osdw)`` uint8
    ``[B, n]`` in original coordinates, zero on skipped rows."""
    return _osd_large(graph, perm, synd, osd_order, pairs, skip, None)


def _osd_large(graph, perm, synd, osd_order, pairs, skip, cluster):
    """:func:`osd_large` with ``cluster`` blocks a sample in every launch,
    or the plan :func:`osd_large_cluster` picks where ``cluster`` is None
    (the card's tests and ``chip_smoke.py`` hold and time both plans)."""
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
            card = torch.cuda.current_device()
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            for row0 in range(0, B, rows):
                nrows = min(rows, B - row0)
                c = cluster or osd_large_cluster(
                    nrows, sms, lambda c: _clusters(card, n, Wm, lam, panel, c)[1])
                err = lib.osd_large_launch(
                    h_cols.data_ptr(), perm.data_ptr(), synd.data_ptr(),
                    skip.data_ptr() if skip is not None else None,
                    pairs_t.data_ptr() if pairs_t is not None else None,
                    scratch.data_ptr(), e0.data_ptr(), ew.data_ptr(),
                    row0, nrows, m, n, Wm, r, lam, n_pairs, int(lam > 0), panel, c,
                    stats.data_ptr() if stats is not None else None, stream,
                )
                if err != 0:
                    raise RuntimeError(f"osd_large launch failed: CUDA error {err}")
                count_launch(osd_large, dev)
                profiling.count("osd_large.rows", nrows)
                if c > 1:
                    profiling.count("osd_large.cluster_rows", nrows)
    return e0, ew


launch_counter(osd_large)
