"""Wrappers of kernels K2 and K3, ``csrc/osd_cs.cu``: osd0 / osd_cs
(:func:`osd_cs`) and osd_e (:func:`osd_e`), both one warp per sample,
several samples a block sharing the column-packed H.

Replace ``bp_osd_tpu/ops/pallas_osd.py:osd_cs_pallas`` and ``osd_e_pallas``
and their pre-pass ``_permuted_packed_h`` (the kernels build the permuted
matrix themselves from ``perm`` and ``H_cols``).  They take CUDA tensors
only; their plain torch version is in
:mod:`bp_osd_tpu_torch.decoder.osd`.  A launch runs with
its tensors' card current.  ``osd_cs.launches`` and ``osd_e.launches``
count kernel launches (``launches_on`` by card).
"""

from __future__ import annotations

import ctypes

import torch

from ..decoder.tanner import TannerGraph
from ..utils import profiling
from . import _build, count_launch, launch_counter, require_cuda
from .cuda_bp import _SMEM_LIMIT, _check

__all__ = ["k2_fits", "k3_fits", "osd_cs", "osd_cs_plan", "osd_cs_warp_smem_bytes", "osd_e"]

_MAX_WORDS = 32  # K2 and K3 keep a column of ceil(m/32) <= 32 words in registers


def osd_cs_warp_smem_bytes(m: int, n: int, lam: int, warps: int = 1) -> int:
    """Shared memory of one K2 or K3 block of ``warps`` samples: the column-packed
    H once, then per warp the ``n + 1`` columns, the pivot rows (int16), the
    T columns and the best residual, as
    ``csrc/osd_cs.cu:osd_cs_warp_smem_bytes`` computes it.  A column takes
    ``Wm = ceil(m/32)`` words rounded up to even (it is XORed in 64-bit
    pairs)."""
    return _block_bytes(m, n, lam, warps, inv=False)


def _block_bytes(m: int, n: int, lam: int, warps: int, *, inv: bool) -> int:
    """A warp kernel's block in ``csrc/osd_cs.cu:block_words``; ``inv`` adds
    K4's inverse perm (n int16) to each warp's slice."""
    Wm = -(-m // 32)
    Wp = Wm + (Wm & 1)
    per_warp = (n + 1) * Wp + (n + 1) // 2 + max(lam, 1) + Wm + ((n + 1) // 2 if inv else 0)
    per_warp += per_warp & 1  # even: the next warp's columns stay 8-byte aligned
    return 4 * (n * Wp + warps * per_warp)


def k2_fits(graph: TannerGraph, osd_order: int) -> bool:
    """Whether K2 holds this graph's matrix in a block's shared memory at
    ``osd_order`` (one warp's sample and the shared H); the card decodes the
    rest with K5 (``osd_large.cu``), as the JAX package routes by
    ``fused_osd_fits``."""
    lam = max(0, min(int(osd_order), graph.n - graph.rank))
    return (-(-graph.m // 32) <= _MAX_WORDS
            and osd_cs_warp_smem_bytes(graph.m, graph.n, lam) <= _SMEM_LIMIT)


def k3_fits(graph: TannerGraph, osd_order: int) -> bool:
    """Whether K3 takes this graph at ``osd_order``: K2's fit (one warp's
    sample and the shared H in a block's shared memory, at most 1024 rows);
    the card runs the rest through K4 and the torch search."""
    return k2_fits(graph, osd_order)


def osd_cs_plan(graph: TannerGraph, B: int, osd_order: int, method: str = "osd_cs") -> dict:
    """The launch of K2 (``method="osd_cs"``) or K3 (``"osd_e"``) for ``B``
    rows on the current card, from ``csrc/osd_cs.cu:osd_cs_plan``: warps
    (samples) a block, blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), grid, dynamic
    shared memory, registers a thread, and the samples resident on an SM."""
    if method not in ("osd_cs", "osd_e"):
        raise ValueError(f"osd_cs_plan: method {method!r} is neither osd_cs nor osd_e")
    lam = max(0, min(int(osd_order), graph.n - graph.rank))
    return warp_plan(graph, B, lam, int(method == "osd_e"))


def warp_plan(graph, B: int, lam: int, mode: int) -> dict:
    """``csrc/osd_cs.cu:osd_cs_plan`` for ``mode`` 0 (K2), 1 (K3) or 2 (K4's
    warp kernel), as :func:`osd_cs_plan` describes it."""
    plan = (ctypes.c_int * 5)()
    err = _build.load().osd_cs_plan(int(B), graph.m, graph.n, lam, mode, plan)
    if err != 0:
        raise RuntimeError(f"osd_cs_plan failed: CUDA error {err}")
    out = dict(zip(("warps_per_block", "blocks_per_sm", "grid", "smem_bytes", "registers"),
                   plan))
    out["resident_per_sm"] = out["warps_per_block"] * out["blocks_per_sm"]
    return out


def pairs_on(pairs, n_pairs: int, dev: torch.device) -> torch.Tensor | None:
    """``pairs [n_pairs, 2]`` (numpy, or a tensor already on ``dev``, which is
    not copied) as flat int32 on ``dev``; None when ``n_pairs`` is 0.  A copy
    to the card is the host sync ``sync.pairs``."""
    if not n_pairs:
        return None
    if torch.is_tensor(pairs) and pairs.device == dev:
        t = pairs.to(torch.int32)
    else:
        with profiling.sync("pairs"):
            t = torch.as_tensor(pairs, dtype=torch.int32, device=dev)
    if tuple(t.shape) != (n_pairs, 2):
        raise ValueError(f"pairs: expected ({n_pairs}, 2), got {tuple(t.shape)}")
    return t.reshape(-1).contiguous()


def _check_inputs(perm, synd, skip, B, m, n, dev):
    _check(perm, "perm", torch.int32, (B, n), dev)
    _check(synd, "synd", torch.uint8, (B, m), dev)
    if skip is not None:
        skip = skip.to(torch.uint8)
        _check(skip, "skip", torch.uint8, (B,), dev)
    return skip


def osd_cs(graph: TannerGraph, perm: torch.Tensor, synd: torch.Tensor, *,
           osd_order: int, pairs=None, skip: torch.Tensor | None = None):
    """osd_cs on reliability order ``perm [B, n]`` int32; ``osd_order == 0``
    is osd0.  ``pairs`` is ``build_osd_consts(...).pairs`` (``[C2, 2]``,
    None below two T columns).  Returns ``(osd0, osdw)`` uint8 ``[B, n]`` in
    original coordinates, zero on skipped rows."""
    dev = perm.device
    B, m, n, r = perm.shape[0], graph.m, graph.n, graph.rank
    lam = max(0, min(int(osd_order), n - r))
    if not k2_fits(graph, lam):
        raise ValueError(f"K2 does not take m={m}, n={n} at lam={lam} (k2_fits); "
                         f"the card decodes it with K5")
    skip = _check_inputs(perm, synd, skip, B, m, n, dev)
    require_cuda("osd_cs", dev)
    graph = graph.to(dev)
    n_pairs = lam * (lam - 1) // 2
    pairs_t = pairs_on(pairs, n_pairs, dev)

    lib = _build.load()
    e0 = torch.empty(B, n, dtype=torch.uint8, device=dev)
    ew = torch.empty(B, n, dtype=torch.uint8, device=dev)
    if B:
        with torch.cuda.device(dev):  # the plan and the launch use the current card
            err = lib.osd_cs_launch(
                graph.H_cols.contiguous().data_ptr(), perm.data_ptr(), synd.data_ptr(),
                skip.data_ptr() if skip is not None else None,
                pairs_t.data_ptr() if pairs_t is not None else None,
                e0.data_ptr(), ew.data_ptr(),
                B, m, n, r, lam, n_pairs, int(lam > 0),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            if err != 0:
                raise RuntimeError(f"osd_cs launch failed: CUDA error {err}")
            count_launch(osd_cs, dev)
    return e0, ew


launch_counter(osd_cs)


def osd_e(graph: TannerGraph, perm: torch.Tensor, synd: torch.Tensor, *,
          osd_order: int, skip: torch.Tensor | None = None):
    """osd_e on reliability order ``perm [B, n]`` int32: all ``2^lam``
    patterns on the first ``lam = min(osd_order, n - rank)`` T columns,
    ``1 <= lam <= 16``, in kernel K3.  Returns ``(osd0, osdw)`` uint8
    ``[B, n]`` in original coordinates, zero on skipped rows."""
    dev = perm.device
    B, m, n, r = perm.shape[0], graph.m, graph.n, graph.rank
    lam = max(0, min(int(osd_order), n - r))
    if not 1 <= lam <= 16 or not k3_fits(graph, lam):
        raise ValueError(f"K3 takes 1 <= lam <= 16 on a graph that fits it "
                         f"(k3_fits); got lam={lam} for m={m}, n={n}")
    skip = _check_inputs(perm, synd, skip, B, m, n, dev)
    require_cuda("osd_e", dev)
    graph = graph.to(dev)
    lib = _build.load()
    e0 = torch.empty(B, n, dtype=torch.uint8, device=dev)
    ew = torch.empty(B, n, dtype=torch.uint8, device=dev)
    if B:
        with torch.cuda.device(dev):  # the plan and the launch use the current card
            err = lib.osd_e_launch(
                graph.H_cols.contiguous().data_ptr(), perm.data_ptr(), synd.data_ptr(),
                skip.data_ptr() if skip is not None else None, e0.data_ptr(), ew.data_ptr(),
                B, m, n, r, lam, torch.cuda.current_stream(dev).cuda_stream,
            )
            if err != 0:
                raise RuntimeError(f"osd_e launch failed: CUDA error {err}")
            count_launch(osd_e, dev)
    return e0, ew


launch_counter(osd_e)
