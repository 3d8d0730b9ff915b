"""Wrapper of kernel K4: batched GF(2) Gauss-Jordan elimination in a
per-sample column order, with the JAX package's five outputs.

Replaces ``bp_osd_tpu/ops/pallas_gf2.py:eliminate_pallas``.  It takes CUDA
tensors only; its plain torch version is in
:mod:`bp_osd_tpu_torch.decoder.osd`.  K4 has two kernels,
picked by :func:`k4_placement`:

- ``"warp"`` (``csrc/osd_cs.cu:gf2_elim_warp_launch``): a warp per sample,
  several samples a block sharing the column-packed H, K2's elimination
  (:func:`k4_warp_fits`: every code whose osd0 ``osd_route`` sends to K4);
- ``"shared"`` / ``"global"`` (``csrc/gf2_elim.cu``): a block per sample, the
  row-packed matrix in shared memory when :func:`k4_fits`, else in place in
  its sample's slice of the ``h_work`` output.

Rows are launched in chunks of at most ``_LAUNCH_BYTES`` of ``h_work``, with
the tensors' card current.  ``eliminate.launches`` counts the launches of
both kernels (``eliminate.launches_on`` by card), ``eliminate.warp_launches``
those of the warp kernel.
"""

from __future__ import annotations

import torch

from ..decoder.osd import Elimination
from ..decoder.tanner import TannerGraph
from . import _build, count_launch, launch_counter, require_cuda
from .cuda_bp import _SMEM_LIMIT
from .cuda_osd import _MAX_WORDS, _block_bytes, _check_inputs, warp_plan

__all__ = ["eliminate", "gf2_elim_plan", "gf2_elim_smem_bytes", "gf2_elim_warp_smem_bytes",
           "k4_fits", "k4_placement", "k4_warp_fits"]

_LAUNCH_BYTES = 3 << 30  # h_work bytes one launch covers
PLACEMENTS = ("auto", "warp", "shared", "global")


def gf2_elim_smem_bytes(m: int, n: int, in_global: bool = False) -> int:
    """Shared memory of one block of K4's block kernel, as
    ``csrc/gf2_elim.cu:gf2_elim_smem_bytes`` computes it (``chip_smoke.py``
    holds the two equal on the card)."""
    W, Wm = -(-n // 32), -(-m // 32)
    return 4 * ((0 if in_global else m * W) + 3 * Wm + 3)


def gf2_elim_warp_smem_bytes(m: int, n: int, warps: int = 1) -> int:
    """Shared memory of one block of ``warps`` samples of K4's warp kernel:
    K2's layout at order 0 (``cuda_osd.osd_cs_warp_smem_bytes``) with the
    inverse of perm (n int16) in each warp's slice, as
    ``csrc/osd_cs.cu:gf2_elim_warp_smem_bytes`` computes it."""
    return _block_bytes(m, n, 0, warps, inv=True)


def k4_fits(graph) -> bool:
    """Whether the block kernel holds ``graph``'s row-packed matrix in a
    block's shared memory, as the JAX package asks ``eliminate_fits``;
    otherwise it eliminates in device memory.  ``graph`` needs ``m n``."""
    return gf2_elim_smem_bytes(graph.m, graph.n) <= _SMEM_LIMIT


def k4_warp_fits(graph) -> bool:
    """Whether the warp kernel takes ``graph``: at most 32 words (1024 rows)
    a column and one warp's sample with the shared H in a block's shared
    memory.  ``graph`` needs ``m n``."""
    return (-(-graph.m // 32) <= _MAX_WORDS
            and gf2_elim_warp_smem_bytes(graph.m, graph.n) <= _SMEM_LIMIT)


def k4_placement(graph) -> str:
    """What ``placement="auto"`` runs: ``"warp"`` where :func:`k4_warp_fits`,
    else the block kernel in ``"shared"`` memory where :func:`k4_fits`, else
    in ``"global"`` (device) memory."""
    if k4_warp_fits(graph):
        return "warp"
    return "shared" if k4_fits(graph) else "global"


def gf2_elim_plan(graph, B: int) -> dict:
    """The launch of the warp kernel for ``B`` rows on the current card, from
    ``csrc/osd_cs.cu:osd_cs_plan`` (mode 2): warps (samples) a block, blocks
    an SM, grid, dynamic shared memory, registers a thread, and the samples
    resident on an SM."""
    return warp_plan(graph, B, 0, 2)


def eliminate(graph: TannerGraph, perm: torch.Tensor, synd: torch.Tensor, *,
              skip: torch.Tensor | None = None, placement: str = "auto") -> Elimination:
    """Eliminate H in column order ``perm [B, n]`` int32 with syndromes
    ``synd [B, m]`` uint8; returns the five outputs of
    :class:`~bp_osd_tpu_torch.decoder.osd.Elimination`, zero on skipped rows.
    ``placement`` ``"warp"``, ``"shared"`` or ``"global"`` forces the kernel
    (``"auto"``: :func:`k4_placement`)."""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    dev = perm.device
    B, m, n, r, W = perm.shape[0], graph.m, graph.n, graph.rank, graph.num_words
    skip = _check_inputs(perm, synd, skip, B, m, n, dev)
    require_cuda("eliminate", dev)
    graph = graph.to(dev)
    place = k4_placement(graph) if placement == "auto" else placement
    lib = _build.load()
    if place == "warp":
        if not k4_warp_fits(graph):
            raise ValueError(f"K4's warp kernel does not take m={m}, n={n} (k4_warp_fits)")
        h = graph.H_cols.contiguous()
    else:
        smem = lib.gf2_elim_smem_bytes(m, W, int(place == "global"))
        if smem > _SMEM_LIMIT:
            raise ValueError(f"K4 needs {smem} bytes of shared memory per block, more "
                             f"than the {_SMEM_LIMIT} a block may use")
        h = graph.H_packed.contiguous()
    out = Elimination(
        torch.empty(B, m, W, dtype=torch.int32, device=dev),
        torch.empty(B, m, dtype=torch.int32, device=dev),
        torch.empty(B, r, dtype=torch.int32, device=dev),
        torch.empty(B, r, dtype=torch.int32, device=dev),
        torch.empty(B, n, dtype=torch.bool, device=dev),
    )
    if B:
        with torch.cuda.device(dev):  # the plan and the launch use the current card
            rows = max(1, min(B, _LAUNCH_BYTES // (4 * m * W)))
            stream = torch.cuda.current_stream(dev).cuda_stream
            for row0 in range(0, B, rows):
                ptrs = (h.data_ptr(), perm[row0:].data_ptr(), synd[row0:].data_ptr(),
                        skip[row0:].data_ptr() if skip is not None else None,
                        *(x[row0:].data_ptr() for x in out))
                nb = min(rows, B - row0)
                if place == "warp":
                    err = lib.gf2_elim_warp_launch(*ptrs, nb, m, n, r, stream)
                else:
                    err = lib.gf2_elim_launch(*ptrs, nb, m, n, W, r, int(place == "global"), stream)
                if err != 0:
                    raise RuntimeError(f"gf2_elim ({place}) launch failed: CUDA error {err}")
                if place == "warp":
                    count_launch(eliminate, dev, "warp_launches")
                else:
                    count_launch(eliminate, dev)
    return out


launch_counter(eliminate)
eliminate.warp_launches = 0
