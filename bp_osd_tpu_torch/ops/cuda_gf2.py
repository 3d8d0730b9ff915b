"""Wrapper of kernel K4, ``csrc/gf2_elim.cu``: batched GF(2) Gauss-Jordan
elimination in a per-sample column order, one block per sample.

Replaces ``bp_osd_tpu/ops/pallas_gf2.py:eliminate_pallas``.  CUDA tensors go
to the kernel; CPU tensors to the plain torch version,
:func:`bp_osd_tpu_torch.decoder.osd.eliminate_plain`.  A matrix that fits a
block's shared memory (:func:`k4_fits`) is eliminated there; a larger one in
place in its sample's slice of the ``h_work`` output.  Rows are launched in
chunks of at most ``_LAUNCH_BYTES`` of ``h_work``.  ``eliminate.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from ..decoder.osd import Elimination, eliminate_plain
from ..decoder.tanner import TannerGraph
from . import _build
from .cuda_bp import _SMEM_LIMIT
from .cuda_osd import _check_inputs

__all__ = ["eliminate", "gf2_elim_smem_bytes", "k4_fits"]

_LAUNCH_BYTES = 3 << 30  # h_work bytes one launch covers
PLACEMENTS = ("auto", "shared", "global")


def gf2_elim_smem_bytes(m: int, n: int, in_global: bool = False) -> int:
    """Shared memory of one K4 block, as ``csrc/gf2_elim.cu:gf2_elim_smem_bytes``
    computes it (``chip_smoke.py`` holds the two equal on the card)."""
    W, Wm = -(-n // 32), -(-m // 32)
    return 4 * ((0 if in_global else m * W) + 3 * Wm + 3)


def k4_fits(graph) -> bool:
    """Whether K4 holds ``graph``'s row-packed matrix in a block's shared
    memory, as the JAX package asks ``eliminate_fits``; otherwise the matrix
    is eliminated in device memory.  ``graph`` needs ``m n``."""
    return gf2_elim_smem_bytes(graph.m, graph.n) <= _SMEM_LIMIT


def eliminate(graph: TannerGraph, perm: torch.Tensor, synd: torch.Tensor, *,
              skip: torch.Tensor | None = None, placement: str = "auto") -> Elimination:
    """Eliminate H in column order ``perm [B, n]`` int32 with syndromes
    ``synd [B, m]`` uint8; returns the five outputs of
    :class:`~bp_osd_tpu_torch.decoder.osd.Elimination`, zero on skipped rows.
    ``placement`` ``"shared"`` or ``"global"`` forces where the matrix lives
    (``"auto"``: shared when :func:`k4_fits`)."""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    if perm.device.type == "cpu":
        return eliminate_plain(graph, perm, synd, skip=skip)
    if perm.device.type != "cuda":
        raise ValueError(f"eliminate takes CPU or CUDA tensors, got {perm.device}")
    dev = perm.device
    graph = graph.to(dev)
    B, m, n, r, W = perm.shape[0], graph.m, graph.n, graph.rank, graph.num_words
    skip = _check_inputs(perm, synd, skip, B, m, n, dev)
    in_global = placement == "global" or (placement == "auto" and not k4_fits(graph))
    lib = _build.load()
    smem = lib.gf2_elim_smem_bytes(m, W, int(in_global))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"K4 needs {smem} bytes of shared memory per block, more "
                         f"than the {_SMEM_LIMIT} a block may use")
    out = Elimination(
        torch.empty(B, m, W, dtype=torch.int32, device=dev),
        torch.empty(B, m, dtype=torch.int32, device=dev),
        torch.empty(B, r, dtype=torch.int32, device=dev),
        torch.empty(B, r, dtype=torch.int32, device=dev),
        torch.empty(B, n, dtype=torch.bool, device=dev),
    )
    if B:
        rows = max(1, min(B, _LAUNCH_BYTES // (4 * m * W)))
        h_packed = graph.H_packed.contiguous()
        stream = torch.cuda.current_stream(dev).cuda_stream
        for row0 in range(0, B, rows):
            err = lib.gf2_elim_launch(
                h_packed.data_ptr(), perm[row0:].data_ptr(), synd[row0:].data_ptr(),
                skip[row0:].data_ptr() if skip is not None else None,
                *(x[row0:].data_ptr() for x in out),
                min(rows, B - row0), m, n, W, r, int(in_global), stream,
            )
            if err != 0:
                raise RuntimeError(f"gf2_elim launch failed: CUDA error {err}")
            eliminate.launches += 1
    return out


eliminate.launches = 0
