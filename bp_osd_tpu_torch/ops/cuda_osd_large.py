"""Wrapper of kernel K5, ``csrc/osd_large.cu``: osd0 / osd_cs for codes whose
matrix does not fit in a block's shared memory, one block per sample.

Replaces ``bp_osd_tpu/ops/pallas_osd_large.py:osd_cs_large_pallas``.  CUDA
tensors go to the kernel; CPU tensors to the plain torch version,
:func:`bp_osd_tpu_torch.decoder.osd.osd_decode_plain` (the same as for K2).
Each sample's ``(n + 1) x ceil(m/32)`` matrix lives in a scratch buffer that
this wrapper allocates; rows are launched in chunks so the scratch stays
within ``_SCRATCH_BYTES``.  ``osd_large.launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decoder.osd import osd_decode_plain
from ..decoder.tanner import TannerGraph
from . import _build
from .cuda_bp import _SMEM_LIMIT, _check

__all__ = ["osd_large"]

_SCRATCH_BYTES = 3 << 30  # 3 GiB: 512 samples of the [[10000,420]] code


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
    pairs_t = None
    if n_pairs:
        pairs = np.asarray(pairs, np.int32)
        if pairs.shape != (n_pairs, 2):
            raise ValueError(f"pairs: expected ({n_pairs}, 2), got {pairs.shape}")
        pairs_t = torch.from_numpy(pairs.reshape(-1)).to(dev)
    per_row = (n + 1) * Wm
    if per_row >= 2**31:
        raise ValueError(f"a {m} x {n} matrix is beyond the kernel's 32-bit indexing")

    lib = _build.load()
    smem = lib.osd_large_smem_bytes(n, Wm, lam)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"n={n} needs {smem} bytes of shared memory per block, "
                         f"more than the {_SMEM_LIMIT} a block may use")
    e0 = torch.empty(B, n, dtype=torch.uint8, device=dev)
    ew = torch.empty(B, n, dtype=torch.uint8, device=dev)
    if B:
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
                stream,
            )
            if err != 0:
                raise RuntimeError(f"osd_large launch failed: CUDA error {err}")
            osd_large.launches += 1
    return e0, ew


osd_large.launches = 0
