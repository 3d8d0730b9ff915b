"""Wrapper of kernel K1, ``csrc/bp_flood.cu``: flooding BP, one block per sample.

Replaces ``bp_osd_tpu/ops/pallas_bp.py:bp_decode_pallas``.  CUDA tensors go
to the kernel; CPU tensors to the plain torch version,
:func:`bp_osd_tpu_torch.decoder.bp.bp_decode_plain`.  A graph whose tables and
state fit a block's shared memory (:func:`k1_fits`) runs there; a larger one
keeps each sample's state in a device-memory scratch slice, launched in row
chunks of at most ``_SCRATCH_BYTES``.  ``bp_flood.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from ..decoder.bp import bp_decode_plain
from ..decoder.tanner import TannerGraph
from . import _build

__all__ = ["bp_flood", "bp_flood_smem_bytes", "k1_fits"]

_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_SCRATCH_BYTES = 1 << 30  # device-memory placement: scratch per launch


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bp_flood_smem_bytes(m: int, n: int, wr: int, wc: int) -> int:
    """Shared memory of one K1 block, as ``csrc/bp_flood.cu:bp_flood_smem_bytes``
    computes it (``chip_smoke.py`` holds the two equal on the card)."""
    E = m * wr
    return 4 * (E + n * wc + m + 2 * E + 2 * n)


def k1_fits(graph) -> bool:
    """Whether K1 holds ``graph``'s tables and a sample's state in a block's
    shared memory; otherwise the state goes to device memory."""
    return bp_flood_smem_bytes(graph.m, graph.n, graph.wr, graph.wc) <= _SMEM_LIMIT


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
):
    """Flooding BP; same arguments and results as ``bp_decode_plain``.

    ``synd [B, m]`` uint8, ``llr0 [B, n]`` f32 (a broadcast ``[n]`` row is
    read with stride 0), ``skip [B]`` bool, ``v2c_init [B, m * wr]`` f32.
    """
    kw = dict(method=method, max_iter=max_iter, ms_scaling_factor=ms_scaling_factor,
              skip=skip, v2c_init=v2c_init, it0=it0, emit_state=emit_state)
    if synd.device.type == "cpu":
        return bp_decode_plain(graph, synd, llr0, **kw)
    if synd.device.type != "cuda":
        raise ValueError(f"bp_flood takes CPU or CUDA tensors, got {synd.device}")
    if max_iter <= it0:
        raise ValueError(f"max_iter={max_iter} must exceed it0={it0}")
    dev = synd.device
    graph = graph.to(dev)
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

    lib = _build.load()
    hard = torch.empty(B, n, dtype=torch.uint8, device=dev)
    llr = torch.empty(B, n, dtype=torch.float32, device=dev)
    conv = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    v2c = torch.empty(B, E, dtype=torch.float32, device=dev) if emit_state else None
    if B:
        if k1_fits(graph):
            rows, scratch = B, None
        else:
            per_row = lib.bp_flood_scratch_words(m, n, wr)
            rows = max(1, min(B, _SCRATCH_BYTES // (4 * per_row)))
            scratch = torch.empty(rows * per_row, dtype=torch.int32, device=dev)
        chk_var = graph.chk_var.contiguous()
        var_edge = graph.var_edge.contiguous()
        alpha = float(ms_scaling_factor) if method == "minimum_sum" else 1.0
        stream = torch.cuda.current_stream(dev).cuda_stream

        def ptr(t, row0):  # the chunk's rows of a [B, ...] tensor, or None
            return None if t is None else t[row0:].data_ptr()

        for row0 in range(0, B, rows):
            err = lib.bp_flood_launch(
                ptr(synd, row0), llr0[row0:].data_ptr() if stride else llr0.data_ptr(),
                stride, ptr(skip, row0), ptr(v2c_init, row0),
                chk_var.data_ptr(), var_edge.data_ptr(),
                ptr(hard, row0), ptr(llr, row0), ptr(conv, row0), ptr(iters, row0),
                ptr(v2c, row0), None if scratch is None else scratch.data_ptr(),
                min(rows, B - row0), m, n, wr, wc, int(max_iter), int(it0),
                int(method == "product_sum"), alpha, stream,
            )
            if err != 0:
                raise RuntimeError(f"bp_flood launch failed: CUDA error {err}")
            bp_flood.launches += 1
    return hard, llr, conv.to(torch.bool), iters, v2c


bp_flood.launches = 0
