"""Layered (serial-schedule) belief propagation.

Port of ``bp_osd_tpu/decoder/layered.py``.  Checks are greedily colored so
that no two checks in a layer share a variable, and the graph's rows are
reordered by layer.  One iteration sweeps the layers in order: a layer reads
the current posteriors of its variables, updates its checks' messages and
adds each message's change to its variable's posterior, so information
crosses the graph in one sweep instead of one hop per iteration.

The JAX package routes a layer through one-hot matrices (``layer_ops``, a
TPU device for the matrix unit).  Here each layer has two index tables, the
flat edges of its valid slots and their variables.  Within a layer no two
edges share a variable, so JAX's ``totals + einsum(delta, M)`` adds exactly
one nonzero term per variable, and the gather and ``index_add`` here give
the same floats.  XLA:CPU contracts the min-sum message and its change,
``delta = +-alpha * excl - old``, into one fused multiply-add; ``_fma_f32``
rounds that once as well, so min-sum equals the JAX XLA path bit for bit.

Plain torch on both devices: the JAX version is XLA only, with no Pallas
kernel.  Rows leave the working set as they converge.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import gf2
from .bp import (
    BPResult,
    _alpha,
    _check_update_product_sum,
    _min_sum_factors,
    as_f32,
    as_syndromes,
    normalize_bp_method,
)
from .tanner import TannerGraph, canonical_device

__all__ = ["LayeredTannerGraph", "bp_decode_layered", "color_checks"]


def color_checks(H: np.ndarray) -> list[np.ndarray]:
    """Greedy conflict coloring: checks in a layer share no variable."""
    m, _ = H.shape
    supports = [frozenset(np.nonzero(H[i])[0]) for i in range(m)]
    layers: list[list[int]] = []
    layer_vars: list[set] = []
    for i in range(m):
        for l, used in enumerate(layer_vars):
            if not (used & supports[i]):
                layers[l].append(i)
                used.update(supports[i])
                break
        else:
            layers.append([i])
            layer_vars.append(set(supports[i]))
    return [np.asarray(l, dtype=np.int64) for l in layers]


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors, rounded once to float32 (a fused
    multiply-add).

    ``a * b`` is exact in float64.  The float64 sum is made round-to-odd (a
    TwoSum error term sets the last bit when the sum was inexact), and a
    round-to-odd value with 29 spare bits rounds to float32 correctly.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


class LayeredTannerGraph(TannerGraph):
    """Tanner graph of ``H[row_perm]``, checks in conflict-free layers.

    ``row_perm`` maps the layered check order to original check ids
    (``bp_decode_layered`` permutes syndromes with it); layer ``l`` holds the
    rows ``layer_bounds[l]``.  ``layer_edges[l]`` are the flat edges of its
    valid slots, counted from the layer's first edge, and ``layer_vars[l]``
    their variables.  ``device`` defaults as :class:`TannerGraph`'s does:
    the card when there is one.
    """

    def __init__(self, H, device=None):
        Hd = gf2.to_dense(H)
        layers = color_checks(Hd)
        row_perm = np.concatenate(layers)
        super().__init__(Hd[row_perm], device)
        self.row_perm = row_perm
        bounds = np.cumsum([0] + [len(l) for l in layers])
        self.layer_bounds = tuple((int(lo), int(hi)) for lo, hi in zip(bounds, bounds[1:]))
        chk_var = self.chk_var.cpu().numpy()
        edges, variables = [], []
        for lo, hi in self.layer_bounds:
            flat = chk_var[lo:hi].reshape(-1)
            e = np.nonzero(flat != self.n)[0]
            edges.append(torch.from_numpy(e).to(self.device))
            variables.append(torch.from_numpy(flat[e].astype(np.int64)).to(self.device))
        self.layer_edges = tuple(edges)
        self.layer_vars = tuple(variables)
        self._row_perm_t = torch.from_numpy(row_perm).to(self.device)

    def to(self, device) -> "LayeredTannerGraph":
        """The same graph with its tensors on ``device``."""
        device = canonical_device(device)
        if device == self.device:
            return self
        g = object.__new__(LayeredTannerGraph)
        g.__dict__.update(super().to(device).__dict__)
        g.layer_edges = tuple(t.to(device) for t in self.layer_edges)
        g.layer_vars = tuple(t.to(device) for t in self.layer_vars)
        g._row_perm_t = self._row_perm_t.to(device)
        return g


def bp_decode_layered(
    graph: LayeredTannerGraph,
    syndromes,
    llr0,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
) -> BPResult:
    """Layered-schedule BP; the result contract of ``bp_decode``.

    Outputs are in the original check and variable indexing: the row
    permutation stays inside.  Tensor inputs decide the device.
    """
    device = syndromes.device if torch.is_tensor(syndromes) else graph.device
    synd = as_syndromes(syndromes, graph.m, device)
    return _bp_decode_layered(graph, synd, llr0, bp_method=bp_method, max_iter=max_iter,
                              ms_scaling_factor=ms_scaling_factor)


def _bp_decode_layered(graph: LayeredTannerGraph, synd: torch.Tensor, llr0, *,
                       bp_method: str, max_iter: int, ms_scaling_factor: float) -> BPResult:
    """:func:`bp_decode_layered` of ``synd``, syndromes that
    :func:`~bp_osd_tpu_torch.decoder.bp.as_syndromes` has checked."""
    method = normalize_bp_method(bp_method)
    if max_iter == 0:
        max_iter = graph.n
    device = synd.device
    graph = graph.to(device)
    m, n, wr = graph.m, graph.n, graph.wr
    B = synd.shape[0]
    syn = synd.index_select(1, graph._row_perm_t).to(torch.int32)
    llr0 = as_f32(llr0, device).expand(B, n)
    chk_flat = graph.chk_var.reshape(-1).long()
    chk_mask = graph.chk_mask
    tables = [(lo, hi, graph.chk_var[lo:hi].reshape(-1).long(), e, v)
              for (lo, hi), e, v in zip(graph.layer_bounds, graph.layer_edges, graph.layer_vars)]

    hard = torch.zeros(B, n, dtype=torch.uint8, device=device)
    llr = llr0.clone()
    conv = torch.zeros(B, dtype=torch.bool, device=device)
    iters = torch.zeros(B, dtype=torch.int32, device=device)
    active = torch.arange(B, device=device)
    totals = llr0.clone()
    c2v = torch.zeros(B, m, wr, dtype=torch.float32, device=device)
    zcol = torch.zeros(B, 1, dtype=torch.float32, device=device)

    for it in range(1, max_iter + 1):
        Ba = active.numel()
        if Ba == 0:
            break
        zc = zcol[:Ba]
        alpha = _alpha(ms_scaling_factor, it)
        for lo, hi, var_slots, edges, variables in tables:
            old = c2v[:, lo:hi]
            v2c = (torch.cat([totals, zc], 1).index_select(1, var_slots).view(Ba, hi - lo, wr)
                   - old)
            def on_edges(x):
                return x.reshape(Ba, -1).index_select(1, edges)

            if method == "minimum_sum":
                scale, excl = _min_sum_factors(v2c, chk_mask[lo:hi], syn[:, lo:hi], alpha)
                new = scale * excl
                delta = _fma_f32(on_edges(scale), on_edges(excl), -on_edges(old))
            else:
                new = _check_update_product_sum(v2c, chk_mask[lo:hi], syn[:, lo:hi])
                delta = on_edges(new - old)
            totals = totals.index_add(1, variables, delta)
            c2v[:, lo:hi] = new
        h = (totals <= 0).to(torch.uint8)
        bits = torch.cat([h, zc.to(torch.uint8)], 1).index_select(1, chk_flat).view(Ba, m, wr)
        ok = ((bits.sum(-1, dtype=torch.int32) & 1) == syn).all(-1)
        done = ok if it < max_iter else torch.ones_like(ok)
        if bool(done.any()):
            idx = active[done]
            hard[idx] = h[done]
            llr[idx] = totals[done]
            conv[idx] = ok[done]
            iters[idx] = it
            keep = ~done
            active, totals, c2v, syn = active[keep], totals[keep], c2v[keep], syn[keep]
    return BPResult(hard=hard, llr=llr, converged=conv, iterations=iters)
