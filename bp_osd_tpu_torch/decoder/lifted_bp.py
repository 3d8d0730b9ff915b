"""Shift-routed BP for protograph-lifted (block-circulant) codes.

Port of ``bp_osd_tpu/decoder/lifted_bp.py``.  A lifted-product matrix
(``codes/lifted_product.py``) is described by a small protograph of cyclic
shift exponents over ``F2[x]/(x^L - 1)``:

    H[(I, l), (J, l')] = 1  iff  l' = (l + e) mod L for some e in proto[I][J]

so every message route is a static cyclic shift of a length-L block.  The
JAX package applies one ``jnp.roll`` per (block row, slot) and keeps the
batch on the TPU's lanes (``[.., L, B]``).  Here the rolls are stacked once,
at construction, into two routing tables (``chk_var``: edge -> variable, and
``var_edge``: variable -> its edges), each column of which is
``torch.roll(arange(L), shift)`` offset into its block, so one
``index_select`` performs all of a step's rolls: three launches per
iteration instead of three per (block row, slot), of which the
[[10000,420]] code has 84.  The message layout is batch-major ``[B, m, wr]``
(checks in the natural ``(I, l)`` order, slots in protograph edge order), so
rows leave the working set with one row gather as they converge, and the
check update is the dense path's own code.  That loop, :func:`_bp_rows`, is
the plain version of kernel K6 (``csrc/bp_lifted.cu``), which runs the whole
decode of a batch in one launch: :func:`_bp_decode_lifted` sends CUDA
tensors to K6 (:func:`bp_osd_tpu_torch.ops.cuda_lifted_bp.bp_lifted`), others
to :func:`_bp_rows`.  K6 routes by the protograph instead of the index
tables: ``slot_table`` gives slot ``s`` of block row ``I`` as ``(J, e)``, and
``block_edges`` lists the ``(I, s, e)`` of variable block ``J``'s edges in
the order ``var_edge`` sums them.  The JAX package computes this decode in
XLA, as one ``jax.lax.while_loop``, outside any Pallas kernel.

Semantics kept exactly from the JAX package:

- a variable adds its incoming messages block row ``I`` outer, slot ``s``
  inner, starting from zeros, then ``total = llr0 + sum`` and
  ``v2c = total[var of edge] - c2v``;
- min-sum: first-minimum tie rule, 1e30 cap, sign product before
  ``alpha * excl_min``, adaptive ``alpha = 1 - 2^-it``; product-sum clip at
  1 - 1e-7;
- freeze at first convergence, ``max_iter = 0`` means ``n``, and the loop
  ends once every row has converged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from .bp import (
    BPResult,
    _alpha,
    _check_update_min_sum,
    _check_update_product_sum,
    as_f32,
    as_syndromes,
    normalize_bp_method,
)
from .tanner import canonical_device, resolve_device

__all__ = ["LiftedGraph", "bp_decode_lifted"]

# message floats of one [rows, m * wr] tensor per call: ~256 MB, about a
# dozen such tensors live at once (1997 rows of the [[10000,420]] code)
_MSG_BUDGET = 1 << 26


def _route_tables(edges, np_: int, wr: int, depth: int) -> tuple[np.ndarray, np.ndarray]:
    """K6's routing tables of a protograph whose block row ``I`` has the
    slots ``edges[I]`` (``(J, e mod L)`` each): ``slot_table [mp, wr, 2]``
    int32, the ``(J, e)`` of each slot, ``(-1, 0)`` on pad slots; and
    ``block_edges [np_, depth, 3]`` int32, for each variable block ``J`` the
    ``(I, s, e)`` of its edges, ``I`` outer and ``s`` inner, ``(-1, 0, 0)``
    on pads."""
    slots = np.zeros((len(edges), wr, 2), np.int32)
    slots[..., 0] = -1
    blocks = np.zeros((np_, depth, 3), np.int32)
    blocks[..., 0] = -1
    fill = [0] * np_
    for I, row in enumerate(edges):
        for s, (J, e) in enumerate(row):
            slots[I, s] = (J, e)
            blocks[J, fill[J]] = (I, s, e)
            fill[J] += 1
    return slots, blocks


class LiftedGraph:
    """Routing tables of a protograph lift on ``device``.

    ``proto`` is a nested list of exponent tuples as stored by
    ``codes.lifted_product.lifted_hgp`` in ``.hx_proto`` / ``.hz_proto``.
    ``edges[I]`` lists ``(J, e mod L)`` per slot of block row ``I``;
    ``chk_mask [wr, mp, 1, 1]`` (numpy) is the JAX package's slot mask.
    ``chk_var``/``var_edge`` route :func:`_bp_rows`; ``slot_table`` and
    ``block_edges`` (:func:`_route_tables`) route kernel K6.
    ``device`` defaults as :class:`TannerGraph`'s does: the card when there
    is one.
    """

    _TENSORS = ("chk_var", "edge_mask", "var_edge", "slot_table", "block_edges")

    def __init__(self, proto, lift: int, device=None):
        self.proto = [[tuple(int(e) for e in ent) for ent in row] for row in proto]
        self.L = L = int(lift)
        self.mp = len(proto)
        self.np_ = len(proto[0]) if self.mp else 0
        self.m, self.n = self.mp * L, self.np_ * L
        self.edges = [[(J, e % L) for J, exps in enumerate(row) for e in exps]
                      for row in self.proto]
        self.wr = max((len(e) for e in self.edges), default=1)
        mask = np.zeros((self.wr, self.mp, 1, 1), np.bool_)
        for I, row in enumerate(self.edges):
            mask[: len(row), I] = True
        self.chk_mask = mask
        self.device = resolve_device(device)

        m, n, wr = self.m, self.n, self.wr
        ar = torch.arange(L)
        chk_var = torch.full((self.mp, L, wr), n, dtype=torch.int64)
        into = [[] for _ in range(self.np_)]  # per var block: edge-id columns
        for I, row in enumerate(self.edges):
            for s, (J, e) in enumerate(row):
                chk_var[I, :, s] = J * L + torch.roll(ar, -e)  # (l + e) mod L
                into[J].append((I * L + torch.roll(ar, e)) * wr + s)  # (l' - e) mod L
        depth = max((len(c) for c in into), default=1)
        var_edge = torch.full((self.np_, L, depth), m * wr, dtype=torch.int64)
        for J, cols in enumerate(into):
            for d, col in enumerate(cols):
                var_edge[J, :, d] = col
        edge_mask = torch.from_numpy(mask[:, :, 0, 0].T.copy())  # [mp, wr]
        self.chk_var = chk_var.reshape(m * wr).to(self.device)
        self.edge_mask = (edge_mask[:, None, :].expand(self.mp, L, wr)
                          .reshape(m, wr).to(self.device))
        self.var_edge = var_edge.reshape(n * depth).to(self.device)
        self.depth = depth
        slots, blocks = _route_tables(self.edges, self.np_, wr, depth)
        self.slot_table = torch.from_numpy(slots).to(self.device)
        self.block_edges = torch.from_numpy(blocks).to(self.device)

    def to(self, device) -> "LiftedGraph":
        """The same graph with its tables on ``device``."""
        device = canonical_device(device)
        if device == self.device:
            return self
        g = object.__new__(LiftedGraph)
        g.__dict__.update(self.__dict__)
        g.device = device
        for f in self._TENSORS:
            setattr(g, f, getattr(self, f).to(device))
        return g

    @classmethod
    def from_reference(cls, fields: dict, device=None) -> "LiftedGraph":
        """Build the graph from a JAX ``LiftedGraph``'s fields.

        ``fields`` holds ``proto`` (the protograph the JAX graph was built
        from), ``L``, ``edges``, ``wr`` and ``chk_mask``; every one but
        ``proto`` must equal what this class computes, else ``ValueError``.
        K6's tables built from the reference's ``edges`` must equal the
        port's too.
        """
        g = cls(fields["proto"], int(fields["L"]), device)
        ref_edges = [[(int(J), int(e)) for J, e in row] for row in fields["edges"]]
        if ref_edges != g.edges:
            raise ValueError("reference field 'edges' differs from the port's")
        if int(fields["wr"]) != g.wr:
            raise ValueError(f"reference wr={fields['wr']} differs from the port's {g.wr}")
        if not np.array_equal(np.asarray(fields["chk_mask"]), g.chk_mask):
            raise ValueError("reference field 'chk_mask' differs from the port's")
        for name, ref in zip(("slot_table", "block_edges"),
                             _route_tables(ref_edges, g.np_, g.wr, g.depth)):
            if not np.array_equal(ref, getattr(g, name).cpu().numpy()):
                raise ValueError(f"K6's {name} from the reference's edges differs from "
                                 "the port's")
        return g

    def __repr__(self) -> str:
        return (f"LiftedGraph(mp={self.mp}, np={self.np_}, L={self.L}, m={self.m}, "
                f"n={self.n}, wr={self.wr}, device={self.device})")


def bp_decode_lifted(
    graph: LiftedGraph,
    syndromes,
    llr0,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
) -> BPResult:
    """Batched flooding BP on a lifted graph; same contract as
    :func:`~bp_osd_tpu_torch.decoder.bp.bp_decode` (``[B, m]`` syndromes with
    checks ordered ``(I, l)``, ``[B, n]`` outputs with variables ``(J, l)``).

    Tensor inputs decide the device.  On a card the whole batch is one
    launch of kernel K6; elsewhere rows are decoded in calls of at most
    ``2^26 / (m * wr)`` rows, so the message tensors stay bounded.
    """
    device = syndromes.device if torch.is_tensor(syndromes) else graph.device
    synd = as_syndromes(syndromes, graph.m, device)
    return _bp_decode_lifted(graph, synd, llr0, bp_method=bp_method, max_iter=max_iter,
                             ms_scaling_factor=ms_scaling_factor)


def _bp_decode_lifted(graph: LiftedGraph, synd: torch.Tensor, llr0, *, bp_method: str,
                      max_iter: int, ms_scaling_factor: float) -> BPResult:
    """:func:`bp_decode_lifted` of ``synd``, syndromes that
    :func:`~bp_osd_tpu_torch.decoder.bp.as_syndromes` has checked."""
    method = normalize_bp_method(bp_method)
    if max_iter == 0:
        max_iter = graph.n
    device = synd.device
    graph = graph.to(device)
    B, n = synd.shape[0], graph.n
    llr0 = as_f32(llr0, device).expand(B, n)
    if device.type == "cuda":
        from ..ops.cuda_lifted_bp import bp_lifted

        if llr0.stride(0) != 0:  # K6 reads one broadcast row or contiguous rows
            llr0 = llr0.contiguous()
        with profiling.span("bp.lifted", rows=B):
            hard, llr, conv, iters = bp_lifted(graph, synd, llr0, method, int(max_iter),
                                               float(ms_scaling_factor))
        return BPResult(hard=hard, llr=llr, converged=conv, iterations=iters)
    rows = max(1, _MSG_BUDGET // (graph.m * graph.wr))
    with profiling.span("bp.lifted", rows=B):
        parts = [_bp_rows(graph, synd[lo : lo + rows], llr0[lo : lo + rows], method,
                          int(max_iter), float(ms_scaling_factor))
                 for lo in range(0, max(B, 1), rows)]
    hard, llr, conv, iters = (torch.cat(xs) if len(xs) > 1 else xs[0] for xs in zip(*parts))
    return BPResult(hard=hard, llr=llr, converged=conv, iterations=iters)


def _bp_rows(graph: LiftedGraph, synd, llr0, method: str, max_iter: int, msf: float):
    """The plain version of kernel K6: ``(hard, llr, converged, iterations)``
    of ``synd [B, m]`` uint8 from ``llr0 [B, n]`` f32, a torch loop of one
    iteration a pass, rows leaving the working set as they converge."""
    dev = synd.device
    B, n, m, wr = synd.shape[0], graph.n, graph.m, graph.wr
    E = m * wr
    mask = graph.edge_mask
    zcol = torch.zeros(B, 1, dtype=torch.float32, device=dev)

    def to_edges(x, zc):  # [Ba, n] -> [Ba, m, wr], pad slots read the zero column
        return torch.cat([x, zc], 1).index_select(1, graph.chk_var).view(-1, m, wr)

    v2c = torch.where(mask, to_edges(llr0, zcol), 0.0)
    hard = torch.zeros(B, n, dtype=torch.uint8, device=dev)
    llr = llr0.clone()
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.arange(B, device=dev)
    syn = synd.to(torch.int32)
    l0 = llr0
    for it in range(1, max_iter + 1):
        Ba = active.numel()
        if Ba == 0:
            break
        if method == "minimum_sum":
            c2v = _check_update_min_sum(v2c, mask, syn, _alpha(msf, it))
        else:
            c2v = _check_update_product_sum(v2c, mask, syn)
        zc = zcol[:Ba]
        inc = torch.cat([c2v.reshape(Ba, E), zc], 1).index_select(1, graph.var_edge)
        inc = inc.view(Ba, n, graph.depth)
        acc = torch.zeros(Ba, n, dtype=torch.float32, device=dev)
        for d in range(graph.depth):  # (I, s) order; a pad adds +0.0 to a sum that is never -0.0
            acc = acc + inc[..., d]
        total = l0 + acc
        v2c = torch.where(mask, to_edges(total, zc) - c2v, 0.0)
        h = (total <= 0).to(torch.uint8)
        parity = to_edges(h, zc.to(torch.uint8)).sum(-1, dtype=torch.int32) & 1
        ok = (parity == syn).all(-1)
        done = ok if it < max_iter else torch.ones_like(ok)
        if bool(done.any()):
            idx = active[done]
            hard[idx] = h[done]
            llr[idx] = total[done]
            conv[idx] = ok[done]
            iters[idx] = it
            keep = ~done
            active, v2c, syn, l0 = active[keep], v2c[keep], syn[keep], l0[keep]
    return hard, llr, conv, iters
