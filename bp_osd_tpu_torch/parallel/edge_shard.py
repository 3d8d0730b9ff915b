"""Edge-sharded BP: the Tanner graph's checks split over a mesh's model axis.

Port of ``bp_osd_tpu/parallel/edge_shard.py``.  For codes whose message
state ``[B, m, wr]`` is too large for one device at high batch, the checks,
and with them the check-major messages, are split into contiguous row
blocks, one a model shard; the batch is split over the data axis.  Each
shard runs the check update of its own checks on its own device.  The
variable update needs each variable's sum over every incident check, which
is the one exchange between shards an iteration; convergence is the AND of
the shards' local parity checks.

The exchange is a chain, not a tree.  The unsharded plain BP
(``decoder/bp.py:_variable_sum``) adds a variable's messages in four lanes
by global flat edge ``e = check * wr + slot``: lane ``e % 4``, each lane in
ascending ``e``, from its first edge, then pad entries of +0.0, and the
lanes combine as ``(p0 + p1) + (p2 + p3)``.  A check-row partition keeps
each variable's edges grouped by shard in ascending ``e``, so shard ``d``
continues the four running lane sums shard ``d - 1`` handed it, adding its
own edges in that order.  The chain starts from -0.0, IEEE's additive
identity (``-0.0 + x`` is ``x``, and ``x + -0.0`` is ``x``, for every
``x``), and a shard's pad entries read a -0.0 column, so a shard without a
variable's edges in a lane passes that lane's sum on unchanged.  After the
last shard, a lane gets the unsharded sum's +0.0 pad (which turns -0.0 into
+0.0) where that sum had one.  The per-variable totals are then copied
back to every shard.  So the sharded BP equals the unsharded
``bp_decode_plain`` bit for bit, and with it kernel K1 on the card;
JAX's ``psum`` tree is equal only to a tolerance.  Floats are never
scattered: ``index_add_`` of floats is unordered on CUDA.

Each iteration queues every shard's work from one thread, data groups in
turn, then reads the host once a group to drop converged rows from every
shard's working set at once.  The model-parallel BP is plain torch, as the
JAX package's is XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import gf2
from ..decoder.bp import (BPResult, _alpha, _check_update_min_sum, _check_update_product_sum,
                          as_f32, as_syndromes, normalize_bp_method)
from .mesh import Mesh2D

__all__ = ["ShardedTannerGraph", "edge_sharded_bp_fn"]


class ShardedTannerGraph:
    """Host-side partition of a PCM's checks into ``n_shards`` row blocks.

    Device ``d`` owns checks ``[d * m_chunk, (d + 1) * m_chunk)``, the last
    shard padded with zero rows.  ``chk_var [D, m_chunk, wr]`` (numpy int32)
    lists each check's variables in ascending order, padded with ``n``;
    ``chk_mask`` marks the real entries.  ``wr`` is the largest row weight.
    """

    _FIELDS = ("m", "n", "n_shards", "m_chunk", "wr", "chk_var", "chk_mask", "H")

    def __init__(self, H, n_shards: int):
        Hd = gf2.to_dense(H)
        m, n = Hd.shape
        D = int(n_shards)
        if D < 1:
            raise ValueError(f"n_shards must be positive, got {n_shards}")
        mc = -(-m // D)
        rows, cols = np.nonzero(Hd)  # row-major: sorted by (row, col)
        counts = np.bincount(rows, minlength=D * mc)
        wr = max(int(counts.max()) if rows.size else 1, 1)
        slot = (np.concatenate([np.arange(c) for c in counts]) if rows.size
                else np.zeros(0, int))
        chk_var = np.full((D * mc, wr), n, dtype=np.int32)
        chk_var[rows, slot] = cols
        self.m, self.n, self.n_shards, self.m_chunk, self.wr = m, n, D, mc, wr
        self.chk_var = chk_var.reshape(D, mc, wr)
        self.chk_mask = self.chk_var != n
        self.H = Hd

    @classmethod
    def from_reference(cls, fields: dict) -> "ShardedTannerGraph":
        """The partition of a JAX ``ShardedTannerGraph``, from its fields
        ``m n n_shards m_chunk wr chk_var chk_mask H`` (numpy and ints).
        Raises ``ValueError`` where a field differs from what this class
        computes from ``H`` and ``n_shards``."""
        g = cls(fields["H"], int(fields["n_shards"]))
        for f in cls._FIELDS:
            if not np.array_equal(np.asarray(fields[f]), np.asarray(getattr(g, f))):
                raise ValueError(f"reference field {f!r} differs from the port's")
        return g

    def __repr__(self) -> str:
        return (f"ShardedTannerGraph(m={self.m}, n={self.n}, n_shards={self.n_shards}, "
                f"m_chunk={self.m_chunk}, wr={self.wr})")


class Shard(NamedTuple):
    """One model shard's tables on its device.

    ``chk [rows * wr]`` maps a local flat edge to its variable, pads to the
    zero column ``n`` of a ``[B, n + 1]`` tensor; ``mask [rows, wr]`` marks
    the real edges; ``lanes[k] [n * depth]`` lists, for each variable, the
    shard's local edges of lane ``k`` in the unsharded sum's order, pads
    pointing at the -0.0 column ``rows * wr``.
    """

    device: torch.device
    chk: torch.Tensor
    mask: torch.Tensor
    lanes: tuple


class ChainPlan(NamedTuple):
    """How the shards of each data group chain one variable sum: the
    groups' shards, the value each lane starts from, and for each group the
    values added to its lanes after the last shard (``[n]`` tensors on the
    last shard's device), or None."""

    groups: list  # [data][model] -> Shard
    start: float
    fixes: list | None  # [data][lane] -> tensor


def lane_table(ids: np.ndarray, n: int, pad: int) -> np.ndarray:
    """``[n, depth]`` table of ``ids [E, 2]`` rows ``(variable, local edge)``,
    each variable's edges in the given order, padded with ``pad``."""
    counts = np.bincount(ids[:, 0], minlength=n)
    depth = int(counts.max()) if ids.size else 0
    order = np.argsort(ids[:, 0], kind="stable")
    slot = (np.concatenate([np.arange(c) for c in counts]) if ids.size
            else np.zeros(0, int))
    table = np.full((n, depth), pad, np.int64)
    table[ids[order, 0], slot] = ids[order, 1]
    return table


def make_shard(device, chk_var: np.ndarray, lanes: list[np.ndarray], n: int) -> Shard:
    """A shard's tables on ``device`` from ``chk_var [rows, wr]`` (pads
    ``n``) and its lane tables ``[n, depth]``."""
    chk = torch.from_numpy(np.ascontiguousarray(chk_var, np.int64))
    return Shard(device, chk.reshape(-1).to(device), (chk != n).to(device),
                 tuple(torch.from_numpy(t.reshape(-1)).to(device) for t in lanes))


def _dense_plan(sg: ShardedTannerGraph, groups) -> ChainPlan:
    """The four-lane chain of the module docstring."""
    D, mc, wr, n = sg.n_shards, sg.m_chunk, sg.wr, sg.n
    d_i, i_i, s_i = np.nonzero(sg.chk_mask)  # ascending global edge
    e = (d_i * mc + i_i) * wr + s_i
    var = sg.chk_var[d_i, i_i, s_i].astype(np.int64)
    local = e - d_i * mc * wr
    tables, fixes = [], []
    for k in range(4):
        lane = e % 4 == k
        tables.append([lane_table(np.stack([var[lane & (d_i == d)], local[lane & (d_i == d)]], 1),
                                  n, mc * wr) for d in range(D)])
        counts = np.bincount(var[lane], minlength=n)
        # the unsharded lane adds +0.0 pads to a variable below its depth
        fixes.append(np.where(counts < max(1, int(counts.max())), 0.0, -0.0).astype(np.float32))
    shards = [[make_shard(dev, sg.chk_var[d], [tables[k][d] for k in range(4)], n)
               for d, dev in enumerate(devs)] for devs in groups]
    return ChainPlan(shards, -0.0, [[torch.from_numpy(f).to(devs[-1]) for f in fixes]
                                    for devs in groups])


def _lane_sum(acc, flat, idx, n: int):
    if idx.numel() == 0:
        return acc
    g = flat.index_select(1, idx).view(flat.shape[0], n, -1)
    for j in range(g.shape[-1]):
        acc = acc + g[..., j]
    return acc


class _Group:
    """One data group's rows: each model shard's messages and syndromes on
    its device, the outputs on the last shard's device."""

    def __init__(self, shards, fixes, start, synd, llr0):
        self.shards, self.fixes, self.start = shards, fixes, start
        home = self.home = shards[-1].device
        B, self.n = llr0.shape
        self.syn, self.v2c, lo = [], [], 0
        for sh in shards:
            rows = sh.mask.shape[0]
            self.syn.append(synd[:, lo:lo + rows].to(sh.device, torch.int32))
            self.v2c.append(torch.where(sh.mask, self._edges(sh, llr0.to(sh.device)), 0.0))
            lo += rows
        self.l0 = llr0.to(home)
        self.hard = torch.zeros(B, self.n, dtype=torch.uint8, device=home)
        self.llr = self.l0.clone()
        self.conv = torch.zeros(B, dtype=torch.bool, device=home)
        self.iters = torch.zeros(B, dtype=torch.int32, device=home)
        self.active = torch.arange(B, device=home)

    @staticmethod
    def _edges(sh: Shard, x):  # [Ba, n] -> [Ba, rows, wr], pad slots read 0
        zc = torch.zeros(x.shape[0], 1, dtype=x.dtype, device=x.device)
        return torch.cat([x, zc], 1).index_select(1, sh.chk).view(-1, *sh.mask.shape)

    def step(self, it: int, method: str, msf: float):
        """Queue one iteration on every shard; keep ``(total, hard, ok)``."""
        Ba, n = self.active.numel(), self.n
        if method == "minimum_sum":
            c2v = [_check_update_min_sum(v, sh.mask, s, _alpha(msf, it))
                   for v, sh, s in zip(self.v2c, self.shards, self.syn)]
        else:
            c2v = [_check_update_product_sum(v, sh.mask, s)
                   for v, sh, s in zip(self.v2c, self.shards, self.syn)]
        dev0 = self.shards[0].device
        p = [torch.full((Ba, n), self.start, device=dev0)] * len(self.shards[0].lanes)
        for sh, c in zip(self.shards, c2v):
            p = [x.to(sh.device) for x in p]
            flat = torch.cat([c.reshape(Ba, -1),
                              torch.full((Ba, 1), -0.0, device=sh.device)], 1)
            p = [_lane_sum(x, flat, idx, n) for x, idx in zip(p, sh.lanes)]
        if self.fixes is not None:
            p = [x + f for x, f in zip(p, self.fixes)]
        total = self.l0 + (p[0] if len(p) == 1 else (p[0] + p[1]) + (p[2] + p[3]))
        ok = None
        for d, (sh, c, s) in enumerate(zip(self.shards, c2v, self.syn)):
            t = total.to(sh.device)
            self.v2c[d] = torch.where(sh.mask, self._edges(sh, t) - c, 0.0)
            parity = self._edges(sh, (t <= 0).to(torch.uint8)).sum(-1, dtype=torch.int32) & 1
            ok_d = (parity == s).all(-1).to(self.home)
            ok = ok_d if ok is None else ok & ok_d
        self._last = (total, (total <= 0).to(torch.uint8), ok)

    def retire(self, it: int, max_iter: int) -> None:
        """Freeze the rows that converged (all rows at ``max_iter``) and drop
        them from every shard's working set."""
        total, h, ok = self._last
        done = ok if it < max_iter else torch.ones_like(ok)
        if bool(done.any()):
            idx = self.active[done]
            self.hard[idx] = h[done]
            self.llr[idx] = total[done]
            self.conv[idx] = ok[done]
            self.iters[idx] = it
            keep = ~done
            self.active, self.l0 = self.active[keep], self.l0[keep]
            for d, sh in enumerate(self.shards):
                k = keep.to(sh.device)
                self.v2c[d], self.syn[d] = self.v2c[d][k], self.syn[d][k]


class ChainBP:
    """A model-sharded BP decode over the groups of ``plan``: ``__call__``
    returns JAX's ``(hard, llr, converged)``, :meth:`decode` a
    :class:`~bp_osd_tpu_torch.decoder.bp.BPResult` with the iterations too,
    on the mesh's first device."""

    def __init__(self, plan: ChainPlan, mesh: Mesh2D, n: int, *, method: str, max_iter: int,
                 ms_scaling_factor: float):
        self.plan, self.n = plan, n
        self.device = mesh.devices[0]
        self.m_pad = sum(sh.mask.shape[0] for sh in plan.groups[0])
        self.method, self.max_iter, self.msf = method, max_iter, float(ms_scaling_factor)

    def decode(self, syndromes_pad, llr0) -> BPResult:
        synd = as_syndromes(syndromes_pad, self.m_pad, self.device, "syndromes_pad")
        B, D = synd.shape[0], len(self.plan.groups)
        if B % D:
            raise ValueError(f"a batch of {B} rows does not split evenly over {D} data groups "
                             f"(pad it to a multiple with pad_batch)")
        llr0 = as_f32(llr0, self.device).expand(B, self.n)
        rows = B // D
        fixes = self.plan.fixes or [None] * D
        groups = [_Group(shards, fixes[g], self.plan.start,
                         synd[g * rows:(g + 1) * rows], llr0[g * rows:(g + 1) * rows])
                  for g, shards in enumerate(self.plan.groups)]
        for it in range(1, self.max_iter + 1):
            live = [g for g in groups if g.active.numel()]
            if not live:
                break
            for g in live:
                g.step(it, self.method, self.msf)
            for g in live:
                g.retire(it, self.max_iter)
        return BPResult(*(torch.cat([getattr(g, f).to(self.device) for g in groups])
                          for f in ("hard", "llr", "conv", "iters")))

    def __call__(self, syndromes_pad, llr0):
        return self.decode(syndromes_pad, llr0)[:3]


def check_mesh(mesh: Mesh2D, n_shards: int, data_axis: str, model_axis: str) -> list[tuple]:
    """The mesh's data groups, each its model shards' devices; raises
    ``ValueError`` unless the model axis has ``n_shards`` devices."""
    if not isinstance(mesh, Mesh2D):
        raise ValueError(f"a model-sharded decode needs a Mesh2D, got {type(mesh).__name__}")
    if data_axis == model_axis:
        raise ValueError(f"data_axis and model_axis are both {data_axis!r}")
    if mesh.size(model_axis) != n_shards:
        raise ValueError(f"the graph has {n_shards} shards but the mesh's {model_axis!r} axis "
                         f"has {mesh.size(model_axis)} devices")
    return mesh.groups(data_axis)


def edge_sharded_bp_fn(
    sgraph: ShardedTannerGraph,
    mesh: Mesh2D,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    data_axis: str = "data",
    model_axis: str = "model",
) -> ChainBP:
    """Build a BP decode with checks sharded over ``model_axis`` and the
    batch over ``data_axis`` (``max_iter == 0`` means ``n``).

    Returns ``decode(syndromes_pad [B, n_shards * m_chunk], llr0 [B, n]) ->
    (hard [B, n] uint8, llr [B, n] f32, converged [B] bool)`` on the mesh's
    first device (``decode.decode`` adds the iterations); zero-pad the
    syndromes of the padded checks.  ``B`` must divide over the data axis.
    The tables are copied to each shard's device here, once.
    """
    groups = check_mesh(mesh, sgraph.n_shards, data_axis, model_axis)
    return ChainBP(_dense_plan(sgraph, groups), mesh, sgraph.n,
                   method=normalize_bp_method(bp_method), max_iter=int(max_iter) or sgraph.n,
                   ms_scaling_factor=ms_scaling_factor)
