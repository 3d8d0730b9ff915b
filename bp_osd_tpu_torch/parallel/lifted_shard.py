"""Block-row-sharded BP for protograph-lifted codes.

Port of ``bp_osd_tpu/parallel/lifted_shard.py``.  The protograph's block
rows are split into contiguous chunks, one a model shard; circulant blocks
never straddle shards.  The JAX package serves every TPU with one SPMD
program (rolled pair stacks and a 0/1 routing tensor contracted on the
matrix unit); here each shard is its own call, so each shard routes its own
block rows with index tables cut from :class:`LiftedGraph`'s (one
``index_select`` a step), and the outputs are what is ported, not the form.

The variable sum follows ``edge_shard.py``'s chain.  The unsharded lifted
BP adds a variable's messages block row ``I`` outer, slot ``s`` inner,
starting from +0.0 (``decoder/lifted_bp.py:_bp_rows``), so its running sum
is never -0.0 and adding a -0.0 pad leaves it unchanged.  A block-row
partition keeps that order: shard ``d`` continues shard ``d - 1``'s running
``[B, n]`` sum over its own block rows, and the result equals
``bp_decode_lifted`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decoder.bp import as_syndromes, normalize_bp_method
from ..decoder.lifted_bp import LiftedGraph, _bp_decode_lifted
from .edge_shard import ChainBP, ChainPlan, check_mesh, lane_table, make_shard
from .mesh import Mesh, Mesh2D
from .shard_pallas import shard_decode_fn

__all__ = ["ShardedLiftedGraph", "lifted_sharded_bp_fn"]


class ShardedLiftedGraph:
    """Contiguous block-row partition of a :class:`LiftedGraph`.

    Device ``d`` owns protograph rows ``[d * mp_chunk, (d + 1) * mp_chunk)``,
    empty pad rows at the end.  ``pairs`` lists the distinct ``(variable
    block J, shift e)`` of the protograph's edges, sorted, as the JAX
    partition keeps them.
    """

    def __init__(self, lgraph: LiftedGraph, n_shards: int):
        self.lg = lgraph
        self.n_shards = int(n_shards)
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be positive, got {n_shards}")
        self.mp_chunk = -(-lgraph.mp // self.n_shards)
        self.pairs = sorted({(J, e) for row in lgraph.edges for (J, e) in row})

    def route(self) -> tuple[np.ndarray, np.ndarray]:
        """The JAX partition's ``route [D, P, wr, mp_chunk]`` (1 where local
        row ``i``'s slot ``s`` on shard ``d`` is ``pairs[p]``) and ``chk_mask
        [D, wr, mp_chunk, 1, 1]``, for :meth:`from_reference`."""
        D, mpc, wr = self.n_shards, self.mp_chunk, self.lg.wr
        pidx = {p: i for i, p in enumerate(self.pairs)}
        route = np.zeros((D, max(len(self.pairs), 1), wr, mpc), np.float32)
        mask = np.zeros((D, wr, mpc, 1, 1), np.bool_)
        for I, row in enumerate(self.lg.edges):
            d, il = divmod(I, mpc)
            for s, pair in enumerate(row):
                route[d, pidx[pair], s, il] = 1.0
                mask[d, s, il] = True
        return route, mask

    @classmethod
    def from_reference(cls, fields: dict, device=None) -> "ShardedLiftedGraph":
        """The partition of a JAX ``ShardedLiftedGraph``: ``fields`` holds
        ``lg`` (a JAX ``LiftedGraph``'s fields, see
        :meth:`LiftedGraph.from_reference`), ``n_shards``, ``mp_chunk``,
        ``pairs``, ``route`` and ``chk_mask``; each must equal what this class
        computes, else ``ValueError``."""
        g = cls(LiftedGraph.from_reference(fields["lg"], device), int(fields["n_shards"]))
        if int(fields["mp_chunk"]) != g.mp_chunk:
            raise ValueError(f"reference mp_chunk={fields['mp_chunk']} differs from the "
                             f"port's {g.mp_chunk}")
        if [(int(J), int(e)) for J, e in fields["pairs"]] != g.pairs:
            raise ValueError("reference field 'pairs' differs from the port's")
        for name, mine in zip(("route", "chk_mask"), g.route()):
            if not np.array_equal(np.asarray(fields[name]), mine):
                raise ValueError(f"reference field {name!r} differs from the port's")
        return g

    def __repr__(self) -> str:
        return (f"ShardedLiftedGraph(mp={self.lg.mp}, L={self.lg.L}, "
                f"n_shards={self.n_shards}, mp_chunk={self.mp_chunk})")


def _lifted_plan(sg: ShardedLiftedGraph, groups) -> ChainPlan:
    """Each shard's rows of ``chk_var`` and its block rows' columns of
    ``var_edge``, in the unsharded (I, s) order; one lane from +0.0."""
    lg = sg.lg
    L, wr, n, mp, mpc = lg.L, lg.wr, lg.n, lg.mp, sg.mp_chunk
    chk = lg.chk_var.cpu().numpy().reshape(mp, L * wr)
    chk = np.concatenate([chk, np.full((sg.n_shards * mpc - mp, L * wr), n)])
    ve = lg.var_edge.cpu().numpy().reshape(n, lg.depth)
    real = ve != lg.m * wr
    var = np.broadcast_to(np.arange(n)[:, None], ve.shape)[real]
    edge = ve[real]  # per variable in (I, s) order, row-major
    block_row = edge // (L * wr)
    tables = []
    for d in range(sg.n_shards):
        own = block_row // mpc == d
        lo = d * mpc * L * wr
        tables.append(lane_table(np.stack([var[own], edge[own] - lo], 1), n, mpc * L * wr))
    shards = [[make_shard(dev, chk[d * mpc:(d + 1) * mpc].reshape(mpc * L, wr), [tables[d]], n)
               for d, dev in enumerate(devs)] for devs in groups]
    return ChainPlan(shards, 0.0, None)


def lifted_sharded_bp_fn(
    sgraph: ShardedLiftedGraph,
    mesh: Mesh2D,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """Build a lifted BP decode with protograph block rows sharded over
    ``model_axis`` and the batch over ``data_axis``.

    Returns ``decode(syndromes_pad [B, n_shards * mp_chunk * L], llr0
    [B, n]) -> (hard [B, n] uint8, llr [B, n] f32, converged [B] bool,
    iterations [B] int32)`` on the mesh's first device; zero-pad the
    syndromes of the empty block rows.  With one shard it is
    ``bp_decode_lifted`` on each data group, as in the JAX package.
    """
    method = normalize_bp_method(bp_method)
    lg = sgraph.lg
    max_iter = int(max_iter) or lg.n
    groups = check_mesh(mesh, sgraph.n_shards, data_axis, model_axis)
    if sgraph.n_shards == 1:
        copies = {d: lg.to(d) for d in dict.fromkeys(mesh.devices)}

        def local(synd, llr0):
            return tuple(_bp_decode_lifted(copies[synd.device], synd, llr0, bp_method=method,
                                           max_iter=max_iter,
                                           ms_scaling_factor=ms_scaling_factor))

        run = shard_decode_fn(local, Mesh(tuple(g[0] for g in groups), data_axis), data_axis)

        def decode(syndromes_pad, llr0):  # one shard: no pad rows, m columns
            device = (syndromes_pad.device if torch.is_tensor(syndromes_pad)
                      else torch.device("cpu"))
            return run(as_syndromes(syndromes_pad, lg.m, device, "syndromes_pad"), llr0)

        return decode
    return ChainBP(_lifted_plan(sgraph, groups), mesh, lg.n, method=method, max_iter=max_iter,
                   ms_scaling_factor=ms_scaling_factor).decode
