"""End-to-end decode for large codes: model-sharded BP, then gather-to-DP OSD.

Port of ``bp_osd_tpu/parallel/large_code.py``.  BP runs with its message
state sharded over the mesh's model axis (``edge_shard.py`` or
``lifted_shard.py``).  Its outputs per row, the posterior LLRs ``[B, n]``,
are small next to the message state, so OSD then runs data-parallel over
every device of the mesh: the batch is split over the flattened ``data x
model`` devices (``shard_pallas.shard_decode_fn``) and each device runs
``osd_decode`` on its own rows, skipping the rows BP decoded.  On a card
that is the kernel :func:`~bp_osd_tpu_torch.decoder.osd.osd_route` picks:
K2 (``osd_cs.cu``), or K5 (``osd_large.cu``) for codes whose matrix K2's
shared memory cannot hold, K3 for osd_e and K4 for osd0.
"""

from __future__ import annotations

import torch

from ..decoder.osd import _osd_decode, build_osd_consts
from ..decoder.tanner import TannerGraph, resolve_backend
from .edge_shard import ShardedTannerGraph, edge_sharded_bp_fn
from .lifted_shard import ShardedLiftedGraph, lifted_sharded_bp_fn
from .mesh import Mesh2D
from .shard_pallas import replicate, shard_decode_fn

__all__ = ["edge_sharded_bposd_fn", "lifted_sharded_bposd_fn"]


def _build_osd_stage(graph: TannerGraph, consts, mesh: Mesh2D, *, osd_method, osd_order):
    """``stage(synd [B, m], llr [B, n], converged [B]) -> osdw [B, n]`` with
    the batch split over every device of ``mesh``.  The graph and the OSD
    tables are copied to each device here, once."""
    copies = {d: (graph.to(d), replicate(consts, d)) for d in dict.fromkeys(mesh.devices)}

    def local(synd, llr, conv):
        graph_k, consts_k = copies[synd.device]
        return _osd_decode(graph_k, synd, llr, osd_method=osd_method, osd_order=osd_order,
                           consts=consts_k, skip=conv).osdw

    flat = mesh.flat()
    return shard_decode_fn(local, flat, flat.axis_name)


def _bposd(bp, osd_stage, m: int, devices: int):
    def decode(syndromes_pad, llr0):
        B = len(syndromes_pad)
        if B % devices:
            raise ValueError(f"a batch of {B} rows does not split evenly over the mesh's "
                             f"{devices} devices (pad it to a multiple with pad_batch)")
        hard, llr, conv = bp(syndromes_pad, llr0)[:3]  # checks the syndromes once
        synd = torch.as_tensor(syndromes_pad)[:, :m].to(torch.uint8)
        osdw = osd_stage(synd, llr, conv)
        return torch.where(conv[:, None], hard, osdw), conv

    return decode


def edge_sharded_bposd_fn(
    sgraph: ShardedTannerGraph,
    mesh: Mesh2D,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    osd_method: str = "osd_cs",
    osd_order: int = 0,
    data_axis: str = "data",
    model_axis: str = "model",
    osd_backend: str = "auto",
):
    """Build ``decode(syndromes_pad [B, n_shards * m_chunk], llr0 [B, n]) ->
    (osdw [B, n] uint8, converged [B] bool)`` on the mesh's first device.

    BP is :func:`edge_sharded_bp_fn`; OSD reads the first ``m`` syndrome
    columns, split over every device of the mesh, so ``B`` must divide by
    ``len(mesh)``.  Converged rows keep BP's decision.  ``osd_backend`` is
    the port's name for JAX's, checked here against every device of the
    mesh: ``"auto"``, ``"cuda"`` (JAX's ``"pallas"``; raises on a CPU device)
    or ``"torch"`` (JAX's ``"xla"``; raises on a card)."""
    for d in dict.fromkeys(mesh.devices):
        resolve_backend(osd_backend, d)
    graph = TannerGraph(sgraph.H, "cpu")  # copied to each device by the OSD stage
    consts = build_osd_consts(graph, osd_method, osd_order)
    bp = edge_sharded_bp_fn(sgraph, mesh, bp_method=bp_method, max_iter=max_iter,
                            ms_scaling_factor=ms_scaling_factor, data_axis=data_axis,
                            model_axis=model_axis)
    stage = _build_osd_stage(graph, consts, mesh, osd_method=osd_method, osd_order=osd_order)
    return _bposd(bp, stage, sgraph.m, len(mesh))


def lifted_sharded_bposd_fn(
    lgraph,
    H,
    mesh: Mesh2D,
    *,
    n_shards: int,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    osd_method: str = "osd_cs",
    osd_order: int = 0,
    data_axis: str = "data",
    model_axis: str = "model",
    osd_backend: str = "auto",
):
    """End-to-end decode of a lifted-product code: block-row-sharded BP
    (:func:`lifted_sharded_bp_fn` over ``n_shards`` model shards), then the
    gather-to-DP OSD.  ``H`` is the binary lift of ``lgraph``, read only by
    the OSD stage.  Returns ``decode(syndromes_pad [B, n_shards * mp_chunk *
    L], llr0 [B, n]) -> (osdw [B, n] uint8, converged [B] bool)``; ``osd_backend``
    as :func:`edge_sharded_bposd_fn` checks it."""
    for d in dict.fromkeys(mesh.devices):
        resolve_backend(osd_backend, d)
    graph = TannerGraph(H, "cpu")  # copied to each device by the OSD stage
    consts = build_osd_consts(graph, osd_method, osd_order)
    bp = lifted_sharded_bp_fn(ShardedLiftedGraph(lgraph, n_shards), mesh, bp_method=bp_method,
                              max_iter=max_iter, ms_scaling_factor=ms_scaling_factor,
                              data_axis=data_axis, model_axis=model_axis)
    stage = _build_osd_stage(graph, consts, mesh, osd_method=osd_method, osd_order=osd_order)
    return _bposd(bp, stage, lgraph.m, len(mesh))
