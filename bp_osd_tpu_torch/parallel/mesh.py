"""Device mesh and batch-sharded decoding.

Port of ``bp_osd_tpu/parallel/mesh.py``.  A :class:`Mesh` is an ordered tuple
of devices along one named axis, the counterpart of a 1D
``jax.sharding.Mesh``: :func:`make_mesh` takes the first cards,
:func:`cpu_mesh` builds ``n`` shards on the CPU (the counterpart of the
virtual CPU devices the JAX tests run on; nothing picks it in place of a
card).  :func:`sharded_decode_fn` splits the syndrome batch over the mesh:
each shard runs BP and OSD on its own device with no traffic between
devices, through the CUDA kernels on a card (K1, then the OSD kernel
``osd_route`` picks) and their plain torch versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..decoder.bp import bp_decode
from ..decoder.osd import build_osd_consts, osd_decode
from ..decoder.tanner import TannerGraph, canonical_device
from .shard_pallas import replicate, shard_decode_fn

__all__ = ["Mesh", "cpu_mesh", "make_mesh", "pad_batch", "sharded_decode_fn"]


@dataclass(frozen=True)
class Mesh:
    """The devices of a batch-sharded decode, in shard order, along the axis
    ``axis_name``.  A device may repeat: its shards run in turn."""

    devices: tuple
    axis_name: str = "data"

    def __post_init__(self):
        devices = tuple(canonical_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        bad = [d for d in devices if d.type not in ("cpu", "cuda")]
        if bad:
            raise ValueError(f"a mesh holds CPU and CUDA devices, got {bad}")
        object.__setattr__(self, "devices", devices)

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1D mesh over the first ``n_devices`` CUDA cards (all by default).

    Raises ``ValueError`` when fewer cards exist; a mesh of CPU shards is
    :func:`cpu_mesh`, built explicitly."""
    count = torch.cuda.device_count()
    want = count if n_devices is None else int(n_devices)
    if want < 1 or want > count:
        raise ValueError(f"requested {want if n_devices is not None else 'all'} CUDA devices "
                         f"but {count} available (a mesh of CPU shards is cpu_mesh(n))")
    return Mesh(tuple(torch.device("cuda", i) for i in range(want)), axis_name)


def cpu_mesh(n_shards: int, axis_name: str = "data") -> Mesh:
    """A mesh of ``n_shards`` shards on the CPU, run in turn."""
    return Mesh((torch.device("cpu"),) * int(n_shards), axis_name)


def pad_batch(arr: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading axis with zero rows up to a multiple; returns
    ``(padded, original_B)``."""
    B = arr.shape[0]
    pad = (-B) % multiple
    if pad:
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
    return arr, B


def sharded_decode_fn(
    graph: TannerGraph,
    mesh: Mesh,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    osd_method: str = "osd0",
    osd_order: int = 0,
    axis_name: str = "data",
):
    """Build a decode function with the batch axis sharded over ``mesh``.

    Returns ``decode(syndromes [B, m], llr0 [B, n]) -> (osdw [B, n], osd0
    [B, n], bp_hard [B, n], converged [B])`` (uint8, uint8, uint8, bool) on
    the mesh's first device, where B must be divisible by the mesh size (use
    :func:`pad_batch`; broadcast a shared channel prior to ``[B, n]`` at the
    caller).  Converged rows keep BP's decision in ``osdw`` and ``osd0``; OSD
    skips them.  The graph and the OSD tables are copied to each device
    here, once.
    """
    consts = build_osd_consts(graph, osd_method, osd_order)
    copies = {d: (graph.to(d), replicate(consts, d)) for d in dict.fromkeys(mesh.devices)}

    def shard(syndromes, llr0):
        graph_k, consts_k = copies[syndromes.device]
        bp = bp_decode(graph_k, syndromes, llr0, bp_method=bp_method, max_iter=max_iter,
                       ms_scaling_factor=ms_scaling_factor)
        osd = osd_decode(graph_k, syndromes, bp.llr, osd_method=osd_method,
                         osd_order=osd_order, consts=consts_k, skip=bp.converged)
        keep = bp.converged[:, None]
        return (torch.where(keep, bp.hard, osd.osdw), torch.where(keep, bp.hard, osd.osd0),
                bp.hard, bp.converged)

    return shard_decode_fn(shard, mesh, axis_name)
