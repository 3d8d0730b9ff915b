"""Device mesh and batch-sharded decoding.

Port of ``bp_osd_tpu/parallel/mesh.py``.  A :class:`Mesh` is an ordered tuple
of devices along one named axis, the counterpart of a 1D
``jax.sharding.Mesh``: :func:`make_mesh` takes the first cards,
:func:`cpu_mesh` builds ``n`` shards on the CPU (the counterpart of the
virtual CPU devices the JAX tests run on; nothing picks it in place of a
card).  :class:`Mesh2D` is a ``data x model`` grid of devices with named
axes, the counterpart of ``Mesh(devices.reshape(data, model), ("data",
"model"))``: the model-parallel decoders (``edge_shard.py``,
``lifted_shard.py``, ``large_code.py``) split the checks over its model
axis and the batch over its data axis; :func:`make_mesh_2d` takes the first
``data * model`` cards, :func:`cpu_mesh_2d` builds CPU shards.
:func:`sharded_decode_fn` splits the syndrome batch over the mesh:
each shard runs BP and OSD on its own device with no traffic between
devices, through the CUDA kernels on a card (K1, then the OSD kernel
``osd_route`` picks) and their plain torch versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..decoder.bp import _bp_decode, as_syndromes
from ..decoder.osd import _osd_decode, build_osd_consts
from ..decoder.tanner import TannerGraph, canonical_device
from .shard_pallas import replicate, shard_decode_fn

__all__ = ["Mesh", "Mesh2D", "cpu_mesh", "cpu_mesh_2d", "make_mesh", "make_mesh_2d", "pad_batch",
           "sharded_decode_fn"]


@dataclass(frozen=True)
class Mesh:
    """The devices of a batch-sharded decode, in shard order, along the axis
    ``axis_name``.  A device may repeat: its shards run in turn."""

    devices: tuple
    axis_name: str = "data"

    def __post_init__(self):
        object.__setattr__(self, "devices", _checked(self.devices))

    def __len__(self) -> int:
        return len(self.devices)


def _checked(devices) -> tuple:
    devices = tuple(canonical_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    bad = [d for d in devices if d.type not in ("cpu", "cuda")]
    if bad:
        raise ValueError(f"a mesh holds CPU and CUDA devices, got {bad}")
    return devices


@dataclass(frozen=True)
class Mesh2D:
    """A ``data x model`` grid of devices with named axes, row-major: the
    device of index ``(i, j)`` along ``axis_names`` is ``devices[i *
    shape[1] + j]``.  A device may repeat (two model shards on one card run
    in turn); nothing puts a shard on the CPU that was asked for a card."""

    devices: tuple
    shape: tuple
    axis_names: tuple = ("data", "model")

    def __post_init__(self):
        devices = _checked(self.devices)
        shape = tuple(int(k) for k in self.shape)
        names = tuple(self.axis_names)
        if len(shape) != 2 or min(shape) < 1 or shape[0] * shape[1] != len(devices):
            raise ValueError(f"a {shape} mesh needs {shape[0] * shape[1]} devices, "
                             f"got {len(devices)}")
        if len(names) != 2 or names[0] == names[1]:
            raise ValueError(f"a 2D mesh needs two distinct axis names, got {names}")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axis_names", names)

    def __len__(self) -> int:
        return len(self.devices)

    def size(self, axis: str) -> int:
        """The length of the axis named ``axis``."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not one of the mesh's {self.axis_names}")
        return self.shape[self.axis_names.index(axis)]

    def groups(self, axis: str) -> list[tuple]:
        """The devices along the other axis, one tuple for each index of
        ``axis``: with ``axis`` the data axis, each data group's model
        shards in order."""
        self.size(axis)
        rows, cols = self.shape
        grid = [self.devices[i * cols:(i + 1) * cols] for i in range(rows)]
        return grid if axis == self.axis_names[0] else [tuple(c) for c in zip(*grid)]

    def flat(self) -> Mesh:
        """Every device in order along one axis, named by both."""
        return Mesh(self.devices, ",".join(self.axis_names))


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


def make_mesh_2d(data: int, model: int, axis_names=("data", "model")) -> Mesh2D:
    """A ``data x model`` mesh over the first ``data * model`` CUDA cards,
    row-major.  Raises ``ValueError`` when fewer cards exist; a mesh of CPU
    shards is :func:`cpu_mesh_2d`, built explicitly, and a mesh that puts
    several shards on one card is a :class:`Mesh2D` of repeated devices."""
    want, count = int(data) * int(model), torch.cuda.device_count()
    if want < 1 or want > count:
        raise ValueError(f"requested a {data} x {model} mesh of {want} CUDA devices but "
                         f"{count} available (a mesh of CPU shards is cpu_mesh_2d)")
    return Mesh2D(tuple(torch.device("cuda", i) for i in range(want)), (data, model),
                  axis_names)


def cpu_mesh_2d(data: int, model: int, axis_names=("data", "model")) -> Mesh2D:
    """A ``data x model`` mesh of shards on the CPU, run in turn."""
    return Mesh2D((torch.device("cpu"),) * (int(data) * int(model)), (data, model), axis_names)


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
    here, once.  The syndromes are checked once, before they are split.
    """
    consts = build_osd_consts(graph, osd_method, osd_order)
    copies = {d: (graph.to(d), replicate(consts, d)) for d in dict.fromkeys(mesh.devices)}

    def shard(syndromes, llr0):
        graph_k, consts_k = copies[syndromes.device]
        bp = _bp_decode(graph_k, syndromes, llr0, bp_method=bp_method, max_iter=max_iter,
                        ms_scaling_factor=ms_scaling_factor)
        osd = _osd_decode(graph_k, syndromes, bp.llr, osd_method=osd_method,
                          osd_order=osd_order, consts=consts_k, skip=bp.converged)
        keep = bp.converged[:, None]
        return (torch.where(keep, bp.hard, osd.osdw), torch.where(keep, bp.hard, osd.osd0),
                bp.hard, bp.converged)

    run = shard_decode_fn(shard, mesh, axis_name)

    def decode(syndromes, llr0):
        device = syndromes.device if torch.is_tensor(syndromes) else torch.device("cpu")
        return run(as_syndromes(syndromes, graph.m, device), llr0)

    return decode
