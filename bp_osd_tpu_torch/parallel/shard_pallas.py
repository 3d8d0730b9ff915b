"""Batch-sharded calls of a decode function over a device mesh.

Port of ``bp_osd_tpu/parallel/shard_pallas.py``.  JAX's ``shard_map`` runs
one single-device program per device on its slice of the batch; here a shard
is a call of the same Python function on its slice, with its tensors on its
device, so each card launches the same CUDA kernels on its own rows.

- Batched arguments (tensors or numpy arrays, or dicts, lists and tuples of
  them) are split along dim 0 into ``len(mesh)`` equal slices in batch
  order; a batch that does not split evenly raises ``ValueError`` (pad it
  with :func:`~bp_osd_tpu_torch.parallel.mesh.pad_batch`).
- Constants are replicated on each shard's device (:func:`replicate`), once
  per constants object: a call with the same objects as the call before
  reuses the copies.
- Outputs (a tensor, or a dict, list or tuple of them) are joined along
  dim 0 on the mesh's first device, in batch order, as a JAX batch-sharded
  array reads as one array.

Each distinct device of the mesh has one worker thread, started with the
sharded function and kept for its life; a call hands every worker the
shards of its device, run in turn, so shards on distinct cards run at once
(the pipeline synchronises with the host at each stage: shards issued in
turn from one thread would serialise the cards).  A worker thread does not
change the current card; each kernel wrapper makes its tensors' card
current for its launch.  A shard's exception reaches the caller once every
worker has finished; nothing is retried elsewhere.

The workers share one interpreter, so the shards' host work (the
pipeline's small ops and syncs) runs one thread at a time: the mesh pays
only where each shard's device time outweighs it.
"""

from __future__ import annotations

import weakref
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

__all__ = ["replicate", "shard_batch_fn", "shard_decode_fn"]


def _zip_map(fn, trees: list):
    """``fn`` of the leaves at each position of same-shaped trees (dicts,
    lists, tuples and NamedTuples; anything else is a leaf)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _zip_map(fn, [x[k] for x in trees]) for k in t}
    if isinstance(t, (list, tuple)):
        parts = [_zip_map(fn, list(xs)) for xs in zip(*trees)]
        return type(t)(*parts) if hasattr(t, "_fields") else type(t)(parts)
    return fn(trees)


def _map(fn, tree):
    return _zip_map(lambda xs: fn(xs[0]), [tree])


def replicate(tree, device: torch.device):
    """``tree`` on ``device``: numpy arrays become tensors there, tensors and
    any object with a ``to(device)`` method (a
    :class:`~bp_osd_tpu_torch.decoder.tanner.TannerGraph`) are moved, and
    other leaves (numbers, strings, None) are kept."""

    def leaf(x):
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x, device=device)
        if callable(getattr(x, "to", None)):
            return x.to(device)
        return x

    return _map(leaf, tree)


def _split(tree, n: int) -> list:
    """The ``n`` row slices of every batched leaf, as ``n`` trees."""

    def rows(x, k):
        x = torch.as_tensor(x)
        B = x.shape[0]
        if B % n:
            raise ValueError(f"a batch of {B} rows does not split evenly over a mesh of {n} "
                             f"(pad it to a multiple with pad_batch)")
        return x[k * (B // n):(k + 1) * (B // n)]

    return [_map(lambda x: rows(x, k), tree) for k in range(n)]


def _join(outs: list, device: torch.device):
    """Per-shard outputs joined along dim 0 on ``device``, in shard order."""
    return _zip_map(lambda xs: None if xs[0] is None
                    else torch.cat([x.to(device) for x in xs]), outs)


class _Workers:
    """One worker thread for each distinct device of ``devices`` (a single
    thread's executor, whose thread starts at the first call and stays);
    :meth:`run` gives each worker its device's shards."""

    def __init__(self, devices):
        groups: dict[torch.device, list[int]] = {}
        for k, dev in enumerate(devices):
            groups.setdefault(dev, []).append(k)
        self.groups = list(groups.values())
        self._pools = [ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"shard-{dev}")
                       for dev in groups]
        weakref.finalize(self, _shutdown, self._pools)

    def run(self, work) -> list:
        """``work(k)`` for every shard ``k``, in turn within a device's group
        and the groups at once.  Results in shard order; every group is
        waited for before the first failing group's exception propagates."""
        results = [None] * sum(len(g) for g in self.groups)

        def run(group):
            for k in group:
                results[k] = work(k)

        futures = [pool.submit(run, g) for pool, g in zip(self._pools, self.groups)]
        wait(futures)
        for f in futures:
            f.result()
        return results


def _shutdown(pools) -> None:
    for pool in pools:
        pool.shutdown(wait=False)


class _Replicas:
    """Each shard's copy of a tuple of constants, made again only when an
    object differs (by identity) from the call before."""

    def __init__(self, mesh):
        self._mesh = mesh
        self._key: tuple | None = None
        self._copies: list = []

    def __call__(self, consts: tuple) -> list:
        if (self._key is None or len(consts) != len(self._key)
                or any(a is not b for a, b in zip(consts, self._key))):
            by_dev = {d: replicate(consts, d) for d in dict.fromkeys(self._mesh.devices)}
            self._key, self._copies = consts, [by_dev[d] for d in self._mesh.devices]
        return self._copies


def _sharded(fn, mesh, n_const_args: int, axis: str):
    if axis != mesh.axis_name:
        raise ValueError(f"axis {axis!r} is not the mesh's axis {mesh.axis_name!r}")
    replicas = _Replicas(mesh)
    workers = _Workers(mesh.devices)

    def call(*args):
        consts = replicas(args[:n_const_args])
        parts = _split(args[n_const_args:], len(mesh))

        def work(k):
            batched = replicate(parts[k], mesh.devices[k])
            return fn(*consts[k], *batched)

        return _join(workers.run(work), mesh.devices[0])

    return call


def shard_batch_fn(batch_fn, mesh, axis: str = "data"):
    """``batch_fn(batch [B, ...], consts) -> [B, ...]`` with the batch split
    over ``mesh`` and ``consts`` replicated on every shard's device; the
    returned function takes ``(batch, consts)`` and joins the shards'
    outputs in batch order."""
    run = _sharded(lambda consts, batch: batch_fn(batch, consts), mesh, 1, axis)
    return lambda batch, consts: run(consts, batch)


def shard_decode_fn(decode_fn, mesh, axis: str = "data", n_const_args: int = 0):
    """``decode_fn(*consts, *batched)`` with the first ``n_const_args``
    arguments replicated on every shard's device and the rest split over
    ``mesh`` in batch order; outputs joined in batch order."""
    return _sharded(decode_fn, mesh, n_const_args, axis)
