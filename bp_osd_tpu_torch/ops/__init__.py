"""Hand-written CUDA kernels for the decode hot path.

Each kernel lives in ``bp_osd_tpu_torch/csrc/`` and is built by
:mod:`bp_osd_tpu_torch.ops._build` on first use.  Its wrapper takes CUDA
tensors only and launches it with their card made current; tensors on any
other device raise ``ValueError`` (:func:`require_cuda`) before anything is
launched.  The layering is one-way: :mod:`bp_osd_tpu_torch.decoder` picks,
by the tensors' device, a wrapper here or the plain torch version beside its
algorithm, and this package imports from it only the graph types and the
``Elimination`` record:

- :mod:`.cuda_bp` ``bp_flood``: K1, flooding BP (``csrc/bp_flood.cu``);
- :mod:`.cuda_osd` ``osd_cs`` and ``osd_e``: K2 and K3, osd0/osd_cs and
  osd_e (``csrc/osd_cs.cu``);
- :mod:`.cuda_gf2` ``eliminate``: K4, the GF(2) elimination (a warp per
  sample in ``csrc/osd_cs.cu``; a block per sample in ``csrc/gf2_elim.cu``
  for codes above the warp layout);
- :mod:`.cuda_osd_large` ``osd_large``: K5, osd0/osd_cs for codes above a
  block's shared memory (``csrc/osd_large.cu``);
- :mod:`.cuda_lifted_bp` ``bp_lifted``: K6, the whole shift-routed BP
  decode of a lifted-product batch in one launch (``csrc/bp_lifted.cu``; it
  replaces the JAX package's XLA ``while_loop``, not a Pallas kernel).

The check-node rules K1 and K6 share are in ``csrc/bp_check.cuh``.

Each wrapper counts its launches in ``<wrapper>.launches`` and, by card
index, in ``<wrapper>.launches_on`` (:func:`count_launch`); while the
recorder of :mod:`bp_osd_tpu_torch.utils.profiling` is on, also in its
counter ``launches.<wrapper>``.
"""

from __future__ import annotations

import collections

import torch

from ..utils import profiling

__all__ = ["count_launch", "launch_counter", "require_cuda"]

# one lock for every wrapper's counts and the recorder's: shards on several
# cards launch from several threads, and ``+= 1`` on an attribute is not atomic
_COUNT_LOCK = profiling.COUNT_LOCK


def require_cuda(name: str, device: torch.device) -> None:
    """Raise ``ValueError`` unless ``device`` is a CUDA device: a wrapper
    takes card tensors only, and launches and counts nothing on others."""
    if device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {device}; the plain torch "
                         "versions in bp_osd_tpu_torch.decoder run on the others")


def launch_counter(wrapper):
    """Give ``wrapper`` its launch counts at 0: ``launches`` and
    ``launches_on``, a :class:`collections.Counter` by card index."""
    wrapper.launches = 0
    wrapper.launches_on = collections.Counter()
    return wrapper


def count_launch(wrapper, device: torch.device, *also: str) -> None:
    """Add one launch on ``device`` to ``wrapper.launches``, to
    ``wrapper.launches_on[device.index]`` and to each attribute named in
    ``also``, under one lock, so the counts stay exact when shards launch
    from several threads; while the recorder is on, also to its counter
    ``launches.<wrapper>``."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.launches_on[device.index] += 1
        for name in also:
            setattr(wrapper, name, getattr(wrapper, name) + 1)
    profiling.count("launches." + wrapper.__name__)
