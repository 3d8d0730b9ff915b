"""Hand-written CUDA kernels for the decode hot path, and backend selection.

Each kernel lives in ``bp_osd_tpu_torch/csrc/`` and is built by
:mod:`bp_osd_tpu_torch.ops._build` on first use.  Its wrapper launches it for
CUDA tensors, with their card made current for the launch, and uses the
plain torch version, in the matching ``decoder`` module, for CPU tensors:

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

__all__ = ["BACKENDS", "count_launch", "launch_counter", "resolve_backend"]

# one lock for every wrapper's counts and the recorder's: shards on several
# cards launch from several threads, and ``+= 1`` on an attribute is not atomic
_COUNT_LOCK = profiling.COUNT_LOCK

BACKENDS = ("auto", "cuda", "torch")


def resolve_backend(backend: str, device) -> str:
    """Map ``backend`` in :data:`BACKENDS` to ``"cuda"`` or ``"torch"``.

    ``"auto"`` follows ``device``: CUDA tensors always go to the kernels.
    ``"cuda"`` on CPU tensors and ``"torch"`` on CUDA tensors raise; nothing
    falls back to another device or path.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    on_card = torch.device(device).type == "cuda"
    if backend == "cuda" and not on_card:
        raise RuntimeError(
            "backend='cuda' needs the inputs on a CUDA device "
            f"(got {device}; torch.cuda.is_available()="
            f"{torch.cuda.is_available()})"
        )
    if backend == "torch" and on_card:
        raise ValueError(
            "CUDA tensors always go to the kernels: backend='torch' takes CPU "
            "tensors (call the plain *_plain function to run it on the card)"
        )
    return "cuda" if on_card else "torch"


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
