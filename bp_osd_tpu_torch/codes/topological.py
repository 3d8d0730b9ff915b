"""Surface and toric code families via the hypergraph product.

Port of ``bp_osd_tpu/codes/topological.py``: the distance-d surface code is
the hypergraph product of two distance-d repetition codes, the toric code
the product of two ring codes.
"""

from __future__ import annotations

from .classical import rep_code, ring_code
from .hgp import hgp

__all__ = ["surface_code", "toric_code"]


def surface_code(distance: int, compute_distance: bool = False) -> hgp:
    """[[d^2 + (d-1)^2, 1, d]] planar surface code."""
    h = rep_code(distance)
    return hgp(h, h, compute_distance=compute_distance)


def toric_code(distance: int, compute_distance: bool = False) -> hgp:
    """[[2 d^2, 2, d]] toric code (periodic boundaries)."""
    h = ring_code(distance)
    return hgp(h, h, compute_distance=compute_distance)
