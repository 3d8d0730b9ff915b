"""The work a decode needs, and the least time an H100 could take for it.

Peaks of one NVIDIA H100 SXM at its 700 W limit: device memory 3.35 TB/s and
float32 67 TFLOP/s outside the tensor cores are NVIDIA's published figures;
the integer rate, 64 INT32 lanes x 132 SMs x 1.98 GHz = 16.73 Tops/s, is
derived from the SM's layout, not published.  A bound is the larger of the
bytes over the memory rate and the operations over their peak (float and
integer work may overlap, so the larger of those two).

The needed work is counted from the decode's inputs and its checked
outputs, never from one implementation's schedule or state:

- BP: each row's iterations times one row-iteration's operations, 2E + n + m
  float (v2c subtract, variable add, prior add, scale) and 7E + n integer
  (sign, magnitude, the two-minimum update, sign apply, parity; the hard
  decision), E the edges of H; bytes: the syndromes, one prior row and H's
  edges (an index each) read once a batch, the outputs (hard, llr,
  converged, iterations) written once.
- OSD (osd_cs): each failing row's elimination in reliability order (the
  reference counts it, :class:`benchmark.reference.ElimCount`), its weight-1
  sweep over the n - rank T columns and weight-2 sweep over the pairs;
  bytes: a failing row's posterior and syndrome in, osd0 and osdw out, and
  the packed H and pair table once a batch that has failing rows.

No stage schedule's resumed message state and no kernel's device-memory
route is counted: a program that changes them moves its time, not this
yardstick.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_S = 3.35e12  # H100 SXM device memory (published)
F32_OPS_S = 67e12  # float32 outside the tensor cores (published)
INT_OPS_S = 64 * 132 * 1.98e9  # INT32 lanes x SMs x boost clock (derived)


class Work(NamedTuple):
    """Bytes and operations; added with :func:`total`."""

    nbytes: float = 0.0
    float_ops: float = 0.0
    int_ops: float = 0.0

    def seconds(self) -> float:
        """The least time on the H100: bytes or operations, whichever binds."""
        return max(self.nbytes / HBM_BYTES_S, self.float_ops / F32_OPS_S,
                   self.int_ops / INT_OPS_S)


def total(works) -> Work:
    works = list(works)
    return Work(*(sum(getattr(w, f) for w in works) for f in Work._fields))


def bp_work(m: int, n: int, edges: int, batches: int, rows: int, row_iterations: int) -> Work:
    """BP's needed work on ``batches`` batches of ``rows`` rows in all that
    ran ``row_iterations`` iterations in all."""
    per_batch = 4 * n + 4 * edges
    per_row = m + n + 4 * n + 1 + 4
    return Work(batches * per_batch + rows * per_row,
                row_iterations * (2 * edges + n + m), row_iterations * (7 * edges + n))


def osd_cs_work(m: int, n: int, rank: int, order: int, batches: int, rows: int,
                elim_ops: float) -> Work:
    """osd_cs's needed work on ``rows`` failing rows in ``batches`` batches
    that have some, whose eliminations need ``elim_ops`` integer operations
    in all."""
    Wm = -(-m // 32)
    lam = min(order, n - rank)
    pairs = lam * (lam - 1) // 2 if lam >= 2 else 0
    search = (n - rank) * (2 * Wm + 1) + pairs * (3 * Wm + 1)
    nbytes = batches * (4 * n * Wm + 8 * pairs) + rows * (4 * n + m + 2 * n)
    return Work(nbytes, 0.0, elim_ops + rows * search)
