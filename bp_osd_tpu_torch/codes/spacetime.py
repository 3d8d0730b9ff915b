"""Space-time check matrices of repeated syndrome measurement.

A memory experiment measures the checks ``h`` (m x n) in ``rounds`` noisy
rounds and then once perfectly, as a final data readout gives them.  Under
phenomenological noise (Dennis et al., quant-ph/0110143) a data error can
strike each qubit before each of the ``rounds + 1`` rounds, and a measurement
error can flip each check's outcome in each noisy round.  The decoder sees
detection events, the XOR of consecutive rounds' syndromes (the first round
against zero), ``(rounds + 1) m`` of them, and decodes them on the
space-time matrix ``H_st``:

- the data block of round ``t`` is ``h`` in detector block ``t`` (an error
  before round ``t`` first shows there, and stays in every later syndrome);
- the measurement block of noisy round ``t`` is the identity in detector
  blocks ``t`` and ``t + 1`` (a wrong outcome differs from both neighbours).

Columns run round by round: round ``t``'s ``n`` data columns, then, for
``t < rounds``, its ``m`` measurement columns; :class:`Spacetime` keeps
each column's index.  Host-side NumPy and SciPy, construction time only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp

__all__ = ["Spacetime", "detection_events", "net_data_error", "phenomenological"]


class Spacetime(NamedTuple):
    H: sp.csr_matrix  # [(rounds + 1) m, (rounds + 1) n + rounds m] uint8
    data: np.ndarray  # [rounds + 1, n] int64: column of qubit v's error before round t
    meas: np.ndarray  # [rounds, m] int64: column of check c's error in noisy round t


def phenomenological(h, rounds: int) -> Spacetime:
    """The space-time matrix of ``rounds`` noisy rounds of the checks ``h``
    and a perfect one, and its column layout."""
    h = sp.csr_matrix(h, dtype=np.uint8)
    m, n = h.shape
    R = int(rounds)
    if R < 0:
        raise ValueError(f"rounds must be at least 0, got {rounds}")
    width = n + m
    data = np.arange(R + 1)[:, None] * width + np.arange(n)[None, :]
    meas = np.arange(R)[:, None] * width + n + np.arange(m)[None, :]
    eye = sp.identity(m, format="csr", dtype=np.uint8)
    blocks = [[None] * (2 * R + 1) for _ in range(R + 1)]
    for t in range(R + 1):
        blocks[t][2 * t] = h
        if t < R:
            blocks[t][2 * t + 1] = eye
            blocks[t + 1][2 * t + 1] = eye
    H = sp.bmat(blocks, format="csr", dtype=np.uint8)
    return Spacetime(H, data, meas)


def detection_events(syndromes) -> np.ndarray:
    """``[B, rounds + 1, m]`` syndromes, one per round, to the detection
    events ``[B, (rounds + 1) m]`` uint8: each round XOR the one before, the
    first as measured."""
    s = np.asarray(syndromes, dtype=np.uint8)
    if s.ndim != 3:
        raise ValueError(f"syndromes must be [B, rounds + 1, m], got {s.shape}")
    d = s.copy()
    d[:, 1:] ^= s[:, :-1]
    return d.reshape(s.shape[0], -1)


def net_data_error(x, st: Spacetime) -> np.ndarray:
    """A space-time error ``[B, n_st]`` folded to the data error it leaves
    ``[B, n]`` uint8: the XOR of its data blocks."""
    x = np.asarray(x, dtype=np.uint8)
    return np.bitwise_xor.reduce(x[:, st.data], axis=1)
