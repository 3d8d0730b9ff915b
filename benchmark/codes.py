"""The benchmark's own code constructions, plain NumPy.

Frozen copies of the hypergraph product and the lifted product (the
Panteleev-Kalachev construction over ``F2[x]/(x^L - 1)``), and of the MKMN
seed matrix of the [[400,16,6]] code.  The benchmark builds each code's X
parity-check matrix here and hands the same matrix to the program and to the
reference.  Nothing here imports the program.

A configuration's ``code`` entry names the construction:

- ``{"family": "hgp", "seed": "mkmn_16_4_6"}``: ``hx = [h (x) I_n | I_m (x) h^T]``;
- ``{"family": "lifted_hgp", "proto": [[[e, ...], ...], ...], "lift": L}``:
  ``hx`` of the lifted product of the protograph with itself, and
  ``hx_proto``, the protograph whose lift it is;
- any other ``{"family": "<family>", ...}``: ``build(code)`` of the
  configuration's own ``families/<family>.py`` (:mod:`.spec`).
"""

from __future__ import annotations

import numpy as np

from . import spec

# rows of the 12 x 16 MKMN seed, column c = bit c (reference
# examples/codes/classical_seed_codes/mkmn_16_4_6.txt)
MKMN_16_4_6 = (
    0b0000000000110011,
    0b0001000011000100,
    0b0010000001011000,
    0b1000001100100000,
    0b0000100110000010,
    0b0111000100000000,
    0b1010000010000001,
    0b0001010000101000,
    0b1000100000001100,
    0b0000111000010000,
    0b0100010001000010,
    0b0100001000000101,
)
SEEDS = {"mkmn_16_4_6": (MKMN_16_4_6, 16)}


def seed_matrix(name: str) -> np.ndarray:
    rows, width = SEEDS[name]
    return np.array([[(r >> c) & 1 for c in range(width)] for r in rows], np.uint8)


def hgp_hx(h: np.ndarray) -> np.ndarray:
    """X checks of the hypergraph product of ``h`` with itself."""
    m, n = h.shape
    return np.hstack([np.kron(h, np.eye(n, dtype=np.uint8)),
                      np.kron(np.eye(m, dtype=np.uint8), h.T)]).astype(np.uint8)


def circulant(exponents, L: int) -> np.ndarray:
    """``sum_k P^e_k`` over F2, ``P[i, j] = 1`` iff ``j = i + 1 mod L``."""
    M = np.zeros((L, L), np.uint8)
    idx = np.arange(L)
    for e in exponents:
        M[idx, (idx + int(e)) % L] ^= 1
    return M


def _conj(exponents, L: int):
    return tuple((-int(e)) % L for e in exponents)


def _kron_proto(P, eye_n: int, right: bool):
    """``I (x) P`` (``right``) or ``P (x) I`` at the protograph level."""
    rows_p, cols_p = len(P), len(P[0])
    if right:
        return [[P[i][j] if bi == bj else ()
                 for bj in range(eye_n) for j in range(cols_p)]
                for bi in range(eye_n) for i in range(rows_p)]
    return [[P[i][j] if bi == bj else ()
             for j in range(cols_p) for bj in range(eye_n)]
            for i in range(rows_p) for bi in range(eye_n)]


def lifted_hx_proto(proto, L: int):
    """The protograph of ``hx = [A (x) I_nb | I_ma (x) B^T*]`` with ``B = A``,
    ``*`` ring conjugation on the right block."""
    A = [[tuple(int(e) for e in ent) for ent in row] for row in proto]
    ma, na = len(A), len(A[0])
    bt = [[A[i][j] for i in range(ma)] for j in range(na)]
    rows = [ra + rb for ra, rb in zip(_kron_proto(A, na, right=False),
                                      _kron_proto(bt, ma, right=True))]
    n_left = na * na
    return [[ent if j < n_left else _conj(ent, L) for j, ent in enumerate(row)]
            for row in rows]


def protograph_to_binary(proto, L: int) -> np.ndarray:
    return np.block([[circulant(ent, L) for ent in row] for row in proto]).astype(np.uint8)


def build(code: dict, home: str = spec.HERE):
    """``(hx [m, n] uint8, hx_proto or None, lift or None)`` of a
    configuration's ``code`` entry; a family of its own is read from
    ``<home>/families/``."""
    if code["family"] == "hgp":
        return hgp_hx(seed_matrix(code["seed"])), None, None
    if code["family"] == "lifted_hgp":
        L = int(code["lift"])
        proto = lifted_hx_proto(code["proto"], L)
        return protograph_to_binary(proto, L), proto, L
    H, proto, lift = spec.load(home, "families", code["family"]).build(code)
    if not (isinstance(H, np.ndarray) and H.dtype == np.uint8 and H.ndim == 2
            and H.max(initial=0) <= 1):
        raise ValueError(f"family {code['family']!r} built no [m, n] uint8 0/1 matrix")
    return H, proto, lift
