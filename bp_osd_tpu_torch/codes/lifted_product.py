"""Lifted-product quantum LDPC codes (Panteleev-Kalachev construction).

Port of ``bp_osd_tpu/codes/lifted_product.py`` (numpy/scipy only).  The
hypergraph product generalised from binary seed matrices to matrices over the
cyclic group algebra ``R = F2[x]/(x^L - 1)``: each protograph entry is a set
of shift exponents, expanded to an ``L x L`` sum of cyclic permutation
matrices.  At ``L = 1`` it is exactly the hypergraph product (``hgp``); larger
lifts give the n ~ 10^4 codes that the lifted decode path
(``decoder/lifted_bp.py`` + OSD kernel K5) serves.

Protograph matrices are nested lists of exponent tuples, e.g.
``[[(0, 1), ()], [(2,), (0,)]]``: entry (i, j) is ``sum_k x^e_k`` (empty
tuple = zero entry).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .css import css_code

__all__ = ["lifted_hgp", "circulant", "protograph_to_binary"]


def circulant(exponents, L: int) -> sp.csr_matrix:
    """Sum of cyclic shift matrices ``sum_k P^e_k`` over ``F2``, ``P`` the
    L x L left-shift permutation (``P[i, j] = 1`` iff ``j = i + 1 mod L``)."""
    M = np.zeros((L, L), dtype=np.uint8)
    idx = np.arange(L)
    for e in exponents:
        M[idx, (idx + int(e)) % L] ^= 1
    return sp.csr_matrix(M, dtype=np.uint8)


def _conj(exponents, L: int):
    """Ring conjugation x^e -> x^{-e} (transpose of the circulant)."""
    return tuple((-int(e)) % L for e in exponents)


def protograph_to_binary(proto, L: int, transpose: bool = False) -> sp.csr_matrix:
    """Expand a protograph over R to its binary lift.

    ``transpose=True`` gives the lift of the conjugate transpose (entries
    transposed and shift-inverted), which is the transpose of the plain lift.
    """
    rows = len(proto)
    cols = len(proto[0]) if rows else 0
    if transpose:
        blocks = [[circulant(_conj(proto[i][j], L), L) for i in range(rows)]
                  for j in range(cols)]
    else:
        blocks = [[circulant(proto[i][j], L) for j in range(cols)]
                  for i in range(rows)]
    return sp.bmat(blocks, format="csr", dtype=np.uint8)


def _kron_proto(P, eye_n: int, right: bool):
    """``I_eye (x) P`` (``right``) or ``P (x) I_eye`` at the protograph level."""
    rows_p, cols_p = len(P), len(P[0])
    if right:
        return [[P[i][j] if bi == bj else ()
                 for bj in range(eye_n) for j in range(cols_p)]
                for bi in range(eye_n) for i in range(rows_p)]
    return [[P[i][j] if bi == bj else ()
             for j in range(cols_p) for bj in range(eye_n)]
            for i in range(rows_p) for bi in range(eye_n)]


class lifted_hgp(css_code):
    """Lifted (hypergraph) product of two protographs over F2[x]/(x^L-1).

    With A (ma x na) and B (mb x nb) over R::

        hx = [ A (x) I_nb  |  I_ma (x) B^T* ]
        hz = [ I_na (x) B  |  A^T* (x) I_mb ]

    where ``*`` is ring conjugation, so ``hx @ hz.T = A (x) B + A (x) B = 0``
    over F2.  Block length ``N = (na*nb + ma*mb) * L``.  ``hx_proto`` and
    ``hz_proto`` are the protographs whose lifts are ``hx`` and ``hz``: pass
    one with ``lift`` to the decoders' ``proto=`` for shift-routed BP.
    """

    def __init__(self, proto_a, proto_b=None, lift: int = 1,
                 compute_distance: bool = False):
        if proto_b is None:
            proto_b = proto_a
        L = int(lift)
        ma, na = len(proto_a), len(proto_a[0])
        mb, nb = len(proto_b), len(proto_b[0])
        self.lift = L
        self.proto_a = proto_a
        self.proto_b = proto_b
        n_left = na * nb

        def conj_right(proto):  # conjugate the entries of the right block
            return [[ent if j < n_left else _conj(ent, L) for j, ent in enumerate(row)]
                    for row in proto]

        bt = [[proto_b[i][j] for i in range(mb)] for j in range(nb)]
        hx_proto = [ra + rb for ra, rb in zip(_kron_proto(proto_a, nb, right=False),
                                              _kron_proto(bt, ma, right=True))]
        at = [[proto_a[i][j] for i in range(ma)] for j in range(na)]
        hz_proto = [rb + ra for rb, ra in zip(_kron_proto(proto_b, na, right=True),
                                              _kron_proto(at, mb, right=False))]
        self.hx_proto = conj_right(hx_proto)
        self.hz_proto = conj_right(hz_proto)

        super().__init__(protograph_to_binary(self.hx_proto, L),
                         protograph_to_binary(self.hz_proto, L))
        if compute_distance:
            self.compute_code_distance()
