"""Bivariate bicycle (BB) quantum LDPC codes.

The construction of Bravyi et al., "High-threshold and low-overhead
fault-tolerant quantum memory" (arXiv:2308.07915): with ``S_k`` the k x k
cyclic shift (``S[i, j] = 1`` iff ``j = i + 1 mod k``), ``x = S_l (x) I_m``
and ``y = I_l (x) S_m`` commute, and two sums of monomials ``A`` and ``B``
in them give::

    hx = [ A   | B   ]
    hz = [ B^T | A^T ]

so ``hx @ hz.T = A B + B A = 0`` over F2.  Block length ``N = 2 l m``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .css import css_code
from .lifted_product import circulant

__all__ = ["bivariate_bicycle", "gross_code", "two_gross_code"]


def _polynomial(terms, l: int, m: int) -> sp.csr_matrix:
    """``sum_k x^a_k y^b_k`` over F2 for ``terms = [(a_k, b_k), ...]``."""
    M = sp.csr_matrix((l * m, l * m), dtype=np.int64)
    for a, b in terms:
        M = M + sp.kron(circulant((int(a),), l), circulant((int(b),), m), format="csr")
    M.data %= 2
    M.eliminate_zeros()
    return M.astype(np.uint8)


class bivariate_bicycle(css_code):
    """The BB code of ``A`` and ``B``, each a list of monomials ``(a, b)``
    for ``x^a y^b``; ``A`` and ``B`` keep the two ``lm x lm`` blocks and
    ``group`` the pair ``(l, m)`` (``l`` is the logicals' property)."""

    def __init__(self, l: int, m: int, A, B, code_distance=np.nan,
                 name: str = "<Unnamed bivariate bicycle code>"):
        self.group = (int(l), int(m))
        self.A = _polynomial(A, *self.group)
        self.B = _polynomial(B, *self.group)
        super().__init__(sp.hstack([self.A, self.B], format="csr"),
                         sp.hstack([self.B.T, self.A.T], format="csr"),
                         code_distance=code_distance, name=name)


def gross_code() -> bivariate_bicycle:
    """The [[144,12,12]] "gross" code of arXiv:2308.07915: l = 12, m = 6,
    A = x^3 + y + y^2, B = y^3 + x + x^2; its distance 12 is the paper's."""
    return bivariate_bicycle(12, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)],
                             code_distance=12, name="gross code")


def two_gross_code() -> bivariate_bicycle:
    """The [[288,12,18]] "two-gross" code of arXiv:2308.07915: l = m = 12,
    A = x^3 + y^2 + y^7, B = y^3 + x + x^2; its distance 18 is the
    paper's."""
    return bivariate_bicycle(12, 12, [(3, 0), (0, 2), (0, 7)], [(0, 3), (1, 0), (2, 0)],
                             code_distance=18, name="two-gross code")
