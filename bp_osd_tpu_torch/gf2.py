"""Bit-packed GF(2) linear algebra (host side, numpy only).

Port of ``bp_osd_tpu/gf2.py`` without its native C++ elimination path: the
NumPy elimination it falls back to is bit-identical, and construction-time
algebra is off the decode path.  Rows are packed 64 columns per ``uint64``
word, so a row XOR touches ``ceil(n/64)`` words instead of ``n`` bytes.  The
batched per-sample elimination used while decoding lives in
``bp_osd_tpu_torch/decoder/osd.py`` (plain torch) and
``bp_osd_tpu_torch/csrc/osd_cs.cu`` (the CUDA kernel).

API contract mirrors ``ldpc.mod2`` as used by the reference:

- ``rank(A)``                      -> int
- ``row_echelon(A, full=False)``   -> (re, rank, transform, pivot_cols)
  (4-tuple shape per reference ``stab.py:69``)
- ``nullspace(A)`` / ``kernel(A)`` -> scipy CSR basis of the kernel
  (reference ``css.py:80``, ``stab.py:51``)
- ``pivot_rows(A)``                -> indices of a leading independent row set
  (reference ``css.py:86``, ``stab.py:56``)
- ``row_span(A)``                  -> all 2^rank row combinations, zero row
  first (reference ``stab.py:72`` consumes ``row_span(...)[1:]``)
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = [
    "to_dense",
    "pack_rows",
    "unpack_rows",
    "popcount",
    "row_echelon",
    "rank",
    "reduced_row_echelon",
    "nullspace",
    "kernel",
    "pivot_rows",
    "row_basis",
    "row_span",
    "inverse",
]

_U1 = np.uint64(1)


def to_dense(A) -> np.ndarray:
    """Coerce dense/sparse/list input to a dense uint8 matrix of 0/1 entries."""
    if sp.issparse(A):
        A = A.toarray()
    A = np.asarray(A)
    if A.ndim == 1:
        A = A.reshape(1, -1)
    if A.ndim != 2:
        raise ValueError(f"expected a 2D matrix, got shape {A.shape}")
    if A.size == 0:
        return np.zeros(A.shape, dtype=np.uint8)
    return (A.astype(np.int64) & 1).astype(np.uint8)


def pack_rows(A) -> tuple[np.ndarray, int]:
    """Pack a 0/1 matrix row-wise into uint64 words (little-endian bit order).

    Returns ``(packed [m, ceil(n/64)], n)``.
    """
    Ad = to_dense(A)
    m, n = Ad.shape
    W = max(1, -(-n // 64))
    if n == 0:
        return np.zeros((m, W), dtype=np.uint64), 0
    by = np.packbits(Ad, axis=1, bitorder="little")
    pad = W * 8 - by.shape[1]
    if pad:
        by = np.pad(by, ((0, 0), (0, pad)))
    return np.ascontiguousarray(by).view(np.uint64), n


def unpack_rows(P: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_rows`: uint64 words -> dense uint8 [m, n]."""
    by = np.ascontiguousarray(P).view(np.uint8)
    bits = np.unpackbits(by, axis=1, bitorder="little")
    return bits[:, :n].astype(np.uint8)


def popcount(P: np.ndarray) -> np.ndarray:
    """Per-row popcount of a packed matrix."""
    return np.bitwise_count(P).sum(axis=-1).astype(np.int64)


def _echelon_packed(P: np.ndarray, n: int, T: np.ndarray | None, full: bool):
    """In-place packed Gaussian elimination.

    Scans columns left to right; eliminates below the pivot (and above too
    when ``full``).  Mutates ``P`` (and ``T``).  Returns ``(rank,
    pivot_cols)``.
    """
    m = P.shape[0]
    r = 0
    pivot_cols = []
    for c in range(n):
        if r == m:
            break
        w, b = divmod(c, 64)
        bshift = np.uint64(b)
        col = (P[:, w] >> bshift) & _U1
        nz = np.nonzero(col[r:])[0]
        if nz.size == 0:
            continue
        p = r + int(nz[0])
        if p != r:
            P[[r, p]] = P[[p, r]]
            if T is not None:
                T[[r, p]] = T[[p, r]]
        if full:
            col = (P[:, w] >> bshift) & _U1
            col[r] = 0
            tgt = np.nonzero(col)[0]
        else:
            tgt = r + 1 + np.nonzero((P[r + 1 :, w] >> bshift) & _U1)[0]
        if tgt.size:
            P[tgt] ^= P[r]
            if T is not None:
                T[tgt] ^= T[r]
        pivot_cols.append(c)
        r += 1
    return r, np.asarray(pivot_cols, dtype=np.int64)


def row_echelon(A, full: bool = False):
    """Row-echelon form over GF(2).

    Returns the 4-tuple ``(re, rank, transform, pivot_cols)`` with
    ``transform @ A % 2 == re`` — matching the ``ldpc.mod2.row_echelon``
    contract consumed at reference ``stab.py:69``.
    """
    Ad = to_dense(A)
    m, n = Ad.shape
    P, _ = pack_rows(Ad)
    T, _ = pack_rows(np.eye(m, dtype=np.uint8)) if m else (np.zeros((0, 1), np.uint64), 0)
    r, pivot_cols = _echelon_packed(P, n, T, full)
    return unpack_rows(P, n), r, unpack_rows(T, m), pivot_cols


def reduced_row_echelon(A):
    """Reduced row-echelon form (full Jordan elimination); same 4-tuple."""
    return row_echelon(A, full=True)


def rank(A) -> int:
    """GF(2) rank (reference call sites: ``css.py:50``, ``hgp.py:29``)."""
    Ad = to_dense(A)
    P, n = pack_rows(Ad)
    r, _ = _echelon_packed(P, n, None, False)
    return r


def nullspace(A) -> sp.csr_matrix:
    """Basis of the kernel ``{x : A x = 0 mod 2}`` as CSR rows.

    Row order is free-column-ascending, which pins down the logical-operator
    representatives selected by the kernel-minus-image trick (reference
    ``css.py:76-88``).
    """
    Ad = to_dense(A)
    m, n = Ad.shape
    re, r, _, pcols = row_echelon(Ad, full=True)
    free = np.setdiff1d(np.arange(n), pcols, assume_unique=True)
    k = free.size
    N = np.zeros((k, n), dtype=np.uint8)
    if k:
        N[np.arange(k), free] = 1
        if r:
            # back-substitute: x[pivot_i] = RREF[i, free_col]
            N[:, pcols[:r]] = re[:r, free].T
    return sp.csr_matrix(N, dtype=np.uint8)


def kernel(A) -> sp.csr_matrix:
    """Alias of :func:`nullspace` (reference ``stab.py:51`` spelling)."""
    return nullspace(A)


def pivot_rows(A) -> np.ndarray:
    """Indices of the first maximal linearly independent set of rows.

    Equals the pivot columns of ``A.T`` under left-to-right elimination
    (reference ``css.py:86``: the rows past ``rank(hz)`` in the stacked
    ``[hz; ker(hx)]`` matrix are the logical representatives).
    """
    Ad = to_dense(A)
    P, n = pack_rows(Ad.T)
    _, pcols = _echelon_packed(P, n, None, False)
    return pcols


def row_basis(A) -> sp.csr_matrix:
    """A basis of the row space, taken from the original rows."""
    Ad = to_dense(A)
    return sp.csr_matrix(Ad[pivot_rows(Ad)], dtype=np.uint8)


def row_span(A) -> sp.csr_matrix:
    """All ``2^rank`` GF(2) combinations of the rows; zero row first.

    Gray-code enumeration over a row basis (reference ``stab.py:72`` iterates
    the span minus the zero row for brute-force distance).
    """
    Ad = to_dense(A)
    n = Ad.shape[1]
    re, r, _, _ = row_echelon(Ad)
    if r > 30:
        raise ValueError(f"row_span of rank {r} would materialize 2^{r} rows")
    basis, _ = pack_rows(re[:r])
    out = np.zeros((1 << r, basis.shape[1]), dtype=np.uint64)
    for i in range(1, 1 << r):
        j = (i & -i).bit_length() - 1
        out[i] = out[i - 1] ^ basis[j]
    return sp.csr_matrix(unpack_rows(out, n), dtype=np.uint8)


def inverse(A) -> np.ndarray:
    """Inverse of a square invertible GF(2) matrix."""
    Ad = to_dense(A)
    m, n = Ad.shape
    if m != n:
        raise ValueError("matrix must be square")
    re, r, T, _ = row_echelon(Ad, full=True)
    if r != n:
        raise ValueError("matrix is singular over GF(2)")
    return T
