"""Classical code utilities.

Port of ``bp_osd_tpu/codes/code_util.py`` (numpy only), the replacement
for ``ldpc.code_util`` as consumed by the reference
(``compute_exact_code_distance`` at reference ``hgp.py:3,62-79``).
"""

from __future__ import annotations

import numpy as np

from .. import gf2

__all__ = [
    "compute_exact_code_distance",
    "compute_code_parameters",
    "construct_generator_matrix",
]


def compute_exact_code_distance(H, max_dimension: int = 26):
    """Exact minimum distance of the classical code ``ker(H)``.

    Brute-force Gray-code walk over all ``2^k - 1`` nonzero codewords with
    bit-packed XOR accumulation (exponential in k; the reference only calls
    this on HGP seed codes with k <= ~10, reference ``hgp.py:62-79``).
    Returns ``numpy.inf`` for the trivial code (k == 0).
    """
    ker = gf2.nullspace(H).toarray()
    k, n = ker.shape
    if k == 0:
        return np.inf
    if k > max_dimension:
        raise ValueError(
            f"exact distance search over 2^{k} codewords is intractable; "
            f"raise max_dimension to force it"
        )
    basis, _ = gf2.pack_rows(ker)
    W = basis.shape[1]
    total = 1 << k
    best = n + 1
    # Gray-code enumeration in vectorized blocks: within a block, codeword i
    # differs from i-1 by basis row tz(i), so a block is a cumulative XOR scan.
    block = 1 << min(k, 16)
    acc = np.zeros(W, dtype=np.uint64)
    for start in range(0, total, block):
        idx = np.arange(max(start, 1), min(start + block, total))
        # trailing-zero count of i = index of the basis row flipped at step i
        tz = np.zeros(idx.shape, dtype=np.int64)
        low = (idx & -idx).astype(np.uint64)
        for shift in (32, 16, 8, 4, 2, 1):
            big = low >= (np.uint64(1) << np.uint64(shift))
            tz += big * shift
            low = np.where(big, low >> np.uint64(shift), low)
        flips = basis[tz]
        # prepend carry-in accumulator, cumulative XOR down the block
        words = np.bitwise_xor.accumulate(
            np.concatenate([acc[None, :], flips], axis=0), axis=0
        )
        acc = words[-1]
        w = np.bitwise_count(words[1:]).sum(axis=1)
        best = min(best, int(w.min()))
    return int(best)


def compute_code_parameters(H, max_dimension: int = 26):
    """Return ``(n, k, d)`` for the classical code with parity-check ``H``."""
    Hd = gf2.to_dense(H)
    m, n = Hd.shape
    k = n - gf2.rank(Hd)
    d = compute_exact_code_distance(Hd, max_dimension=max_dimension) if k else np.inf
    return n, k, d


def construct_generator_matrix(H):
    """Generator matrix G with ``H @ G.T == 0 (mod 2)`` (rows span ker H)."""
    return gf2.nullspace(H)
