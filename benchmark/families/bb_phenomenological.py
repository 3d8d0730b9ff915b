"""A bivariate bicycle code's X checks over repeated noisy syndrome rounds:
the space-time matrix of a phenomenological memory experiment, plain NumPy.

The code (Bravyi et al., arXiv:2308.07915): ``hx = [A | B]``, ``A`` and
``B`` sums of monomials ``x^a y^b`` with ``x = S_l (x) I_m`` and
``y = I_l (x) S_m``, ``S_k`` the k x k cyclic shift (``S[i, i + 1 mod k] =
1``).  The noise (Dennis et al., quant-ph/0110143): a data error before
each of ``rounds + 1`` rounds, the last one perfect, and a measurement error
in each of the ``rounds`` noisy ones; the rows are the detection events, a
round's syndrome XOR the one before.  Columns run round by round, each
round's ``N`` data columns and then, but for the last round's, its ``mx``
measurement columns.  The configuration's ``code`` entry::

    {"family": "bb_phenomenological", "l": 12, "m": 6,
     "A": [[3, 0], [0, 1], [0, 2]], "B": [[0, 3], [1, 0], [2, 0]], "rounds": 12}
"""

import numpy as np


def _shift(k: int, e: int) -> np.ndarray:
    return np.roll(np.eye(k, dtype=np.uint8), int(e), axis=1)


def _polynomial(terms, l: int, m: int) -> np.ndarray:
    M = np.zeros((l * m, l * m), np.uint8)
    for a, b in terms:
        M ^= np.kron(_shift(l, a), _shift(m, b))
    return M


def build(code):
    l, m, R = int(code["l"]), int(code["m"]), int(code["rounds"])
    hx = np.hstack([_polynomial(code["A"], l, m), _polynomial(code["B"], l, m)])
    mx, N = hx.shape
    H = np.zeros(((R + 1) * mx, (R + 1) * N + R * mx), np.uint8)
    eye = np.eye(mx, dtype=np.uint8)
    for t in range(R + 1):
        col = t * (N + mx)
        H[t * mx:(t + 1) * mx, col:col + N] = hx
        if t < R:
            H[t * mx:(t + 2) * mx, col + N:col + N + mx] = np.vstack([eye, eye])
    return H, None, None
