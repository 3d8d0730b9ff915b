"""The benchmark's one traffic generator.

A traffic file (``traffic/<cell>.json``) holds the parameters:

- ``p``: the rate of i.i.d. bit errors on the n qubits (``bench_torch.py``'s
  ``error_syndromes``: errors at rate p, syndrome ``H e mod 2``);
- ``batch``: rows a batch, the batch ``decode_batch`` is called with;
- ``pool``: distinct batches made in set-up, which the window cycles
  through; where the hard rows are rare, a pool larger than a window's
  batches keeps the window's share of them from following the seed;
- ``warmup_batches``: pool batches decoded in set-up;
- ``check_batches``: decodes of the window compared with the reference;
- ``check_osd_rows``: at most this many of their failing rows go through the
  reference's OSD.

Every seed decodes the same set of error weights: the ``pool * batch`` rows
take the quantiles of Binomial(n, p) at ``(i + 1/2) / (pool * batch)``, in
an order drawn from the seed, and each row's errors sit on that many
distinct qubits drawn uniformly from the seed.  So the seed changes which
errors a row has, not how many the pool holds; the marginal law of a row is
still the i.i.d. one.  Everything is made on the device from a
``torch.Generator`` seeded with ``--seed``.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import binom

_KEY_FLOATS = 1 << 27  # random keys of one chunk of rows: rows x n


def stratified_weights(n: int, p: float, rows: int) -> np.ndarray:
    """The ``rows`` quantiles of Binomial(n, p) at ``(i + 1/2) / rows``."""
    q = (np.arange(rows, dtype=np.float64) + 0.5) / rows
    return binom.ppf(q, n, p).astype(np.int64)


def column_checks(H: np.ndarray) -> np.ndarray:
    """The checks on each column ``[n, wc]``, padded with ``m``."""
    m, n = H.shape
    rows, cols = np.nonzero(H.T)  # by column, then check
    counts = np.bincount(rows, minlength=n)
    out = np.full((n, max(1, int(counts.max()))), m, np.int64)
    out[rows, np.concatenate([np.arange(c) for c in counts])] = cols
    return out


def make_pool(H: np.ndarray, traffic: dict, seed: int, device) -> torch.Tensor:
    """The pool of syndromes ``[pool, batch, m]`` uint8 on ``device``."""
    m, n = H.shape
    pool, batch, p = int(traffic["pool"]), int(traffic["batch"]), float(traffic["p"])
    rows = pool * batch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    weights = torch.from_numpy(stratified_weights(n, p, rows)).to(device)
    weights = weights[torch.randperm(rows, generator=gen, device=device)]
    wmax = max(1, int(weights.max()))
    checks = torch.from_numpy(column_checks(H)).to(device)
    out = torch.empty(rows, m, dtype=torch.uint8, device=device)
    chunk = max(1, _KEY_FLOATS // n)
    for lo in range(0, rows, chunk):
        w = weights[lo : lo + chunk]
        keys = torch.rand(w.shape[0], n, generator=gen, device=device)
        pos = keys.topk(wmax, dim=1, largest=False, sorted=True).indices  # distinct qubits
        live = torch.arange(wmax, device=device)[None, :] < w[:, None]
        hit = checks[pos].masked_fill(~live[:, :, None], m).flatten(1)  # [rows, wmax * wc]
        counts = torch.zeros(w.shape[0], m + 1, dtype=torch.int32, device=device)
        counts.scatter_add_(1, hit, torch.ones_like(hit, dtype=torch.int32))
        out[lo : lo + chunk] = (counts[:, :m] & 1).to(torch.uint8)
    return out.view(pool, batch, m)
