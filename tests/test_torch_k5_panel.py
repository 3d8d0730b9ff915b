"""Kernel K5's design (``csrc/osd_large.cu``) on the CPU: its panel
elimination in the word-major layout and its sweep, emulated in numpy step
for step, against the port's plain versions and the JAX package; the Python
mirror of its shared memory; the elimination counts ``utils/measure.py``
counts the OSD kernels' bounds from; K3's fit and the unchanged OSD
routing.

The emulation keeps what the kernel keeps where the kernel keeps it: the
matrix word-major (word w of every column contiguous) in "device memory", a
window of two panels of P columns in a separate array (column-major) that
warp 0 searches and updates, the columns after the window updated in device
memory only, a panel written back when the search leaves it and the panel
after the window loaded into the freed buffer.  A stale prefetch, a missed
write-back or an update sent to the wrong copy changes the result, which
every comparison below would see.  All of it is integer work, so every
comparison is exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder.osd import _eliminate as j_eliminate

from bp_osd_tpu_torch.codes import hgp, lifted_hgp, mkmn_16_4_6
from bp_osd_tpu_torch.decoder.osd import (build_osd_consts, eliminate_plain, osd_decode_plain,
                                          osd_route)
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.ops.cuda_bp import _SMEM_LIMIT
from bp_osd_tpu_torch.ops.cuda_osd import k2_fits, k3_fits, osd_cs_warp_smem_bytes
from bp_osd_tpu_torch.ops.cuda_osd_large import osd_large_panel, osd_large_smem_bytes
from bp_osd_tpu_torch.utils.measure import elim_work

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "flagship_corpus.npz")
PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]


def _popc(x: np.ndarray) -> np.ndarray:
    """Popcount of uint32 words, summed over the last axis."""
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=-1).sum(-1)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """Bits ``[..., k]`` to uint32 words ``[..., ceil(k/32)]``, bit i of word w
    is entry 32 w + i."""
    k = bits.shape[-1]
    W = -(-k // 32)
    pad = np.zeros(bits.shape[:-1] + (32 * W,), np.uint64)
    pad[..., :k] = bits
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (pad.reshape(bits.shape[:-1] + (W, 32)) * weights).sum(-1).astype(np.uint32)


def _unpack_bits(words: np.ndarray, k: int) -> np.ndarray:
    bits = (words[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :k].astype(np.uint8)


def k5_eliminate(h_cols, perm, synd, rank, P):
    """K5's elimination of one sample: ``h_cols [n, Wm]`` uint32 (the
    column-packed H), ``perm [n]``, ``synd [m]``.  Returns the device
    matrix ``M [Wm, n + 1]`` after the final write-back (word-major: column
    c is ``M[:, c]``, the syndrome column n) and ``prow [n]``."""
    n, Wm = h_cols.shape
    M = np.zeros((Wm, n + 1), np.uint32)
    M[:, :n] = h_cols[perm].T
    M[:, n] = _pack_bits(synd)
    panels = np.zeros((2, P, Wm), np.uint32)  # the window, column-major

    def slot(c):  # panel c // P lives in buffer (c // P) & 1
        return panels[(c // P) & 1, c % P]

    for c in range(min(2 * P, n)):
        slot(c)[:] = M[:, c]
    used = np.zeros(Wm, np.uint32)
    prow = np.full(n, -1, np.int64)
    k = t = rr = 0
    while True:
        # warp 0: the dependent columns of the panel pass without an event
        pr = -1
        while t < min(n, (k + 1) * P) and rr < rank:
            x = slot(t) & ~used
            nz = np.flatnonzero(x)
            if nz.size:
                w = int(nz[0])
                pr = 32 * w + int(np.flatnonzero(_unpack_bits(x[w:w + 1], 32))[0])
                break
            t += 1
        if pr < 0 and (t >= n or rr >= rank):
            break
        if pr < 0:  # the panel end: write panel k back, load panel k + 2 in its place
            for j in range(P):
                c = k * P + j
                if c < n:
                    M[:, c] = slot(c)
                if c + 2 * P < n:
                    slot(c + 2 * P)[:] = M[:, c + 2 * P]
            k += 1
            continue
        pw, pbit = pr >> 5, np.uint32(1 << (pr & 31))
        S = slot(t).copy()
        S[pw] &= ~pbit
        used[pw] |= pbit
        prow[t] = pr
        wend = min(n, (k + 2) * P)
        for c in range(t + 1, wend):  # warp 0: the window, in shared memory only
            if slot(c)[pw] & pbit:
                slot(c)[:] ^= S
        hits = wend + np.flatnonzero(M[pw, wend:] & pbit)  # warps 1-31: device memory
        M[:, hits] ^= S[:, None]
        t += 1
        rr += 1
    for c in range(k * P, min(n, (k + 2) * P)):  # the window's last columns
        M[:, c] = slot(c)
    return M, prow


def k5_decode(h_cols, perm, synd, rank, P, lam, pairs):
    """K5 for one sample: the elimination, T, the sweep (zero pattern,
    weight 1 on every non-pivot column, weight 2 on ``pairs`` of the first
    lam T columns; first minimum of ``weight << 32 | candidate rank``) and
    the read-off.  Returns (osd0, osdw) in original coordinates."""
    n = h_cols.shape[0]
    M, prow = k5_eliminate(h_cols, perm, synd, rank, P)
    syn = M[:, n]
    tall = np.flatnonzero(prow < 0)
    bt1 = bt2 = -1
    if lam > 0:
        keys = [int(_popc(syn)) << 32]
        w1 = 1 + _popc((syn[:, None] ^ M[:, tall]).T)
        keys += [(int(w) << 32) | (1 + int(c)) for w, c in zip(w1, tall)]
        tcol = tall[:lam]
        for q, (a, b) in enumerate(np.asarray(pairs if pairs is not None else [])):
            wt = 2 + int(_popc(syn ^ M[:, tcol[a]] ^ M[:, tcol[b]]))
            keys.append((wt << 32) | (1 + n + q))
        rank_id = min(keys) & 0xFFFFFFFF
        if 1 <= rank_id <= n:
            bt1 = rank_id - 1
        elif rank_id > n:
            a, b = pairs[rank_id - 1 - n]
            bt1, bt2 = int(tcol[a]), int(tcol[b])
    best = syn.copy()
    for bt in (bt1, bt2):
        if bt >= 0:
            best ^= M[:, bt]
    piv = prow >= 0
    s_bits, b_bits = _unpack_bits(syn, 32 * len(syn)), _unpack_bits(best, 32 * len(best))
    e0, ew = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
    e0[perm[piv]] = s_bits[prow[piv]]
    ew[perm[piv]] = b_bits[prow[piv]]
    for bt in (bt1, bt2):
        if bt >= 0:
            ew[perm[bt]] = 1
    return e0, ew


def k5_elimination_outputs(M, prow, perm, m, rank):
    """The five outputs of ``eliminate_plain`` / JAX ``_eliminate`` from K5's
    reduced matrix: h_work (row-packed, original column order), s_work,
    pivot_ids, pivot_rows, pivot_mask.  K5 never rewrites a pivot column
    (nothing after the elimination reads it); in the reduced matrix pivot
    column t is the unit vector of its pivot row."""
    n = len(perm)
    bits = _unpack_bits(M.T, m)  # [n + 1, m]
    piv = np.flatnonzero(prow >= 0)
    bits[piv] = 0
    bits[piv, prow[piv]] = 1
    h_bits = np.zeros((n, m), np.uint8)
    h_bits[perm] = bits[:n]
    found = np.flatnonzero(prow >= 0)[:rank]
    return (_pack_bits(h_bits.T), bits[n].astype(np.int32), perm[found].astype(np.int32),
            prow[found].astype(np.int32), prow >= 0)


def _rank_deficient():
    """A random 24 x 60 code whose last rows are sums of others (rank 21)."""
    rng = np.random.default_rng(17)
    H = (rng.random((24, 60)) < 0.12).astype(np.uint8)
    H[21] = H[0] ^ H[1]
    H[22] = H[2] ^ H[3] ^ H[4]
    H[23] = H[5] ^ H[21]
    return H


def _case(code):
    """(H, syndromes, perms, osd order) of each code's rows."""
    rng = np.random.default_rng(5)
    if code == "flagship_corpus":
        data = np.load(CORPUS)
        H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
        synd = np.unpackbits(data["synd_packed"], axis=1)[:3, :H.shape[0]]
        order = 42
    else:
        H = (np.asarray(lifted_hgp(PROTO, lift=60).hx.toarray(), np.uint8) if code == "lift60"
             else _rank_deficient())
        err = (rng.random((2, H.shape[1])) < 0.05).astype(np.uint8)
        synd = (err @ H.T % 2).astype(np.uint8)
        order = 15 if code == "lift60" else 6
    perm = np.argsort(rng.normal(0, 1, (synd.shape[0], H.shape[1])), axis=1,
                      kind="stable").astype(np.int32)
    return H, synd, perm, order


@pytest.mark.parametrize("P", [1, 7, 64])
@pytest.mark.parametrize("code", ["flagship_corpus", "lift60", "rank_deficient"])
def test_k5_panel_emulation_equals_plain_and_jax(code, P):
    """At panel widths 1, 7 and 64 the emulated K5 gives the five outputs of
    ``eliminate_plain`` and of JAX ``_eliminate``, and the osd0/osdw of
    ``osd_decode_plain``, on flagship corpus rows, lift-60 rows and a
    rank-deficient code."""
    H, synd, perm, order = _case(code)
    g = TannerGraph(H, device="cpu")
    m, n, r = g.m, g.n, g.rank
    if code == "rank_deficient":
        assert r == 21 < m
    lam = min(order, n - r)
    pairs = build_osd_consts(g, "osd_cs", order).pairs
    h_cols = g.H_cols.numpy().view(np.uint32)
    perm_t, synd_t = torch.as_tensor(perm), torch.as_tensor(synd)
    plain = eliminate_plain(g, perm_t, synd_t)
    ref = j_eliminate(JTannerGraph(H), jnp.asarray(perm), jnp.asarray(synd.astype(np.int32)))
    want0, wantw = osd_decode_plain(g, perm_t, synd_t, method="osd_cs", osd_order=order,
                                    pairs=pairs)
    for b in range(synd.shape[0]):
        M, prow = k5_eliminate(h_cols, perm[b], synd[b], r, P)
        mine = k5_elimination_outputs(M, prow, perm[b], m, r)
        for name, got, p_out, j_out in zip(plain._fields, mine, plain, ref):
            p_np = p_out[b].numpy()
            if name == "h_work":
                p_np = p_np.view(np.uint32)
            assert np.array_equal(got, p_np), (name, b)
            assert np.array_equal(got, np.asarray(j_out[b]).astype(got.dtype)), (name, b)
        e0, ew = k5_decode(h_cols, perm[b], synd[b], r, P, lam, pairs)
        assert np.array_equal(e0, want0[b].numpy()) and np.array_equal(ew, wantw[b].numpy())


def _count_elimination(h_cols, perm, synd, rank):
    """The column elimination of one sample replayed and counted: column
    steps, pivot steps, hit tests at pivot steps (n - t), hit columns after
    t (syndrome included), XORed words (hits x nonzero words of S) and the
    32-byte sectors those words span column-major (hits x 8-word groups of
    S holding a nonzero word)."""
    n, Wm = h_cols.shape
    M = np.zeros((n + 1, Wm), np.uint32)
    M[:n] = h_cols[perm]
    M[n] = _pack_bits(synd)
    used = np.zeros(Wm, np.uint32)
    steps = pivots = tests = hits = xors = sectors = 0
    for t in range(n):
        if pivots >= rank:
            break
        steps += 1
        x = M[t] & ~used
        nz = np.flatnonzero(x)
        if not nz.size:
            continue
        w = int(nz[0])
        pbit = np.uint32(1 << int(np.flatnonzero(_unpack_bits(x[w:w + 1], 32))[0]))
        S = M[t].copy()
        S[w] &= ~pbit
        used[w] |= pbit
        later = t + 1 + np.flatnonzero(M[t + 1:, w] & pbit)
        groups = np.count_nonzero(np.pad(S, (0, -Wm % 8)).reshape(-1, 8).any(1))
        pivots += 1
        tests += n - t
        hits += len(later)
        xors += len(later) * np.count_nonzero(S)
        sectors += len(later) * groups
        M[later] ^= S
    return steps, pivots, tests, hits, xors, sectors


@pytest.mark.parametrize("code", ["flagship_corpus", "lift60", "rank_deficient"])
def test_chip_smoke_elim_work_counts(code):
    """:func:`bp_osd_tpu_torch.utils.measure.elim_work`, from which
    ``chip_smoke.py`` and ``bench_torch.py`` count the OSD kernels' bounds,
    gives per row the counts of a direct replay of the elimination; the
    needed operations are 2 Wm a step (the pivot search), 2 a hit test and 1
    an XORed word, and never more than the earlier count over every column."""
    H, synd, perm, _ = _case(code)
    g = TannerGraph(H, device="cpu")
    work = elim_work(g, torch.as_tensor(perm), torch.as_tensor(synd))
    h_cols = g.H_cols.numpy().view(np.uint32)
    Wm = h_cols.shape[1]
    for b in range(synd.shape[0]):
        want = _count_elimination(h_cols, perm[b], synd[b], g.rank)
        got = tuple(int(getattr(work, f)[b]) for f in work._fields[:6])
        assert got == want, (code, b)
        assert want[1] == g.rank
    steps, tests, xors = (int(getattr(work, f).sum()) for f in ("steps", "pivot_tests",
                                                                 "xor_words"))
    assert work.ops == 2 * Wm * steps + 2 * tests + xors
    assert work.ops < work.ops_all_columns


def test_k5_shared_memory_mirror():
    """``osd_large_smem_bytes`` (mirror of ``csrc/osd_large.cu``) is the
    formula of the kernel's layout; the panel is the widest up to 16 columns
    (and n) that fits 232,448 bytes: at lift 400 two panels of 16 columns
    and the rest take 63,286 bytes, and a 30000 x 30000 code narrows the
    panel to 11."""
    for m, n, lam, P in ((4800, 10000, 15, 16), (720, 1500, 15, 7), (192, 400, 0, 1)):
        Wm = -(-m // 32)
        words = 2 * P * (Wm | 1) + 6 * Wm + max(lam, 1) + 10
        assert osd_large_smem_bytes(m, n, lam, P) == 8 * 32 + 4 * words + 2 * (2 * n + 1)
    assert osd_large_smem_bytes(4800, 10000, 15, 16) == 63_286
    assert osd_large_panel(4800, 10000, 15) == 16 and osd_large_panel(192, 400, 42) == 16
    assert osd_large_panel(60, 12, 3) == 12  # never wider than the code
    P = osd_large_panel(30000, 30000, 15)
    assert P == 11 and osd_large_smem_bytes(30000, 30000, 15, P) <= _SMEM_LIMIT
    assert osd_large_smem_bytes(30000, 30000, 15, P + 1) > _SMEM_LIMIT


def test_k3_fits_is_k2s_fit_and_routes_hold():
    """K3 runs K2's warp layout, so it takes exactly the graphs K2 takes at
    the same order: the flagship and the surface code at orders up to 16,
    not lift 60 (291,248 bytes at order 15 for one warp and the shared H),
    whose osd_e goes to K4; the routes of the flagship and lift-60/100 osd_e
    decoders are unchanged."""
    flagship = TannerGraph(np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8), device="cpu")
    lift60 = TannerGraph(np.asarray(lifted_hgp(PROTO, lift=60).hx.toarray(), np.uint8),
                         device="cpu")
    lift100 = TannerGraph(np.asarray(lifted_hgp(PROTO, lift=100).hx.toarray(), np.uint8),
                          device="cpu")
    for g in (flagship, lift60, lift100):
        for order in (1, 2, 8, 12, 16):
            assert k3_fits(g, order) == k2_fits(g, order)
    assert all(k3_fits(flagship, o) for o in (1, 12, 16))
    assert osd_cs_warp_smem_bytes(720, 1500, 15) == 291_248 > _SMEM_LIMIT
    assert not k3_fits(lift60, 8) and not k3_fits(lift100, 8)
    assert [osd_route(flagship, "osd_e", o) for o in (1, 12, 16)] == ["k3"] * 3
    assert osd_route(lift60, "osd_e", 8) == "k4" and osd_route(lift100, "osd_e", 8) == "k4"
