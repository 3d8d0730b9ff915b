"""Kernel K4's warp design (``csrc/osd_cs.cu:gf2_elim_warp_kernel``) on the
CPU: the elimination and the write-out emulated in numpy step for step,
against the port's plain version and the JAX package; the Python mirror of
its shared memory; and the kernel that ``placement="auto"`` picks.

The emulation keeps what the kernel keeps: the columns in reliability
order, column-major (``warp_eliminate``: every column holding the pivot
row's bit takes the pivot column without its pivot bit, the earlier ones and
the pivot column itself included), then the pivot lists by a ballot prefix
count over 32 lanes, the inverse of perm, and ``h_work`` from 32 x 32 bit
tiles, lane j holding original column 32 w + j, transposed by the kernel's
five butterfly steps (lane j and lane j ^ s swap their s x s blocks off the
diagonal).  A wrong inverse or bit order gives a matrix that still reduces
every syndrome but differs from JAX's: only the five-output equality sees
it, and a shifted inverse perm is shown to fail.  All of it is integer work,
so every comparison is exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder.osd import _eliminate as j_eliminate
from bp_osd_tpu.ops.pallas_gf2 import eliminate_pallas

from bp_osd_tpu_torch.codes import (hgp, lifted_hgp, mkmn_16_4_6, mkmn_20_5_8, mkmn_24_6_10,
                                    rep_code)
from bp_osd_tpu_torch.decoder.osd import eliminate_plain, osd_route
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.ops.cuda_bp import _SMEM_LIMIT
from bp_osd_tpu_torch.ops.cuda_gf2 import (gf2_elim_smem_bytes, gf2_elim_warp_smem_bytes,
                                           k4_fits, k4_placement, k4_warp_fits)
from bp_osd_tpu_torch.ops.cuda_osd import k2_fits, osd_cs_warp_smem_bytes

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "flagship_corpus.npz")
PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]
LANES = np.arange(32)


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """Bits ``[..., k]`` to uint32 words ``[..., ceil(k/32)]``, bit i of word w
    is entry 32 w + i."""
    k = bits.shape[-1]
    W = -(-k // 32)
    pad = np.zeros(bits.shape[:-1] + (32 * W,), np.uint64)
    pad[..., :k] = bits
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (pad.reshape(bits.shape[:-1] + (W, 32)) * weights).sum(-1).astype(np.uint32)


def _bit(word, i) -> int:
    return int((int(word) >> int(i)) & 1)


def warp_eliminate(h_cols, perm, synd, rank):
    """``warp_eliminate`` of one sample: ``h_cols [n, Wm]`` uint32 (the
    column-packed H), ``perm [n]``, ``synd [m]``.  Returns the reduced
    columns ``[n + 1, Wm]`` (the syndrome as column n) and ``prow [n]``."""
    n, Wm = h_cols.shape
    cols = np.zeros((n + 1, Wm), np.uint32)
    cols[:n] = h_cols[perm]
    cols[n] = _pack_bits(synd)
    used = np.zeros(Wm, np.uint32)
    prow = np.full(n, -1, np.int64)
    rr = 0
    for t in range(n):
        if rr >= rank:
            break
        x = cols[t] & ~used
        hit = np.flatnonzero(x)  # the words of the ballot
        if not hit.size:
            continue
        pw = int(hit[0])
        pb = next(i for i in range(32) if _bit(x[pw], i))
        pbit = np.uint32(1 << pb)
        S = cols[t].copy()
        S[pw] &= ~pbit
        used[pw] |= pbit
        prow[t] = 32 * pw + pb
        cols[np.flatnonzero(cols[:, pw] & pbit)] ^= S  # column t too: its unit vector
        rr += 1
    return cols, prow


def transpose32(x: np.ndarray) -> np.ndarray:
    """The kernel's ``transpose32`` over the 32 lanes: ``x[j]`` is row j of a
    bit tile, the result's lane i its column i."""
    x = x.astype(np.uint32)
    for s in (16, 8, 4, 2, 1):
        lo = np.uint32(0xFFFFFFFF // ((1 << s) + 1))
        y = x[LANES ^ s]  # __shfl_xor_sync(x, s)
        x = np.where(LANES & s, (x & ~lo) | ((y & ~lo) >> s), (x & lo) | ((y & lo) << s))
    return x.astype(np.uint32)


def k4_warp(h_cols, perm, synd, m, rank, inv_shift=0):
    """K4's warp kernel for one sample: the five outputs, h_work as uint32.
    ``inv_shift`` corrupts the inverse perm (the mutation check)."""
    n, Wm = h_cols.shape
    W = -(-n // 32)
    cols, prow = warp_eliminate(h_cols, perm, synd, rank)
    pid = np.zeros(rank, np.int32)
    prw = np.zeros(rank, np.int32)
    pmask = np.zeros(n, bool)
    inv = np.zeros(n, np.int64)
    cnt = 0
    for base in range(0, n, 32):  # the ballot prefix count over t
        t = base + LANES
        p = np.where(t < n, prow[np.minimum(t, n - 1)], -1)
        mask = sum(1 << int(j) for j in LANES[p >= 0])
        for j in LANES[t < n]:
            pos = cnt + bin(mask & ((1 << int(j)) - 1)).count("1")
            inv[perm[t[j]]] = t[j]
            pmask[t[j]] = p[j] >= 0
            if p[j] >= 0 and pos < rank:
                pid[pos], prw[pos] = perm[t[j]], p[j]
        cnt += bin(mask).count("1")
    inv = (inv + inv_shift) % n
    s_work = np.array([_bit(cols[n][r >> 5], r & 31) for r in range(m)], np.int32)
    h_work = np.zeros((m, W), np.uint32)
    for w in range(W):
        oc = 32 * w + LANES
        for rw in range(Wm):
            x = np.where(oc < n, cols[inv[np.minimum(oc, n - 1)], rw], 0)
            rows = 32 * rw + LANES
            h_work[rows[rows < m], w] = transpose32(x)[rows < m]
    return h_work, s_work, pid, prw, pmask


def _rank_deficient():
    """A random 24 x 60 code whose last rows are sums of others (rank 21)."""
    rng = np.random.default_rng(17)
    H = (rng.random((24, 60)) < 0.12).astype(np.uint8)
    H[21] = H[0] ^ H[1]
    H[22] = H[2] ^ H[3] ^ H[4]
    H[23] = H[5] ^ H[21]
    return H


def _case(code, B):
    """(H, syndromes, perms) of ``B`` rows of each code."""
    rng = np.random.default_rng(11)
    if code == "flagship_corpus":
        data = np.load(CORPUS)
        H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
        synd = np.unpackbits(data["synd_packed"], axis=1)[:B, :H.shape[0]]
    else:
        H = {"rank_deficient": _rank_deficient,
             "625": lambda: hgp(mkmn_20_5_8()).hx.toarray(),
             "surface": lambda: hgp(rep_code(3), rep_code(3)).hx.toarray()}[code]()
        H = np.asarray(H, np.uint8)
        err = (rng.random((B, H.shape[1])) < 0.06).astype(np.uint8)
        synd = (err @ H.T % 2).astype(np.uint8)
    perm = np.argsort(rng.normal(0, 1, (B, H.shape[1])), axis=1, kind="stable").astype(np.int32)
    return H, synd, perm


# flagship: m = 192, n = 400; rank_deficient 24 x 60 (rank 21); [[625]]: 300 x 625;
# surface 6 x 13 -- all but the flagship's m ragged against 32
@pytest.mark.parametrize("code,B", [("flagship_corpus", 6), ("rank_deficient", 6),
                                    ("625", 3), ("surface", 6)])
def test_k4_warp_emulation_equals_plain_and_jax(code, B):
    """The emulated warp kernel gives the five outputs of ``eliminate_plain``,
    JAX ``_eliminate`` and ``eliminate_pallas(interpret=True)`` on every live
    row, and zeros on skipped rows (every third, as the kernel writes them)."""
    H, synd, perm = _case(code, B)
    g = TannerGraph(H, device="cpu")
    m, r = g.m, g.rank
    if code == "rank_deficient":
        assert r == 21 < m
    skip = np.arange(B) % 3 == 1
    h_cols = g.H_cols.numpy().view(np.uint32)
    plain = eliminate_plain(g, torch.as_tensor(perm), torch.as_tensor(synd),
                            skip=torch.as_tensor(skip))
    jg = JTannerGraph(H)
    jskip = jnp.asarray(skip.astype(np.int32))
    refs = (j_eliminate(jg, jnp.asarray(perm), jnp.asarray(synd.astype(np.int32)), skip=jskip),
            eliminate_pallas(jg, perm, synd.astype(np.int32), skip=jskip, block=8,
                             interpret=True))
    for b in range(B):
        mine = (tuple(np.zeros_like(x) for x in k4_warp(h_cols, perm[b], synd[b], m, r))
                if skip[b] else k4_warp(h_cols, perm[b], synd[b], m, r))
        for name, got, p_out, *j_outs in zip(plain._fields, mine, plain, *refs):
            p_np = p_out[b].numpy()
            if name == "h_work":
                p_np = p_np.view(np.uint32)
            assert got.dtype == p_np.dtype and np.array_equal(got, p_np), (name, b)
            if not skip[b]:
                for j_out in j_outs:
                    assert np.array_equal(got, np.asarray(j_out[b]).astype(got.dtype)), (name, b)


@pytest.mark.parametrize("code", ["flagship_corpus", "rank_deficient"])
def test_k4_warp_emulation_catches_a_shifted_inverse_perm(code):
    """The mutation check: with the inverse perm shifted by one column the
    emulated ``h_work`` differs from ``eliminate_plain``'s (the four other
    outputs do not read the inverse)."""
    H, synd, perm = _case(code, 2)
    g = TannerGraph(H, device="cpu")
    h_cols = g.H_cols.numpy().view(np.uint32)
    plain = eliminate_plain(g, torch.as_tensor(perm), torch.as_tensor(synd))
    for b in range(2):
        bad = k4_warp(h_cols, perm[b], synd[b], g.m, g.rank, inv_shift=1)
        assert not np.array_equal(bad[0], plain.h_work[b].numpy().view(np.uint32))
        assert np.array_equal(bad[1], plain.s_work[b].numpy())


def test_transpose32_is_the_bit_transpose():
    """The five butterfly steps transpose a random 32 x 32 bit tile."""
    bits = (np.random.default_rng(3).random((32, 32)) < 0.5).astype(np.uint8)
    got = transpose32(_pack_bits(bits)[:, 0])
    assert np.array_equal(got, _pack_bits(bits.T)[:, 0])


def _graph(name):
    H = {"surface": lambda: hgp(rep_code(3), rep_code(3)).hx,
         "flagship": lambda: hgp(mkmn_16_4_6()).hx,
         "625": lambda: hgp(mkmn_20_5_8()).hx,
         "900": lambda: hgp(mkmn_24_6_10()).hx,
         "lift60": lambda: lifted_hgp(PROTO, lift=60).hx,
         "lift100": lambda: lifted_hgp(PROTO, lift=100).hx}[name]()
    return TannerGraph(np.asarray(H.toarray(), np.uint8), device="cpu")


def test_k4_warp_shared_memory_mirror():
    """``gf2_elim_warp_smem_bytes`` (mirror of ``csrc/osd_cs.cu``) is K2's
    layout at order 0 with n int16 more a warp for the inverse perm: 20,856
    bytes for one flagship sample with the shared H (9,600 bytes), so a block
    holds 19 flagship samples and not 20."""
    for m, n in ((192, 400), (300, 625), (6, 13), (24, 60), (720, 1500)):
        Wm = -(-m // 32)
        Wp = Wm + Wm % 2
        per_warp = (n + 1) * Wp + (n + 1) // 2 + 1 + Wm + (n + 1) // 2
        per_warp += per_warp % 2
        for warps in (1, 7):
            assert gf2_elim_warp_smem_bytes(m, n, warps) == 4 * (n * Wp + warps * per_warp)
        # the inverse perm starts after K2's slice at order 0 (unrounded) and
        # its n int16 end inside the warp's slice
        k2_words = osd_cs_warp_smem_bytes(m, n, 0, 1) // 4 - n * Wp
        assert k2_words - 1 <= (n + 1) * Wp + (n + 1) // 2 + 1 + Wm <= k2_words
        assert 4 * ((n + 1) * Wp + (n + 1) // 2 + 1 + Wm) + 2 * n <= 4 * per_warp
    assert gf2_elim_warp_smem_bytes(192, 400) == 20_856
    assert gf2_elim_warp_smem_bytes(192, 400, 19) <= _SMEM_LIMIT
    assert gf2_elim_warp_smem_bytes(192, 400, 20) > _SMEM_LIMIT
    assert gf2_elim_smem_bytes(192, 400) == 10_068  # the block kernel's size is kept


def test_k4_auto_placement_table():
    """``placement="auto"`` takes the warp kernel on the surface code, the
    flagship, [[625]] and [[900]], which covers every osd0 decode that
    ``osd_route`` sends to K4; the block kernel keeps lift 60 in shared
    memory (the warp layout needs 294,192 bytes there) and lift 100 in
    device memory, the osd_e route of codes K3 cannot hold."""
    want = {"surface": "warp", "flagship": "warp", "625": "warp", "900": "warp",
            "lift60": "shared", "lift100": "global"}
    for name, place in want.items():
        g = _graph(name)
        assert k4_placement(g) == place, name
        assert k4_warp_fits(g) == (place == "warp") and k4_fits(g) == (name != "lift100")
        if osd_route(g, "osd0", 0) == "k4":
            assert k2_fits(g, 0) and place == "warp", name
        else:
            assert osd_route(g, "osd_e", 8) == "k4" and place != "warp", name
    assert gf2_elim_warp_smem_bytes(720, 1500) == 294_192
