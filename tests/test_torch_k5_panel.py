"""Kernel K5's design (``csrc/osd_large.cu``) on the CPU: its blocked
elimination in the word-major layout and its sweep, emulated in numpy step
for step, against the port's plain versions and the JAX package, with the
far trailing passes made by one block or split among a cluster's members;
the rule that picks the cluster plan; the Python mirror of its shared
memory; the elimination counts ``utils/measure.py``
counts the OSD kernels' bounds from; K3's fit and the unchanged OSD
routing.

The emulation keeps what the kernel keeps where the kernel keeps it: the
matrix word-major (word w of every column contiguous) in "device memory",
two panel buffers of P columns (column-major) and a record of each
factorised panel: its pivot rows r_i, each S_i as dense words, the bit table
L[i][j] = S_j[r_i], the distinct words of the pivot rows and the union of
the S_i's nonzero words.  Warp 0 factorises panel k in its buffer; the
workers write panel k back, load panel k + 1 into the other buffer and take
it past panel k (the look-ahead), then take panel k to every column after
panel k + 1 in device memory in one trailing pass, while warp 0 factorises
panel k + 1: each column's bits at the pivot rows, g from L, the union's
words XORed.  A stale record, a missed or repeated pass, a missed
write-back or an update sent to the wrong copy changes the result, which
every comparison below would see.  All of it is integer work, so every
comparison is exact.
"""

import os
from typing import NamedTuple

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
from bp_osd_tpu_torch.ops.cuda_osd_large import (_MAX_PANEL, osd_large_cluster,
                                                 osd_large_panel, osd_large_smem_bytes)
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


class PanelRecord(NamedTuple):
    """A factorised panel, as warp 0 leaves it in shared memory."""

    r: list  # pivot rows r_i, in pivot order
    buf: np.ndarray  # [P, Wm] the panel's buffer (a view): S_i is its column tc[i]
    tc: list  # the pivot columns' places in the panel
    L: list  # bit j of L[i] (j < i): S_j carries row r_i
    N: list  # column j of (I + L)^-1 as bits: g = XOR of N[j] over the bits j of cb
    pw: list  # the distinct words of the pivot rows, in order of first use
    pm: list  # their pivot-row bits
    piv: dict  # (d, bit) -> the pivot index of that row
    Uw: list  # the words where some S_i is nonzero, ascending
    Unz: list  # which S_i are nonzero at each

    @property
    def q(self) -> int:
        return len(self.r)

    @property
    def S(self) -> np.ndarray:
        """[q, Wm] S_i: pivot column t_i at its step without the pivot bit,
        read from the panel's buffer now (warp 0 cleared the pivot bit there)."""
        return self.buf[self.tc]


def _low_bit(x) -> int:
    return (int(x) & -int(x)).bit_length() - 1


def _bits(x: int):
    while x:
        yield _low_bit(x)
        x &= x - 1


def _factorise(k, P, n, rank, slot, buf, used, prow, t, rr):
    """Warp 0 on panel k, columns [k P, min(n, (k + 1) P)) in their buffer
    ``buf``, left-looking in the panel: each column it reaches first takes
    the panel's pivots so far (:func:`_catch_up`), then the pivot search,
    the pivot bit cleared in place (so the column is S), the dependent
    columns passed over, until the panel's end or rank pivots; the panel's
    columns after rank pivots catch up too.  Row i of (I + L)^-1 is e_i XOR
    the rows j < i that L[i] names (lane i's register in the kernel), its
    columns the record's N.  Returns the record and the next (t, rr)."""
    tend = min(n, (k + 1) * P)
    r, tc, L, Nrow = [], [], [], []
    while t < tend and rr < rank:
        _catch_up(slot(t), buf, r, tc, Nrow)
        x = slot(t) & ~used
        nz = np.flatnonzero(x)
        if not nz.size:  # a dependent column: on to the next
            t += 1
            continue
        pw = int(nz[0])
        pr = 32 * pw + _low_bit(x[pw])
        pbit = np.uint32(1 << (pr & 31))
        s = slot(t)
        s[pw] &= ~pbit
        used[pw] |= pbit
        prow[t] = pr
        Lq = sum(((int(buf[j_t, pw]) >> (pr & 31)) & 1) << j for j, j_t in enumerate(tc))
        row = 1 << len(tc)
        for j in _bits(Lq):
            row ^= Nrow[j]
        L.append(Lq)
        Nrow.append(row)
        r.append(pr)
        tc.append(t - k * P)
        t += 1
        rr += 1
    for c in range(t, tend):  # rank reached
        _catch_up(slot(c), buf, r, tc, Nrow)
    Wm = len(used)
    pw, pm, piv = [], [], {}
    for i, ri in enumerate(r):
        if ri >> 5 not in pw:
            pw.append(ri >> 5)
            pm.append(0)
        d = pw.index(ri >> 5)
        pm[d] |= 1 << (ri & 31)
        piv[d, ri & 31] = i
    N = [sum(((Nrow[i] >> j) & 1) << i for i in range(len(r))) for j in range(len(r))]
    Smat = buf[tc]
    nzw = [sum(1 << i for i in range(len(tc)) if Smat[i, w]) for w in range(Wm)]
    Uw = [w for w in range(Wm) if nzw[w]]
    return PanelRecord(r, buf, tc, L, N, pw, pm, piv, Uw, [nzw[w] for w in Uw]), t, rr


def _catch_up(col, buf, r, tc, Nrow):
    """``col`` (a view of its buffer) past the panel's pivots so far, as
    warp 0's ``catch_up`` takes it when it reaches the column: cb_i =
    col[r_i], g = (I + L)^-1 cb (the XOR of its columns at cb's bits, the
    rows ``Nrow`` read by column), then col ^= the S_i that g selects."""
    cb = sum(((int(col[ri >> 5]) >> (ri & 31)) & 1) << i for i, ri in enumerate(r))
    g = 0
    for j in _bits(cb):
        g ^= sum(((Nrow[i] >> j) & 1) << i for i in range(len(r)))
    for i in _bits(g):
        col ^= buf[tc[i]]


def _pass_g(rec, cols):
    """Each column's g: cb_i = c[r_i] read from the distinct pivot words,
    then g = (I + L)^-1 cb, the XOR of N's columns at cb's bits (that is,
    g_i = cb_i ^ parity(g & L[i]) in pivot order)."""
    one = np.uint64(1)
    cb = np.zeros(cols.shape[1], np.uint64)
    for d, (w, pm) in enumerate(zip(rec.pw, rec.pm)):
        x = cols[w] & np.uint32(pm)
        for bit in _bits(pm):
            cb |= ((x >> np.uint32(bit)) & 1).astype(np.uint64) << np.uint64(rec.piv[d, bit])
    g = np.zeros_like(cb)
    for j, Nj in enumerate(rec.N):
        g ^= np.where((cb >> np.uint64(j)) & one, np.uint64(Nj), np.uint64(0))
    return g


def _union_xor(rec, cols, g):
    """Each union word of the columns XORed with the S_i that g selects."""
    one = np.uint64(1)
    S = rec.S
    for w, nz in zip(rec.Uw, rec.Unz):
        gm = g & np.uint64(nz)
        v = np.zeros(cols.shape[1], np.uint32)
        for i in _bits(nz):
            v ^= np.where((gm >> np.uint64(i)) & one, S[i, w], np.uint32(0))
        cols[w] ^= v


def _panel_apply(rec, cols):
    """The workers take the next panel's ``cols [Wm, P]`` (a view of its
    buffer) past a panel in shared memory: g, then the union's words."""
    _union_xor(rec, cols, _pass_g(rec, cols))


def _trailing_pass(rec, cols):
    """The workers take ``cols [Wm, C]`` (a view of device memory) past a
    panel in one pass: g for every column, then for a hit column with one
    pivot that S_i's nonzero words, for one with more the union's words."""
    g = _pass_g(rec, cols)
    one_pivot = (g != 0) & ((g & (g - np.uint64(1))) == 0)
    S = rec.S
    for i in range(rec.q):
        hit = np.flatnonzero(one_pivot & (g == np.uint64(1 << i)))
        words = np.flatnonzero(S[i])
        cols[np.ix_(words, hit)] ^= S[i, words][:, None]
    _union_xor(rec, cols, np.where(one_pivot, np.uint64(0), g))


def member_ranges(cs: int, n: int, members: int) -> list:
    """The columns of a far trailing pass from ``cs`` (the syndrome column n
    included) that each of a cluster's ``members`` passes, as
    ``csrc/osd_large.cu``'s members split them: from ``cs`` rounded down to
    a multiple of four, shares of a multiple of four columns, each member's
    ``[lo, hi)``; a member whose share starts past n passes nothing."""
    base = cs & ~3
    per = ((n + 1 - base + members - 1) // members + 3) & ~3
    out = []
    for mi in range(members):
        lo, hi = base + mi * per, min(n + 1, base + (mi + 1) * per)
        if lo < hi:
            out.append((max(lo, cs), hi))
    return out


def k5_eliminate(h_cols, perm, synd, rank, P, records=None, members=0):
    """K5's elimination of one sample: ``h_cols [n, Wm]`` uint32 (the
    column-packed H), ``perm [n]``, ``synd [m]``.  Returns the device
    matrix ``M [Wm, n + 1]`` after the final write-back (word-major: column
    c is ``M[:, c]``, the syndrome column n) and ``prow [n]``; appends each
    panel's record to ``records`` when given.  With ``members`` the far
    trailing passes are the cluster plan's: each member passes its share of
    the columns (:func:`member_ranges`).

    Panel j lives in buffer j % 3, and its record's S_i are read from
    there, so the buffer must outlive the record.  While warp 0 factorises panel k, the
    workers write panel k - 1 back, load panel k + 1, take it past panel
    k - 1 in its buffer and take panel k - 1 to the columns after panel
    k + 1 in device memory (disjoint data, so the order here is free);
    after panel k's barrier they take panel k + 1 past panel k."""
    n, Wm = h_cols.shape
    M = np.zeros((Wm, n + 1), np.uint32)
    M[:, :n] = h_cols[perm].T
    M[:, n] = _pack_bits(synd)
    panels = np.zeros((3, P, Wm), np.uint32)  # the three buffers, column-major

    def slot(c):  # panel c // P lives in buffer (c // P) % 3
        return panels[(c // P) % 3, c % P]

    def buffer_of(j):  # panel j's columns in its buffer, [Wm, width]
        return panels[j % 3].T[:, :max(0, min(n, (j + 1) * P) - j * P)]

    def write_back(j):
        for c in range(j * P, min(n, (j + 1) * P)):
            M[:, c] = slot(c)

    def far_pass(rec, cs):  # a block's workers, or each member on its share
        for lo, hi in member_ranges(cs, n, members) if members else [(cs, n + 1)]:
            _trailing_pass(rec, M[:, lo:hi])

    for c in range(min(P, n)):
        slot(c)[:] = M[:, c]
    used = np.zeros(Wm, np.uint32)
    prow = np.full(n, -1, np.int64)
    t = rr = k = 0
    prev = None
    while True:
        # the workers, while warp 0 factorises panel k
        if k > 0:
            write_back(k - 1)
        for c in range((k + 1) * P, min(n, (k + 2) * P)):
            slot(c)[:] = M[:, c]
        if prev is not None and prev.q:
            _panel_apply(prev, buffer_of(k + 1))
            far_pass(prev, min(n, (k + 2) * P))
        rec, t, rr = _factorise(k, P, n, rank, slot, panels[k % 3], used, prow, t, rr)
        if records is not None:
            records.append(rec)
        done = t >= n or rr >= rank
        if rec.q:  # after the barrier: panel k + 1 past panel k
            _panel_apply(rec, buffer_of(k + 1))
        if done:
            write_back(k)
            write_back(k + 1)
            if rec.q:
                far_pass(rec, min(n, (k + 2) * P))
            break
        prev = rec
        k += 1
    return M, prow


def k5_decode(h_cols, perm, synd, rank, P, lam, pairs):
    """K5 for one sample: the elimination, T, the sweep (zero pattern,
    weight 1 on every non-pivot column, weight 2 on ``pairs`` of the first
    lam T columns; first minimum of ``weight << 32 | candidate rank``) and
    the read-off.  Returns (osd0, osdw) in original coordinates."""
    M, prow = k5_eliminate(h_cols, perm, synd, rank, P)
    return _decode_from(M, prow, perm, lam, pairs)


def _decode_from(M, prow, perm, lam, pairs):
    """The sweep and the read-off of :func:`k5_decode` on K5's reduced
    matrix ``M`` and pivot rows ``prow``."""
    n = len(perm)
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


@pytest.mark.parametrize("members", [1, 3, 7, 15])
@pytest.mark.parametrize("code", ["lift60", "rank_deficient"])
def test_k5_cluster_emulation_equals_plain(code, members):
    """With the far trailing passes split among a cluster's 1, 3 or 7
    members (clusters of 2, 4 and 8 blocks; 15, beyond what the kernel
    launches, for the split alone), panels of 7 and of 32 columns,
    the emulated K5 still gives ``eliminate_plain``'s five outputs and
    ``osd_decode_plain``'s osd0/osdw: a column passed twice or missed by the
    split would change them."""
    H, synd, perm, order = _case(code)
    g = TannerGraph(H, device="cpu")
    m, r = g.m, g.rank
    lam = min(order, g.n - r)
    pairs = build_osd_consts(g, "osd_cs", order).pairs
    h_cols = g.H_cols.numpy().view(np.uint32)
    perm_t, synd_t = torch.as_tensor(perm), torch.as_tensor(synd)
    plain = eliminate_plain(g, perm_t, synd_t)
    want0, wantw = osd_decode_plain(g, perm_t, synd_t, method="osd_cs", osd_order=order,
                                    pairs=pairs)
    for P in (7, 32):
        for b in range(synd.shape[0]):
            M, prow = k5_eliminate(h_cols, perm[b], synd[b], r, P, members=members)
            mine = k5_elimination_outputs(M, prow, perm[b], m, r)
            for name, got, p_out in zip(plain._fields, mine, plain):
                p_np = p_out[b].numpy()
                assert np.array_equal(got, p_np.view(np.uint32) if name == "h_work" else p_np)
            e0, ew = _decode_from(M, prow, perm[b], lam, pairs)
            assert np.array_equal(e0, want0[b].numpy()) and np.array_equal(ew, wantw[b].numpy())


@pytest.mark.parametrize("n,members", [(59, 7), (1500, 3), (10000, 7), (10000, 15), (2736, 1)])
def test_k5_member_ranges_split_the_far_columns(n, members):
    """Every far pass's columns [cs, n] fall to exactly one member, in
    ascending shares that start at a multiple of four (the 16-byte loads of
    four neighbouring columns) after the first."""
    for cs in sorted({0, 1, 3, 4, 5, 32, 96, n // 3, n - 5, n - 1, n} - {-1}):
        if not 0 <= cs <= n:
            continue
        ranges = member_ranges(cs, n, members)
        assert len(ranges) <= members
        cols = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
        assert np.array_equal(cols, np.arange(cs, n + 1)), (cs, ranges)
        assert all(lo % 4 == 0 for lo, _ in ranges[1:])


_H100 = {2: 66, 4: 30, 8: 15}  # clusters resident at once at lift 400 (H100, 132 SMs)


@pytest.mark.parametrize("B,want", [(1, 8), (2, 8), (15, 8), (16, 4), (17, 4), (30, 4), (31, 2),
                                    (66, 2), (67, 1), (129, 1), (132, 1)])
def test_k5_cluster_rule(B, want):
    """The most blocks a sample, of 8, 4 and 2, whose B clusters fit the
    card at once (B x C <= 132 SMs and B <= the clusters of C blocks it
    holds together: 15 of 8 on an H100, so 16 rows take clusters of 4);
    else a block a sample, as a heavy batch's 129 rows do."""
    assert osd_large_cluster(B, 132, _H100.get) == want


def test_k5_cluster_rule_without_room():
    """A card that holds no cluster (or too few) gives a block a sample or
    the next smaller cluster; the SMs bound C x B on their own."""
    assert [osd_large_cluster(B, 132, lambda c: 0) for B in (1, 8, 66)] == [1, 1, 1]
    assert osd_large_cluster(16, 132, {2: 66, 4: 30, 8: 16}.get) == 8
    assert osd_large_cluster(4, 132, {2: 66, 4: 3, 8: 3}.get) == 2
    assert [osd_large_cluster(B, 8, {2: 4, 4: 2, 8: 1}.get) for B in (1, 2, 4, 5)] == [8, 4, 2, 1]
    asked = []
    assert osd_large_cluster(70, 132, lambda c: asked.append(c) or 99) == 1 and asked == []


def test_k5_cluster_residency_asked_once(monkeypatch):
    """The wrapper asks the CUDA runtime for a shape's resident clusters once a
    card and shape (the answer depends on nothing else), not at every
    launch; another card, shape or cluster size asks again."""
    import types

    import bp_osd_tpu_torch.ops.cuda_osd_large as k5

    asked = []

    def ask(n, Wm, lam, panel, cluster, out):
        asked.append((n, Wm, lam, panel, cluster))
        out[0], out[1] = 64, _H100[cluster]
        return 0

    monkeypatch.setattr(k5, "_build", types.SimpleNamespace(
        load=lambda: types.SimpleNamespace(osd_large_clusters=ask)))
    k5._clusters.cache_clear()
    try:
        got = [k5._clusters(0, 10000, 150, 15, 32, c) for c in (8, 4, 8, 8, 2, 4)]
        assert got == [(64, 15), (64, 30), (64, 15), (64, 15), (64, 66), (64, 30)]
        assert asked == [(10000, 150, 15, 32, 8), (10000, 150, 15, 32, 4),
                         (10000, 150, 15, 32, 2)]
        k5._clusters(1, 10000, 150, 15, 32, 8)
        k5._clusters(0, 2736, 30, 7, 32, 8)
        assert len(asked) == 5
        assert [osd_large_cluster(B, 132, lambda c: k5._clusters(0, 10000, 150, 15, 32, c)[1])
                for B in (1, 16, 31, 66, 67)] == [8, 4, 2, 2, 1] and len(asked) == 5
    finally:
        k5._clusters.cache_clear()


def _schedule_case(case):
    """(H, P, syndromes, perm) of a code built for one corner of the panel
    schedule; the perm is the identity, so column t of H is column t of the
    elimination."""
    rng = np.random.default_rng({"l_table": 3, "empty_panel": 4, "rank_mid_panel": 5}[case])
    m, n, P = 8, 20, 4
    if case == "l_table":
        # column 0 pivots on row 0 with S_0 = {row 1}; column 1 pivots on
        # row 1: L[1][0] = 1.  Columns 5, 9, 13 carry row 0 and not row 1, so
        # each takes S_0 and then S_1 (g = 0b11 from bits 0b01)
        H = (rng.random((m, n)) < 0.3).astype(np.uint8)
        H[:, :2] = 0
        H[[0, 1], 0] = 1
        H[[1, 2], 1] = 1
        for c in (5, 9, 13):
            H[:, c] = 0
            H[[0, 3 + c % 4], c] = 1
    elif case == "empty_panel":
        # panel 1 (columns 4-7) repeats panel 0's independent columns: no pivot
        A = np.eye(m, P, dtype=np.uint8) ^ np.triu((rng.random((m, P)) < 0.5), 1).astype(np.uint8)
        H = np.concatenate([A, A[:, ::-1], (rng.random((m, n - 2 * P)) < 0.4)], 1)
        H = H.astype(np.uint8)
    else:
        # rank 6: columns 0-4 and 9 independent, every other column a sum of
        # them, so the last pivot is column 9, the middle of panel 2 (8-11)
        while True:
            basis = (rng.random((m, 6)) < 0.5).astype(np.uint8)
            if TannerGraph(basis.T.copy(), device="cpu").rank == 6:
                break
        mix = (rng.random((6, n)) < 0.5).astype(np.uint8)
        mix[:, :5] = np.eye(6, 5, dtype=np.uint8)
        mix[5, :9] = 0
        mix[5, 9] = 1
        H = (basis @ mix % 2).astype(np.uint8)
    err = (rng.random((3, n)) < 0.2).astype(np.uint8)
    err[0] = 0
    err[0, 5] = 1  # a syndrome that carries row 0 (the l_table case's column 5)
    synd = (err @ H.T % 2).astype(np.uint8)
    return H, P, synd, np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("case", ["l_table", "empty_panel", "rank_mid_panel"])
def test_k5_panel_schedule_cases(case):
    """The emulated schedule's corners, each held to ``eliminate_plain``,
    JAX ``_eliminate`` and ``osd_decode_plain``: a pivot row inside an
    earlier pivot's S in the same panel (so g needs L), a panel with no
    pivot at all (no trailing pass, the look-ahead still loads the next
    panel), and rank reached in the middle of a panel (the last panel's
    pass and write-back with columns of the panel left unexamined)."""
    H, P, synd, perm1 = _schedule_case(case)
    g = TannerGraph(H, device="cpu")
    m, n, r = g.m, g.n, g.rank
    order = 4
    lam = min(order, n - r)
    pairs = build_osd_consts(g, "osd_cs", order).pairs
    h_cols = g.H_cols.numpy().view(np.uint32)
    perm = np.tile(perm1, (synd.shape[0], 1))
    perm_t, synd_t = torch.as_tensor(perm), torch.as_tensor(synd)
    plain = eliminate_plain(g, perm_t, synd_t)
    ref = j_eliminate(JTannerGraph(H), jnp.asarray(perm), jnp.asarray(synd.astype(np.int32)))
    want0, wantw = osd_decode_plain(g, perm_t, synd_t, method="osd_cs", osd_order=order,
                                    pairs=pairs)
    for b in range(synd.shape[0]):
        records = []
        M, prow = k5_eliminate(h_cols, perm[b], synd[b], r, P, records)
        last = int(np.flatnonzero(prow >= 0).max())
        if case == "l_table":
            assert records[0].L[1] & 1 and records[0].r[:2] == [0, 1]
        elif case == "empty_panel":
            assert [rec.q for rec in records[:3]] == [P, 0, records[2].q] and records[2].q > 0
        else:
            assert r == 6 < m and last == 9 and (last + 1) % P and last + 1 < n
            assert len(records) == last // P + 1  # no panel after the one rank ended in
        mine = k5_elimination_outputs(M, prow, perm[b], m, r)
        for name, got, p_out, j_out in zip(plain._fields, mine, plain, ref):
            p_np = p_out[b].numpy()
            if name == "h_work":
                p_np = p_np.view(np.uint32)
            assert np.array_equal(got, p_np), (case, name, b)
            assert np.array_equal(got, np.asarray(j_out[b]).astype(got.dtype)), (case, name, b)
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
    formula of the kernel's layout; the panel is the widest up to
    ``_MAX_PANEL`` columns (and n) that fits 232,448 bytes: at lift 400
    three panels and two records of 32 columns and the rest take 153,628
    bytes, and a 30000 x 30000 code narrows the panel to 6."""
    for m, n, lam, P in ((4800, 10000, 15, 16), (720, 1500, 15, 7), (192, 400, 0, 1)):
        Wm = -(-m // 32)
        record = (P * Wm + 1) // 2 + 13 * P + 2 * Wm + 4
        words = 3 * P * (Wm | 1) + 2 * record + 2 * Wm + 2 * 4096 + max(lam, 1) + 4
        assert osd_large_smem_bytes(m, n, lam, P) == 8 * 32 + 4 * words + 2 * (2 * 4096 + n)
    assert osd_large_smem_bytes(4800, 10000, 15, 32) == 153_628
    assert _MAX_PANEL <= 32  # a panel's pivots are the bits of a 32-bit word
    assert osd_large_panel(4800, 10000, 15) == _MAX_PANEL
    assert osd_large_panel(192, 400, 42) == _MAX_PANEL
    assert osd_large_panel(60, 12, 3) == min(12, _MAX_PANEL)  # never wider than the code
    P = osd_large_panel(30000, 30000, 15)
    assert P == 6 and osd_large_smem_bytes(30000, 30000, 15, P) <= _SMEM_LIMIT
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
