"""The host side of kernels K1 (the team kernel of ``csrc/bp_flood.cu``) and
K2 (the warp kernel of ``csrc/osd_cs.cu``), on the CPU.

- the per-check degree array K1 reads instead of scanning a row;
- the column-packed H that K2 copies by ``perm`` instead of gathering bits;
- the Python mirrors of both kernels' shared memory at the flagship, and
  K1's placement boundary;
- K1's fused iteration order (the check update of t + 1 takes the syndrome
  parity of t and rebuilds v2c_t from the check's compressed message), in a
  plain numpy emulation, against the JAX ``bp_decode`` (XLA on the CPU) and
  the port's ``bp_decode_plain``;
- the latency plan's team rule and its kernel's register tables (16-bit
  byte offsets into the totals and into a slot-major c2v), emulated in
  numpy against the team kernel's gathers;
- the wide plan's rule and its kernel's shared tables (16-bit total
  indices a check slot, 16-bit check-and-slot entries a variable edge, a
  compressed message a check), emulated in numpy the same way.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder import bp_decode as jbp_decode
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel

from bp_osd_tpu_torch.codes import hgp, mkmn_16_4_6, mkmn_20_5_8, rep_code
from bp_osd_tpu_torch.decoder.bp import bp_decode_plain
from bp_osd_tpu_torch.decoder.osd import _pack_rows_bits, _unpack_bits
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.ops.cuda_bp import (
    _SMEM_LIMIT,
    bp_flood_smem_bytes,
    bp_flood_table_bytes,
    bp_flood_team_bytes,
    k1_fits,
    latency_smem_bytes,
    latency_team,
    team_shape,
    wide_grid,
    wide_plan,
    wide_smem_bytes,
)
from bp_osd_tpu_torch.ops.cuda_osd import k2_fits, osd_cs_warp_smem_bytes

torch.set_num_threads(1)

CODES = {
    "surface": lambda: hgp(rep_code(3), rep_code(3)).hx.toarray(),
    "flagship": lambda: hgp(mkmn_16_4_6()).hx.toarray(),
    "625": lambda: hgp(mkmn_20_5_8()).hx.toarray(),
    "weight1": lambda: np.eye(6, dtype=np.uint8),
}


def _graph(code):
    return TannerGraph(np.asarray(CODES[code](), np.uint8), device="cpu")


@pytest.mark.parametrize("code", sorted(CODES))
def test_check_degrees(code):
    """``chk_deg`` is each check's count of ``chk_var < n``, int32, and
    follows the graph to another device unchanged."""
    g = _graph(code)
    want = (g.chk_var < g.n).sum(1).to(torch.int32)
    assert g.chk_deg.dtype == torch.int32 and torch.equal(g.chk_deg, want)
    assert torch.equal(g.chk_deg, torch.as_tensor(g.H.sum(1), dtype=torch.int32))
    assert g.to("cpu").chk_deg is g.chk_deg


@pytest.mark.parametrize("code", ["surface", "flagship", "625"])
def test_column_packed_h_and_its_gather(code):
    """``H_cols`` unpacks to H, and its rows gathered by ``perm`` are the
    column-permuted matrix of the plain OSD (bit-packed ``H[:, perm]``)."""
    g = _graph(code)
    H = torch.as_tensor(g.H, dtype=torch.uint8)
    assert torch.equal(_unpack_bits(g.H_cols, g.m), H.T)
    rng = np.random.default_rng(3)
    perm = torch.as_tensor(np.argsort(rng.normal(size=(5, g.n)), axis=1), dtype=torch.int64)
    for b in range(5):
        want = _pack_rows_bits(H[:, perm[b]].T)
        assert torch.equal(g.H_cols[perm[b]], want)


def test_shared_memory_mirrors_at_the_flagship():
    """K1's tables plus its teams, and K2's shared H plus its warps, fit a
    block at the flagship; K1's smallest team takes the fewest warps that
    keep a thread at <= 8 checks (one warp, six checks a thread)."""
    m, n, wr, wc = 192, 400, 7, 4
    assert bp_flood_table_bytes(m, n, wr, wc) == 4 * (192 * 8 + 400 * 4 + 192)
    for product_sum, words in ((False, 192 * 8 + 404), (True, 2 * 192 * 8 + 404)):
        assert bp_flood_team_bytes(m, n, wr, product_sum) == 4 * words
    teams = (_SMEM_LIMIT - bp_flood_table_bytes(m, n, wr, wc)) // bp_flood_team_bytes(m, n, wr,
                                                                                      False)
    assert teams == 28  # the first design held 8 samples an SM, 26.5 KB each
    assert bp_flood_table_bytes(m, n, wr, wc) + 15 * bp_flood_team_bytes(m, n, wr, True) \
        <= _SMEM_LIMIT
    assert team_shape(m) == (32, 6) and team_shape(1680) == (224, 8)  # flagship, lift 140
    assert bp_flood_smem_bytes(m, n, wr, wc) == 26_496  # the first design's block
    per_warp = osd_cs_warp_smem_bytes(m, n, 42, 2) - osd_cs_warp_smem_bytes(m, n, 42, 1)
    assert per_warp == 4 * (401 * 6 + 200 + 42 + 6)
    assert osd_cs_warp_smem_bytes(m, n, 42, 0) == 4 * 400 * 6
    assert osd_cs_warp_smem_bytes(m, n, 42, 20) <= _SMEM_LIMIT
    assert osd_cs_warp_smem_bytes(m, n, 42, 21) > _SMEM_LIMIT
    # an odd word count is padded to an even one (64-bit XORs)
    assert osd_cs_warp_smem_bytes(32, 60, 3, 0) == 4 * 60 * 2


def _lifted_shape(L):
    return SimpleNamespace(m=12 * L, n=25 * L, wr=7, wc=4, rank=12 * L - 2)


def test_placement_boundaries():
    """K1 keeps the first design's boundary for min-sum (lift 140 in shared
    memory, lift 141 in device memory); product-sum, whose c2v is
    double-buffered, leaves shared memory earlier; a row weight above 27
    goes to device memory too; K2 holds the flagship and not lift 60."""
    assert [k1_fits(_lifted_shape(L)) for L in (60, 140, 141, 400)] == [True, True, False, False]
    assert k1_fits(_lifted_shape(100), True) and not k1_fits(_lifted_shape(140), True)
    assert k1_fits(SimpleNamespace(m=10, n=400, wr=27, wc=1))
    assert not k1_fits(SimpleNamespace(m=10, n=400, wr=28, wc=1))
    assert k2_fits(_graph("flagship"), 42) and not k2_fits(_lifted_shape(60), 15)


# ---- K1's fused iteration order, emulated in numpy ----

_BIG = np.float32(1e30)


def _alpha(scale, it):
    return np.float32(1.0 - 2.0 ** -it) if scale == 0.0 else np.float32(scale)


def _message(v2c, mask, syn, alpha):
    """The compressed min-sum message of every check from ``v2c [B, m, wr]``
    (slots in ascending order): scaled minima, first-minimum slot and the
    output signs, as ``MinSumAcc`` builds it; returns its c2v ``[B, m, wr]``
    (0 on pads)."""
    B, m, wr = v2c.shape
    big = _BIG.view(np.uint32)
    m1 = np.full((B, m), big, np.uint32)
    m2 = np.full((B, m), big, np.uint32)
    i1 = np.full((B, m), 31, np.int64)
    neg = np.zeros((B, m, wr), bool)
    for s in range(wr):
        x = v2c[:, :, s]
        live = mask[None, :, s]
        neg[:, :, s] = (x < 0) & live
        mag = np.where(live, x.view(np.uint32) & np.uint32(0x7FFFFFFF), big)
        lt1 = mag < m1
        i1 = np.where(lt1, s, i1)
        m2 = np.minimum(m2, np.maximum(m1, mag))
        m1 = np.minimum(m1, mag)
    parity = (syn + neg.sum(-1)) & 1
    m1a = (m1.view(np.float32) * alpha).astype(np.float32)
    m2a = (m2.view(np.float32) * alpha).astype(np.float32)
    slot = np.arange(wr)
    mag = np.where(slot[None, None, :] == i1[..., None], m2a[..., None], m1a[..., None])
    out_neg = neg ^ (parity[..., None] == 1)
    return np.where(mask[None], np.where(out_neg, -mag, mag), np.float32(0))


def _totals(c2v, l0, graph):
    """tot = l0 + four-lane sum: lane e % 4, ascending e, (p0 + p1) + (p2 + p3)."""
    B = c2v.shape[0]
    flat = c2v.reshape(B, -1)
    ve = graph.var_edge.numpy()
    E = graph.m * graph.wr
    p = np.zeros((4, B, graph.n), np.float32)
    for j in range(graph.wc):
        e = ve[:, j]
        ok = e < E
        for k in range(4):
            sel = ok & (e % 4 == k)
            p[k][:, sel] = p[k][:, sel] + flat[:, e[sel]]
    return (l0 + ((p[0] + p[1]) + (p[2] + p[3]))).astype(np.float32)


def fused_min_sum(graph, synd, l0, *, max_iter, scale, v2c_init=None, it0=0):
    """K1's team-kernel order in numpy float32: the check update of t + 1
    reads tot_t, checks the syndrome parity of t on the way and rebuilds
    v2c_t = tot_t - c2v_t; a row stops at its first satisfied t (or at
    max_iter) and emits tot_t and v2c_t.  Returns (hard, llr, converged,
    iterations, v2c)."""
    cv = graph.chk_var.numpy()
    mask = cv < graph.n
    B, m, wr, n = synd.shape[0], graph.m, graph.wr, graph.n
    syn = synd.astype(np.int64)
    l0 = np.broadcast_to(l0, (B, n)).astype(np.float32)
    gather = np.concatenate([l0, np.zeros((B, 1), np.float32)], 1)[:, np.minimum(cv, n)]
    v2c = gather if v2c_init is None else v2c_init.reshape(B, m, wr).astype(np.float32)
    v2c = np.where(mask[None], v2c, np.float32(0))
    c2v = _message(v2c, mask, syn, _alpha(scale, it0 + 1))
    tot = _totals(c2v, l0, graph)
    out = [np.zeros((B, n), np.uint8), np.zeros((B, n), np.float32), np.zeros(B, bool),
           np.zeros(B, np.int32), np.zeros((B, m * wr), np.float32)]
    live = np.ones(B, bool)
    for it in range(it0 + 1, max_iter + 1):
        t_e = np.concatenate([tot, np.ones((B, 1), np.float32)], 1)[:, np.minimum(cv, n)]
        hp = (syn + ((t_e <= 0) & mask[None]).sum(-1)) & 1
        ok = ~hp.any(1)
        v2c = np.where(mask[None], (t_e - c2v).astype(np.float32), np.float32(0))
        stop = live & (ok | (it == max_iter))
        out[0][stop] = tot[stop] <= 0
        out[1][stop] = tot[stop]
        out[2][stop] = ok[stop]
        out[3][stop] = it
        out[4][stop] = v2c[stop].reshape(-1, m * wr)
        live &= ~stop
        if not live.any():
            break
        c2v = _message(v2c, mask, syn, _alpha(scale, it + 1))
        tot = _totals(c2v, l0, graph)
    return out


def _inputs(H, B, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    return (err @ H.T % 2).astype(np.uint8), np.array(jllr_from_channel(np.full(H.shape[1], p)))


@pytest.mark.parametrize("code,p,max_iter", [("flagship", 0.06, 80), ("weight1", 0.2, 6),
                                             ("weight1_mixed", 0.2, 10)])
@pytest.mark.parametrize("scale", [0.0, 0.625])
def test_fused_order_equals_jax_bp_decode(code, p, max_iter, scale):
    """The fused order gives the JAX XLA path's hard, llr, converged and
    iterations bit for bit at the flagship and on weight-1 codes (a weight-1
    check takes the 1e30 cap).  B = 64: the batch at which XLA:CPU sums in
    the four-lane order (``tests/test_torch_bp.py``)."""
    if code == "weight1_mixed":
        H = np.zeros((4, 5), np.uint8)
        H[0, 0] = H[2, 3] = 1
        H[1, [1, 2]] = 1
        H[3, [2, 3, 4]] = 1
    elif code == "flagship":
        H = np.asarray(jhgp(jmkmn_16_4_6()).hx.toarray(), np.uint8)
    else:
        H = np.eye(6, dtype=np.uint8)
    synd, l0 = _inputs(H, 64, p, 11)
    ref = jbp_decode(JTannerGraph(H), synd, np.broadcast_to(l0, (64, H.shape[1])),
                     bp_method="ms", max_iter=max_iter, ms_scaling_factor=scale)
    got = fused_min_sum(TannerGraph(H, device="cpu"), synd, l0, max_iter=max_iter, scale=scale)
    for name, a, b in zip(("hard", "llr", "converged", "iterations"), got, ref):
        assert np.array_equal(a, np.asarray(b).astype(a.dtype)), name


def test_fused_order_equals_the_plain_version_with_state():
    """With a resumed state and the emitted one: the fused order equals
    ``bp_decode_plain`` in all five outputs, the chain 24 -> 96 included."""
    g = _graph("flagship")
    synd, l0 = _inputs(g.H, 64, 0.05, 23)
    kw = dict(method="minimum_sum", ms_scaling_factor=0.0, emit_state=True)
    s_t, l0_t = torch.as_tensor(synd), torch.as_tensor(l0)[None].expand(64, g.n)
    first = bp_decode_plain(g, s_t, l0_t, max_iter=24, **kw)
    mine = fused_min_sum(g, synd, l0, max_iter=24, scale=0.0)
    for a, b in zip(mine, first):
        assert np.array_equal(a, b.numpy().astype(a.dtype))
    second = bp_decode_plain(g, s_t, l0_t, max_iter=96, v2c_init=first[4], it0=24, **kw)
    mine = fused_min_sum(g, synd, l0, max_iter=96, scale=0.0, v2c_init=first[4].numpy(), it0=24)
    for a, b in zip(mine, second):
        assert np.array_equal(a, b.numpy().astype(a.dtype))


# ---- the latency plan: its team rule and its kernel's register tables ----


def _spacetime():
    from bp_osd_tpu_torch.codes import gross_code, phenomenological

    return phenomenological(gross_code().hx, 12).H.toarray()


CODES["spacetime"] = _spacetime


@pytest.mark.parametrize("shape,k,want", [
    ((936, 2736, 8, 3), 1, 960),  # the gross code's space-time matrix: a check a thread
    ((936, 2736, 8, 3), 2, 960),  # two rows a block, the same threads
    ((936, 2736, 8, 3), 3, None),  # three rows a block
    ((192, 400, 7, 4), 1, 192),  # the flagship
    ((6, 13, 4, 2), 2, 32),  # never below a warp
    ((1100, 2000, 4, 4), 1, None),  # more than 1024 checks
    ((192, 700, 7, 4), 1, None),  # more than three variables a thread
    ((40, 120, 13, 4), 1, None),  # rows of more than 8 slots
    ((192, 400, 7, 5), 1, None),  # columns of more than 4
])
def test_latency_team_rule(shape, k, want):
    """The whole-row team, a check and three variables a thread, within the
    latency kernel's bounds (``csrc/bp_flood.cu:latency_shape``)."""
    assert latency_team(*shape, k) == want


def _latency_tables(graph, threads):
    """The latency kernel's tables for a block of ``threads``, for all
    checks and variables at once, as byte offsets in a row's region, where
    the totals ``[threads * 3 + 2]`` lie first (the last two the check
    pads' +inf and the variable pads' +0.0) and c2v warp-tiled ``[threads /
    32][kS][32]`` after them: a check's ``kS`` slots name their totals
    (kept in registers), a variable's edges their c2v words with the lane
    e % 4 in the low two bits (pad: the +0.0 in lane 3; an int4 a variable
    in shared memory, before the regions)."""
    m, n, wr = graph.m, graph.n, graph.wr
    kS = 8 if wr > 4 else 4
    E = m * wr
    pad = threads * 3
    c2v0 = 4 * (-(-(pad + 2) // 4) * 4)
    cv = np.full((m, kS), 4 * pad, np.int64)
    chk = graph.chk_var.numpy().astype(np.int64)
    cv[:, :wr] = 4 * np.where(chk < n, chk, pad)
    e = graph.var_edge.numpy().astype(np.int64)
    c, s = e // wr, e % wr
    word = ((c >> 5) * kS + s) * 32 + (c & 31)
    ve = np.where(e < E, (c2v0 + 4 * word) | (e & 3), (4 * (pad + 1)) | 3)
    return cv, ve, c2v0, kS, pad


@pytest.mark.parametrize("code", ["surface", "flagship", "625", "weight1", "spacetime"])
@pytest.mark.parametrize("rows", [1, 2])
def test_latency_tables_gather_like_the_team_kernel(code, rows):
    """Through the latency kernel's tables, in each row's region of a block
    of one row and of two, a check gathers the totals the team kernel's
    ``chk_var`` row names (+inf on pads), and a variable sums the
    warp-tiled c2v in the four lanes of its flat edges, equal to
    ``_totals`` bit for bit; the block's shared memory holds the variable
    rows and the regions, pads included."""
    g = _graph(code) if code != "spacetime" else TannerGraph(
        np.asarray(_spacetime(), np.uint8), device="cpu")
    threads = latency_team(g.m, g.n, g.wr, g.wc, rows)
    cv, ve, c2v0, kS, pad = _latency_tables(g, threads)
    rng = np.random.default_rng(3)
    smem = np.zeros(latency_smem_bytes(threads, rows, g.wr) // 4, np.float32)
    region = (smem.size - 4 * pad) // rows
    priors = 3 * threads if rows > 1 else 0  # a row's priors, with two rows
    assert region == c2v0 // 4 + kS * threads + priors and threads >= g.m and 3 * threads >= g.n
    mask = g.chk_var.numpy() < g.n
    for r in range(rows):
        reg = smem[4 * pad + r * region : 4 * pad + (r + 1) * region]
        c2v = np.where(mask, rng.normal(0, 2, (g.m, g.wr)), 0).astype(np.float32)[None]
        reg[: g.n] = rng.normal(0, 3, g.n)
        reg[pad] = np.inf  # reg[pad + 1] stays +0.0
        tiled = np.zeros((threads, kS), np.float32)
        tiled[: g.m, : g.wr] = c2v[0]
        reg[c2v0 // 4 : c2v0 // 4 + kS * threads] = (
            tiled.reshape(threads // 32, 32, kS).transpose(0, 2, 1).reshape(-1))

        def at(off):  # the float at byte offset off of the region
            return reg[off // 4]

        tot_n = np.concatenate([reg[: g.n], [np.float32(np.inf)]])
        assert np.array_equal(at(cv[:, : g.wr]), tot_n[np.minimum(g.chk_var.numpy(), g.n)])
        assert np.all(at(cv[:, g.wr :]) == np.inf)
        p = np.zeros((4, g.n), np.float32)
        for j in range(4 if g.wc > 2 else g.wc):  # a pad adds +0.0 to lane 3
            ent = ve[:, j] if j < g.wc else np.full(g.n, (4 * (pad + 1)) | 3)
            x = at(ent & ~3)
            for lane in range(4):
                sel = (ent & 3) == lane
                p[lane][sel] = p[lane][sel] + x[sel]
        l0 = rng.normal(2, 1, g.n).astype(np.float32)
        assert np.array_equal((l0 + ((p[0] + p[1]) + (p[2] + p[3]))).astype(np.float32),
                              _totals(c2v, l0, g)[0])


def test_an_infinite_pad_leaves_the_check_message_alone():
    """The latency kernel's pad slots read a total of +inf, so their v2c is
    +inf - c2v = +inf: it enters the two-minimum update above the 1e30 cap
    and never flips a sign or the hard-decision parity, so every check's
    message equals the one with pads entered as the cap (``_message``)."""
    rng = np.random.default_rng(4)
    B, m, wr = 16, 40, 8
    mask = np.arange(wr)[None, :] < rng.integers(1, wr + 1, m)[:, None]
    v2c = rng.normal(0, 3, (B, m, wr)).astype(np.float32)
    v2c[:, :, 0] = np.where(rng.random((B, m)) < 0.2, np.float32(0.0), v2c[:, :, 0])
    syn = rng.integers(0, 2, (B, m))
    want = _message(v2c, mask, syn, np.float32(0.625))
    big = _BIG.view(np.uint32)
    inf = np.where(mask[None], v2c, np.float32(np.inf) - np.float32(rng.normal(0, 3)))
    m1 = np.full((B, m), big, np.uint32)
    m2 = np.full((B, m), big, np.uint32)
    i1 = np.full((B, m), 31, np.int64)
    neg = np.zeros((B, m, wr), bool)
    for s in range(wr):  # every slot, pads included, as the latency kernel adds them
        x = inf[:, :, s]
        neg[:, :, s] = x < 0
        mag = x.view(np.uint32) & np.uint32(0x7FFFFFFF)
        i1 = np.where(mag < m1, s, i1)
        m2 = np.minimum(m2, np.maximum(m1, mag))
        m1 = np.minimum(m1, mag)
    assert not (neg & ~mask[None]).any()
    parity = (syn + neg.sum(-1)) & 1
    alpha = np.float32(0.625)
    m1a, m2a = (m1.view(np.float32) * alpha), (m2.view(np.float32) * alpha)
    mag = np.where(np.arange(wr)[None, None, :] == i1[..., None], m2a[..., None], m1a[..., None])
    got = np.where(mask[None], np.where(neg ^ (parity[..., None] == 1), -mag, mag), 0)
    assert np.array_equal(got.astype(np.float32), want)


def test_the_latency_kernels_running_scale_is_alpha_at():
    """The latency kernel's adaptive scale, 1 - 2^-t with 2^-t halved in
    float32 from one iteration to the next, equals ``alpha_at``'s 1 -
    ldexpf(1, -t) at every t, through the subnormals and past 2^-150."""
    two_t = np.float32(np.ldexp(np.float32(1.0), -2))
    for t in range(2, 400):
        want = np.float32(1.0) - np.float32(np.ldexp(np.float64(1.0), -t))
        assert np.float32(np.float32(1.0) - two_t) == want and two_t == np.ldexp(1.0, -t) or (
            t > 149 and two_t == 0.0 and want == np.float32(1.0))
        two_t = np.float32(two_t * np.float32(0.5))


# ---- the wide plan: its rule and its kernel's shared tables ----

TWO_GROSS = (2736, 8064, 8, 3)  # the two-gross code's space-time matrix over 18 rounds


def _two_gross(rounds):
    from bp_osd_tpu_torch.codes import phenomenological, two_gross_code

    return TannerGraph(np.asarray(phenomenological(two_gross_code().hx, rounds).H.toarray(),
                                  np.uint8), device="cpu")


@pytest.mark.parametrize("shape,B,sms,ps,want", [
    (TWO_GROSS, 1, 132, False, True),  # a lone row
    (TWO_GROSS, 132, 132, False, True),  # a row an SM
    (TWO_GROSS, 180, 132, False, True),  # a stage-2-sized launch
    (TWO_GROSS, 264, 132, False, True),
    (TWO_GROSS, 265, 132, False, True),  # more than two rows an SM: persistent blocks
    (TWO_GROSS, 4096, 132, False, True),  # stage 1 fills the card
    (TWO_GROSS, 100_000, 132, False, True),
    (TWO_GROSS, 228, 114, False, True),  # a card of 114 SMs
    (TWO_GROSS, 229, 114, False, True),
    (TWO_GROSS, 4096, 114, False, True),
    (TWO_GROSS, 1, 132, True, False),  # product-sum
    (TWO_GROSS, 4096, 132, True, False),
    ((936, 2736, 8, 3), 1, 132, False, False),  # the gross space-time matrix: the latency plan
    ((936, 2736, 8, 3), 4096, 132, False, False),  # ... and the throughput plan
    ((192, 400, 7, 4), 1, 132, False, False),  # the flagship
    ((4800, 10000, 7, 4), 1, 132, False, False),  # lift 400: 4800 checks, 10000 variables
    ((2736, 8064, 9, 3), 1, 132, False, False),  # rows of more than 8 slots
    ((2736, 8064, 9, 3), 4096, 132, False, False),
    ((2736, 8064, 8, 5), 1, 132, False, False),  # columns of more than 4
    ((4097, 8000, 4, 2), 1, 132, False, False),  # more than four checks a thread
    ((4096, 8192, 4, 2), 1, 132, False, True),  # four checks and eight variables a thread
])
def test_wide_plan_rule(shape, B, sms, ps, want):
    """K1's wide plan takes min-sum launches of any size on graphs the team
    kernel does not take, within its kernel's bounds
    (``csrc/bp_flood.cu:wide_shape``), and no graph the throughput or
    latency plans take; its grid is a block an SM, or a block a row below
    that."""
    g = SimpleNamespace(m=shape[0], n=shape[1], wr=shape[2], wc=shape[3])
    assert wide_plan(g, B, ps) == want
    if want:
        assert not k1_fits(g) and latency_team(*shape, 1) is None
        assert wide_grid(B, sms) == min(B, sms)


@pytest.mark.parametrize("B,sms,grid", [
    (1, 132, 1),  # a lone row: one block
    (132, 132, 132),  # a row an SM
    (133, 132, 132),  # one row past: a block takes two, from the counter
    (4096, 132, 132),  # stage 1: persistent blocks, one an SM
    (4096, 114, 114),
])
def test_wide_grid(B, sms, grid):
    """The wide plan's grid, as ``csrc/bp_flood.cu:bp_flood_plan`` sizes
    it (``bp_flood_plan(...)["grid"]`` on the card): min(B, SMs)."""
    assert wide_grid(B, sms) == grid


def test_wide_plan_takes_no_team_graph():
    """Every graph of the team kernel, the flagship and the gross code's
    space-time matrix among them, stays off the wide plan at any batch."""
    for code in ("surface", "flagship", "625", "weight1", "spacetime"):
        g = _graph(code) if code != "spacetime" else TannerGraph(
            np.asarray(_spacetime(), np.uint8), device="cpu")
        assert k1_fits(g) and not any(wide_plan(g, B) for B in (1, 132, 264, 4096))
    g = _two_gross(18)
    assert (g.m, g.n, g.wr, g.wc) == TWO_GROSS and not k1_fits(g)
    assert bp_flood_smem_bytes(*TWO_GROSS) == 434_880 > _SMEM_LIMIT
    assert wide_smem_bytes(2736, 8064, 3) == 200_480 <= _SMEM_LIMIT


def _wide_tables(graph):
    """The wide kernel's shared tables: a check's 8 slots as the indices of
    their totals (pad n, whose total is +inf), and a variable's edges, in
    column-major ``[wc][n]``, as ``check * 8 + slot`` (pad ``m * 8``: the
    pad check m, whose message is +0.0); all within 16 bits."""
    m, n, wr = graph.m, graph.n, graph.wr
    chk = graph.chk_var.numpy().astype(np.int64)
    cv = np.full((m, 8), n, np.int64)
    cv[:, :wr] = np.where(chk < n, chk, n)
    e = graph.var_edge.numpy().astype(np.int64)
    c, sl = e // wr, e % wr
    ve = np.where(e < m * wr, c * 8 + sl, m * 8).T
    assert cv.max() < 1 << 16 and ve.max() < 1 << 16
    return cv, ve


@pytest.mark.parametrize("code", ["surface", "flagship", "weight1", "two_gross"])
def test_wide_tables_gather_like_the_team_kernel(code):
    """Through the wide kernel's tables, a check gathers the totals its
    ``chk_var`` row names (+inf on pads), and a variable rebuilds each c2v
    it sums from its check's compressed message (``ms_value``: the scaled
    minima, the first-minimum slot in bits 27..31, the sign bits) and adds
    it in lane ``(c * wr + s) % 4``, equal to ``_totals`` of the messages'
    c2v bit for bit."""
    g = _two_gross(18) if code == "two_gross" else _graph(code)
    m, n, wr = g.m, g.n, g.wr
    cv, ve = _wide_tables(g)
    rng = np.random.default_rng(5)
    tot = rng.normal(0, 3, n).astype(np.float32)
    tot_n = np.concatenate([tot, [np.float32(np.inf)]])
    assert np.array_equal(tot_n[cv[:, :wr]], tot_n[np.minimum(g.chk_var.numpy(), n)])
    assert np.all(tot_n[cv[:, wr:]] == np.inf)
    # a message a check, and the pad check's zeros
    deg = g.chk_deg.numpy()
    m1a = np.abs(rng.normal(0, 2, m + 1)).astype(np.float32)
    m2a = (m1a + np.abs(rng.normal(0, 2, m + 1))).astype(np.float32)
    i1 = (rng.random(m + 1) * np.maximum(deg.tolist() + [1], 1)).astype(np.int64)
    sg = (rng.integers(0, 1 << 8, m + 1) | (i1 << 27)).astype(np.uint32)
    m1a[m] = m2a[m] = 0.0
    sg[m] = 0

    def ms_value(c, s):
        mag = np.where((sg[c] >> 27).astype(np.int64) == s, m2a[c], m1a[c])
        return np.where((sg[c] >> s.astype(np.uint32)) & 1, -mag, mag).astype(np.float32)

    slots = np.arange(wr)[None, :]
    checks = np.arange(m)[:, None]
    c2v = np.where(slots < deg[:, None], ms_value(checks, slots + 0 * checks), 0)
    c2v = c2v.astype(np.float32)[None]
    p = np.zeros((4, n), np.float32)
    for q in range(g.wc):
        c, s = ve[q] >> 3, ve[q] & 7
        x = ms_value(c, s)
        lane = (c * wr + s) & 3
        for k in range(4):
            sel = lane == k
            p[k][sel] = p[k][sel] + x[sel]
    l0 = rng.normal(2, 1, n).astype(np.float32)
    assert np.array_equal((l0 + ((p[0] + p[1]) + (p[2] + p[3]))).astype(np.float32),
                          _totals(c2v, l0, g)[0])
