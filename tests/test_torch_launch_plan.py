"""The host side of kernels K1 (the team kernel of ``csrc/bp_flood.cu``) and
K2 (the warp kernel of ``csrc/osd_cs.cu``), on the CPU.

- the per-check degree array K1 reads instead of scanning a row;
- the column-packed H that K2 copies by ``perm`` instead of gathering bits;
- the Python mirrors of both kernels' shared memory at the flagship, and
  K1's placement boundary;
- K1's fused iteration order (the check update of t + 1 takes the syndrome
  parity of t and rebuilds v2c_t from the check's compressed message), in a
  plain numpy emulation, against the JAX ``bp_decode`` (XLA on the CPU) and
  the port's ``bp_decode_plain``.
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
    team_shape,
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
