"""bp_osd_tpu_torch's large-code path against the JAX package: lifted-product
codes, shift-routed lifted BP, the OSD of kernel K5 (plain version) and the
``proto``/``lift`` decoders, on inputs made with numpy from a seed."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_osd_tpu import BpDecoder as JBpDecoder
from bp_osd_tpu import BpOsdDecoder as JBpOsdDecoder
from bp_osd_tpu.codes.lifted_product import lifted_hgp as jlifted_hgp
from bp_osd_tpu.codes.lifted_product import protograph_to_binary as jprotograph_to_binary
from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.decoder.lifted_bp import LiftedGraph as JLiftedGraph
from bp_osd_tpu.decoder.lifted_bp import bp_decode_lifted as jbp_decode_lifted
from bp_osd_tpu.ops.pallas_osd_large import osd_cs_large_pallas

from bp_osd_tpu_torch import BpDecoder, BpOsdDecoder
from bp_osd_tpu_torch.codes import hgp, lifted_hgp, protograph_to_binary
from bp_osd_tpu_torch.decoder.bp import bp_decode
from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode_plain
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.ops.cuda_bp import _SMEM_LIMIT
from bp_osd_tpu_torch.ops.cuda_osd import k2_fits, osd_cs_warp_smem_bytes

torch.set_num_threads(1)

# the (3,4)-regular protograph of bench_large.py and the aux corpus
PROTO = [
    [(0,), (0,), (0,), (0,)],
    [(0,), (1,), (2,), (3,)],
    [(0,), (2,), (4,), (6,)],
]
MULTI = [[(0, 1), (2,), ()], [(3,), (0, 4), (1,)]]  # tests/test_lifted_bp.py:68
AUX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "aux_corpora.npz")


def _dense(M):
    return np.asarray(M.toarray() if hasattr(M, "toarray") else M, np.uint8)


def _syndromes(H, B, p, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((B, H.shape[1])) < p).astype(np.uint8) @ H.T % 2).astype(np.uint8)


def _jax_fields(jg: JLiftedGraph, proto):
    return dict(proto=proto, L=jg.L, edges=jg.edges, wr=jg.wr, chk_mask=jg.chk_mask)


@pytest.mark.parametrize("proto,lift", [(PROTO, 1), (PROTO, 8), (MULTI, 6)])
def test_lifted_hgp_equals_jax(proto, lift):
    mine, ref = lifted_hgp(proto, lift=lift), jlifted_hgp(proto, lift=lift)
    for name in ("hx", "hz"):
        assert np.array_equal(_dense(getattr(mine, name)), _dense(getattr(ref, name))), name
    assert mine.hx_proto == ref.hx_proto and mine.hz_proto == ref.hz_proto
    assert (mine.N, mine.K, mine.lift) == (ref.N, ref.K, ref.lift)
    for tr in (False, True):
        assert np.array_equal(_dense(protograph_to_binary(proto, lift, transpose=tr)),
                              _dense(jprotograph_to_binary(proto, lift, transpose=tr)))
    if lift == 1:  # a lift of 1 is the hypergraph product of the binary protograph
        seed = _dense(protograph_to_binary(proto, 1))
        plain = hgp(seed)
        assert np.array_equal(_dense(mine.hx), _dense(plain.hx))
        assert np.array_equal(_dense(mine.hz), _dense(plain.hz))


@pytest.mark.parametrize("proto,lift", [(PROTO, 8), (MULTI, 6)])
def test_lifted_graph_from_reference(proto, lift):
    jg = JLiftedGraph(proto, lift)
    g = LiftedGraph.from_reference(_jax_fields(jg, proto), device="cpu")
    assert (g.m, g.n, g.wr, g.edges) == (jg.m, jg.n, jg.wr, jg.edges)
    # every edge routes to the variable the binary lift has there
    H = _dense(protograph_to_binary(proto, lift))
    cv = g.chk_var.reshape(g.m, g.wr).numpy()
    for c in range(g.m):
        assert sorted(cv[c][g.edge_mask[c].numpy()]) == list(np.flatnonzero(H[c]))
    bad = dict(_jax_fields(jg, proto), wr=jg.wr + 1)
    with pytest.raises(ValueError, match="wr"):
        LiftedGraph.from_reference(bad, device="cpu")
    bad = dict(_jax_fields(jg, proto), edges=jg.edges[::-1])
    with pytest.raises(ValueError, match="edges"):
        LiftedGraph.from_reference(bad, device="cpu")


@pytest.mark.parametrize("bp_method,msf", [("minimum_sum", 0.625), ("minimum_sum", 0.0),
                                           ("product_sum", 1.0)])
def test_bp_decode_lifted_equals_jax(bp_method, msf):
    """JAX under ``jax.jit``, as its decoder runs it.  Min-sum is bit-equal.
    Product-sum: messages near the 1 - 1e-7 clip go through atanh, which
    turns one ulp of torch's tanh against XLA's into up to ~2% of the llr, so
    llr is held to rtol 0.02; decisions stay equal."""
    L = 8
    q = jlifted_hgp(PROTO, lift=L)
    H = _dense(q.hx)
    jg = JLiftedGraph(q.hx_proto, L)
    g = LiftedGraph.from_reference(_jax_fields(jg, q.hx_proto), device="cpu")
    synd = _syndromes(H, 12, 0.06, 5)
    llr0 = np.asarray(jllr_from_channel(np.full(H.shape[1], 0.06)))
    kw = dict(bp_method=bp_method, max_iter=25, ms_scaling_factor=msf)
    ref = jax.jit(lambda s, l: jbp_decode_lifted(jg, s, l, **kw))(synd, llr0)
    mine = bp_decode_lifted(g, synd, llr0, **kw)
    for k in ("hard", "converged", "iterations"):
        assert np.array_equal(getattr(mine, k).numpy(), np.asarray(getattr(ref, k))), k
    assert 0 < int(mine.converged.sum()) < 12
    if bp_method == "minimum_sum":
        assert np.array_equal(mine.llr.numpy(), np.asarray(ref.llr))
    else:
        np.testing.assert_allclose(mine.llr.numpy(), np.asarray(ref.llr), rtol=0.02, atol=1e-3)


@pytest.mark.parametrize("proto,lift,msf", [(PROTO, 8, 0.625), (PROTO, 8, 0.0),
                                            (MULTI, 6, 0.0)])
def test_lifted_min_sum_equals_dense_bp(proto, lift, msf):
    """Shift routing is exact and the check update is shared, so min-sum
    decisions equal the dense path's (``tests/test_lifted_bp.py`` holds the
    same in JAX); llr differs only by the order of the variable sums."""
    H = _dense(protograph_to_binary(proto, lift))
    synd = _syndromes(H, 12, 0.05, 23)
    llr0 = np.full(H.shape[1], np.log(0.95 / 0.05), np.float32)
    kw = dict(bp_method="ms", max_iter=25, ms_scaling_factor=msf)
    mine = bp_decode_lifted(LiftedGraph(proto, lift, device="cpu"), synd, llr0, **kw)
    dense = bp_decode(TannerGraph(H, device="cpu"), synd, llr0, **kw)
    for k in ("hard", "converged", "iterations"):
        assert np.array_equal(getattr(mine, k).numpy(), getattr(dense, k).numpy()), k
    np.testing.assert_allclose(mine.llr.numpy(), dense.llr.numpy(), atol=2e-4)


def _random_code(m, n, seed, wc=3):  # tests/test_osd_large.py:_random_code
    r = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        H[r.choice(m, size=wc, replace=False), j] = 1
    for i in range(m):
        if H[i].sum() == 0:
            H[i, int(r.integers(n))] = 1
    return H


@pytest.mark.parametrize("order,with_skip", [(0, False), (1, False), (6, False), (4, True)])
def test_plain_osd_equals_jax_large_kernel(order, with_skip):
    """The plain version of K5 against the JAX package's K5 in interpret mode."""
    H = _random_code(48, 120, seed=3)
    r = np.random.default_rng(11)
    B = 9
    synd = (((r.random((B, 120)) < 0.06).astype(np.uint8)) @ H.T % 2).astype(np.uint8)
    llr = r.normal(2.0, 1.0, size=(B, 120)).astype(np.float32)
    skip = np.array([1, 0, 0, 1, 0, 1, 0, 0, 1], bool) if with_skip else None
    perm = jnp.argsort(jnp.asarray(llr), axis=1, stable=True).astype(jnp.int32)
    e0, ew = osd_cs_large_pallas(JTannerGraph(H), perm, synd, osd_order=order,
                                 skip=None if skip is None else skip.astype(np.int32),
                                 interpret=True)
    g = TannerGraph(H, device="cpu")
    pairs = build_osd_consts(g, "osd_cs", order).pairs
    args = (g, torch.as_tensor(np.array(perm)), torch.as_tensor(synd))
    kw = dict(osd_order=order, pairs=pairs,
              skip=None if skip is None else torch.as_tensor(skip))
    m0, mw = osd_decode_plain(*args, method="osd_cs", **kw)
    live = np.ones(B, bool) if skip is None else ~skip
    assert np.array_equal(m0.numpy()[live], np.asarray(e0)[live])
    assert np.array_equal(mw.numpy()[live], np.asarray(ew)[live])
    assert not m0.numpy()[~live].any() and not mw.numpy()[~live].any()


def test_k2_k5_routing_by_shared_memory():
    """K2's shared memory (mirror of ``csrc/osd_cs.cu:osd_cs_warp_smem_bytes``:
    the shared H and one warp's sample) at osd_cs order 15 decides K2 or K5,
    as ``fused_osd_fits`` does on the TPU."""
    assert osd_cs_warp_smem_bytes(480, 1000, 15) == 130_184  # lift 40 fits
    assert osd_cs_warp_smem_bytes(720, 1500, 15) == 291_248  # lift 60 does not
    assert osd_cs_warp_smem_bytes(4800, 10000, 15) > 12_000_000
    assert _SMEM_LIMIT == 232_448
    flagship = TannerGraph(_dense(hgp(_dense(protograph_to_binary(PROTO, 1))).hx), device="cpu")
    assert k2_fits(flagship, 42)
    lift60 = TannerGraph(_dense(lifted_hgp(PROTO, lift=60).hx), device="cpu")
    assert not k2_fits(lift60, 15) and not k2_fits(lift60, 0)
    assert not k2_fits(SimpleNamespace(m=4800, n=10000, rank=4790), 15)


def _lifted_kw(**extra):
    return dict(error_rate=0.05, max_iter=20, bp_method="ms", ms_scaling_factor=0.625,
                **extra)


@pytest.mark.parametrize("osd_method,order", [("osd_cs", 6), ("osd0", 0)])
def test_lifted_decoder_class_equals_jax(osd_method, order):
    L = 8
    q = lifted_hgp(PROTO, lift=L)
    H = _dense(q.hx)
    synd = _syndromes(H, 24, 0.05, 41)
    kw = _lifted_kw(osd_method=osd_method, osd_order=order)
    mine = BpOsdDecoder(H, proto=q.hx_proto, lift=L, **kw)
    ref = JBpOsdDecoder(H, proto=q.hx_proto, lift=L, **kw)
    mine.decode_batch(synd)
    ref.decode_batch(synd)
    assert 0 < int((~mine.converge_batch).sum()) < 24
    for attr in ("osdw_decoding_batch", "osd0_decoding_batch", "bp_decoding_batch",
                 "converge_batch", "iter_batch", "log_prob_ratios_batch"):
        assert np.array_equal(getattr(mine, attr), np.asarray(getattr(ref, attr))), attr
    assert not (mine.osdw_decoding_batch @ H.T % 2 != synd).any()
    bp_mine = BpDecoder(H, proto=q.hx_proto, lift=L, **_lifted_kw())
    bp_ref = JBpDecoder(H, proto=q.hx_proto, lift=L, **_lifted_kw())
    assert np.array_equal(bp_mine.decode_batch(synd), bp_ref.decode_batch(synd))
    assert np.array_equal(bp_mine.log_prob_ratios_batch, np.asarray(bp_ref.log_prob_ratios_batch))


def test_lifted_decoder_received_vector_and_device_outputs():
    L = 8
    q = lifted_hgp(PROTO, lift=L)
    H = _dense(q.hx)
    rng = np.random.default_rng(9)
    received = (rng.random((10, H.shape[1])) < 0.3).astype(np.uint8)
    kw = _lifted_kw(osd_method="osd_cs", osd_order=4, proto=q.hx_proto, lift=L)
    rv = BpOsdDecoder(H, input_vector_type="received_vector", **kw)
    sy = BpOsdDecoder(H, **kw)
    rv.decode_batch(received)
    out = sy.decode_batch(torch.as_tensor(received @ H.T % 2), outputs="device")
    assert torch.is_tensor(out) and torch.is_tensor(sy.converge_batch)
    assert np.array_equal(rv.osdw_decoding_batch, out.numpy() ^ received)
    assert np.array_equal(rv.bp_decoding_batch, sy.bp_decoding_batch.numpy() ^ received)
    assert not (rv.osdw_decoding_batch @ H.T % 2).any()


@pytest.mark.parametrize("case", ["no_lift", "layered", "shape"])
def test_lifted_decoder_value_errors(case):
    q = lifted_hgp(PROTO, lift=4)
    H = _dense(q.hx)
    kw = dict(error_rate=0.05, proto=q.hx_proto, lift=4)
    if case == "no_lift":
        kw["lift"] = None
    elif case == "layered":
        kw["schedule"] = "layered"
    else:
        kw["lift"] = 5
    for cls in (BpDecoder, BpOsdDecoder):
        with pytest.raises(ValueError):
            cls(H, **kw)


def test_lifted_streamed_aux_corpus_reproduced():
    """``tests/data/aux_corpora.npz`` ``lifted_streamed`` (lift 60, B = 12,
    made by the JAX lifted BP and its K5 kernel), bit for bit."""
    data = np.load(AUX)
    B, m, n = (int(x) for x in data["lifted_streamed_shape"])
    synd = np.unpackbits(data["lifted_streamed_synd"], axis=1)[:, :m]
    q = lifted_hgp(PROTO, lift=60)
    dec = BpOsdDecoder(q.hx, error_rate=0.05, max_iter=12, bp_method="minimum_sum",
                       ms_scaling_factor=0.625, osd_method="osd_cs", osd_order=15,
                       proto=q.hx_proto, lift=60)
    osdw = dec.decode_batch(synd)
    assert np.array_equal(np.packbits(osdw, axis=1), data["lifted_streamed_osdw"])
    assert np.array_equal(dec.converge_batch, data["lifted_streamed_conv"])
    assert np.array_equal(dec.iter_batch, data["lifted_streamed_iters"])
    assert int((~dec.converge_batch).sum()) > B // 2  # the OSD tail carries the pin
