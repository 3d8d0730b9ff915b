"""bp_osd_tpu_torch.parallel.lifted_shard on CPU meshes: the four cases of
``tests/test_lifted_shard.py``.

Each case is bit-equal to the port's unsharded ``bp_decode_lifted`` (and,
end to end, to the port's unsharded BP + OSD), and held to the JAX tests' own
standard against the JAX package's sharded functions on the same numpy-made
inputs, on JAX's 8 virtual CPU devices (``tests/conftest.py``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from bp_osd_tpu.codes import lifted_hgp as jlifted_hgp
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.decoder.lifted_bp import LiftedGraph as JLiftedGraph
from bp_osd_tpu.parallel.large_code import lifted_sharded_bposd_fn as jlifted_sharded_bposd_fn
from bp_osd_tpu.parallel.lifted_shard import ShardedLiftedGraph as JShardedLiftedGraph
from bp_osd_tpu.parallel.lifted_shard import lifted_sharded_bp_fn as jlifted_sharded_bp_fn

from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.parallel import cpu_mesh_2d
from bp_osd_tpu_torch.parallel.large_code import lifted_sharded_bposd_fn
from bp_osd_tpu_torch.parallel.lifted_shard import ShardedLiftedGraph, lifted_sharded_bp_fn

torch.set_num_threads(1)

PROTO = [[(0,), (0,), (0,)], [(0,), (1,), (2,)]]  # tests/test_lifted_shard.py
LIFT = 16
UNEVEN = [[(0,), (1,)], [(2,), (0,)], [(0,), (3,)]]  # mp = 6 over 4 shards


def _jmesh(data, model):
    devs = np.asarray(jax.devices()[: data * model]).reshape(data, model)
    return JMesh(devs, ("data", "model"))


def _jfields(jg: JLiftedGraph, proto):
    return dict(proto=proto, L=jg.L, edges=jg.edges, wr=jg.wr, chk_mask=jg.chk_mask)


def _case(proto, lift, n_shards, B, p, seed):
    q = jlifted_hgp(proto, lift=lift)
    H = np.asarray(q.hx.toarray(), np.uint8)
    m, n = H.shape
    jg = JLiftedGraph(q.hx_proto, lift)
    lg = LiftedGraph.from_reference(_jfields(jg, q.hx_proto), device="cpu")
    rng = np.random.default_rng(seed)
    synd = ((rng.random((B, n)) < p).astype(np.uint8) @ H.T % 2).astype(np.uint8)
    mpc = -(-lg.mp // n_shards)
    synd_pad = np.pad(synd, ((0, 0), (0, n_shards * mpc * lift - m)))
    llr0 = np.broadcast_to(np.asarray(jllr_from_channel(np.full(n, p))), (B, n)).copy()
    return H, q, jg, lg, synd, synd_pad, llr0


def _bit_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))  # -0.0 too


@pytest.mark.parametrize("bp_method", ["minimum_sum", "product_sum"])
def test_lifted_sharded_matches_unsharded(bp_method):
    H, q, jg, lg, synd, synd_pad, llr0 = _case(PROTO, LIFT, 2, 16, 0.04, 23)
    kw = dict(bp_method=bp_method, max_iter=12, ms_scaling_factor=0.0)
    mine = lifted_sharded_bp_fn(ShardedLiftedGraph(lg, 2), cpu_mesh_2d(4, 2), **kw)(
        synd_pad, llr0)
    _bit_equal(mine, bp_decode_lifted(lg, synd, llr0, **kw))
    assert 0 < int(mine[2].sum()) < 16

    hard, llr, conv, iters = (np.asarray(x) for x in jlifted_sharded_bp_fn(
        JShardedLiftedGraph(jg, 2), _jmesh(4, 2), **kw)(synd_pad, llr0))
    assert np.array_equal(mine[2].numpy(), conv)
    assert np.array_equal(mine[3].numpy(), iters)
    assert np.array_equal(mine[0].numpy(), hard)
    confident = np.abs(llr) > 1.0
    assert np.array_equal(np.sign(mine[1].numpy()[confident]), np.sign(llr[confident]))
    if bp_method == "minimum_sum":
        np.testing.assert_allclose(mine[1].numpy(), llr, rtol=0, atol=1e-3)


def test_lifted_sharded_bposd_end_to_end():
    H, q, jg, lg, synd, synd_pad, llr0 = _case(PROTO, LIFT, 2, 16, 0.06, 29)
    kw = dict(max_iter=12, ms_scaling_factor=0.0, osd_method="osd_cs", osd_order=4)
    osdw, conv = lifted_sharded_bposd_fn(lg, H, cpu_mesh_2d(4, 2), n_shards=2, **kw)(
        synd_pad, llr0)

    bp = bp_decode_lifted(lg, synd, llr0, max_iter=12, ms_scaling_factor=0.0)
    graph = TannerGraph(H, device="cpu")
    osd = osd_decode(graph, synd, bp.llr, osd_method="osd_cs", osd_order=4,
                     consts=build_osd_consts(graph, "osd_cs", 4), skip=bp.converged)
    want = torch.where(bp.converged[:, None], bp.hard, osd.osdw)
    assert torch.equal(osdw, want) and torch.equal(conv, bp.converged)
    assert 0 < int(conv.sum()) < 16

    # the JAX test's standard against JAX's sharded decode
    josdw, jconv = (np.asarray(x) for x in jlifted_sharded_bposd_fn(
        jg, H, _jmesh(4, 2), n_shards=2, **kw)(synd_pad, llr0))
    osdw, conv = osdw.numpy(), conv.numpy()
    assert np.array_equal(conv, jconv)
    assert np.array_equal(osdw[conv], josdw[conv])
    assert np.array_equal(osdw.astype(int) @ H.T % 2, synd)
    disagree = ~(osdw == josdw).all(axis=1)
    assert not (disagree & conv).any()
    np.testing.assert_array_equal(osdw[disagree].sum(axis=1), josdw[disagree].sum(axis=1))


def test_lifted_sharded_uneven_blockrows():
    """mp = 6 over 4 shards: mp_chunk 2, two empty pad block rows."""
    H, q, jg, lg, synd, synd_pad, llr0 = _case(UNEVEN, 8, 4, 8, 0.05, 31)
    sg = ShardedLiftedGraph(lg, 4)
    assert sg.mp_chunk == 2 and sg.n_shards * sg.mp_chunk - lg.mp == 2
    kw = dict(max_iter=10, ms_scaling_factor=0.625)
    mine = lifted_sharded_bp_fn(sg, cpu_mesh_2d(2, 4), **kw)(synd_pad, llr0)
    _bit_equal(mine, bp_decode_lifted(lg, synd, llr0, **kw))
    hard, _, conv, _ = (np.asarray(x) for x in jlifted_sharded_bp_fn(
        JShardedLiftedGraph(jg, 4), _jmesh(2, 4), **kw)(synd_pad, llr0))
    assert np.array_equal(mine[2].numpy(), conv)
    assert np.array_equal(mine[0].numpy(), hard)


def test_lifted_sharded_nshards1_is_unsharded():
    """One model shard goes straight to ``bp_decode_lifted`` on each data
    group, as JAX's does."""
    H, q, jg, lg, synd, synd_pad, llr0 = _case(PROTO, LIFT, 1, 16, 0.05, 37)
    kw = dict(bp_method="minimum_sum", max_iter=15, ms_scaling_factor=0.0)
    mine = lifted_sharded_bp_fn(ShardedLiftedGraph(lg, 1), cpu_mesh_2d(8, 1), **kw)(
        synd_pad, llr0)
    _bit_equal(mine, bp_decode_lifted(lg, synd, llr0, **kw))
    hard, llr, conv, iters = (np.asarray(x) for x in jlifted_sharded_bp_fn(
        JShardedLiftedGraph(jg, 1), _jmesh(8, 1), **kw)(synd_pad, llr0))
    np.testing.assert_array_equal(mine[0].numpy(), hard)
    np.testing.assert_array_equal(mine[2].numpy(), conv)
    np.testing.assert_array_equal(mine[3].numpy(), iters)
    np.testing.assert_allclose(mine[1].numpy(), llr, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("proto,lift,n_shards", [(PROTO, LIFT, 2), (UNEVEN, 8, 4),
                                                 (UNEVEN, 8, 1)])
def test_from_reference_checks_the_jax_partition(proto, lift, n_shards):
    q = jlifted_hgp(proto, lift=lift)
    jg = JLiftedGraph(q.hx_proto, lift)
    js = JShardedLiftedGraph(jg, n_shards)
    fields = dict(lg=_jfields(jg, q.hx_proto), n_shards=js.n_shards, mp_chunk=js.mp_chunk,
                  pairs=js.pairs, route=js.route, chk_mask=js.chk_mask)
    sg = ShardedLiftedGraph.from_reference(fields, device="cpu")
    assert (sg.mp_chunk, sg.pairs) == (js.mp_chunk, js.pairs)
    route = js.route.copy()
    route[0, 0, 0, 0] = 1 - route[0, 0, 0, 0]
    with pytest.raises(ValueError, match="route"):
        ShardedLiftedGraph.from_reference(dict(fields, route=route), device="cpu")
    with pytest.raises(ValueError, match="pairs"):
        ShardedLiftedGraph.from_reference(dict(fields, pairs=js.pairs[1:]), device="cpu")
