"""bp_osd_tpu_torch.parallel.large_code on CPU meshes: edge-sharded BP, then
the gather-to-DP OSD, against the port's unsharded BP + OSD (bit for bit)
and the JAX package's ``edge_sharded_bposd_fn`` (the standard of
``tests/test_large_code.py``) on the same numpy-made inputs.

The card's routes are checked here through ``osd_route`` (the lift-400 code
goes to K5) and on the card by ``chip_smoke.py`` phase 16, which counts K5's
launches on every device of the mesh.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from bp_osd_tpu.codes import lifted_hgp as jlifted_hgp
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.parallel.edge_shard import ShardedTannerGraph as JShardedTannerGraph
from bp_osd_tpu.parallel.large_code import edge_sharded_bposd_fn as jedge_sharded_bposd_fn

from bp_osd_tpu_torch.codes import lifted_hgp
from bp_osd_tpu_torch.decoder.bp import bp_decode
from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph
from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode, osd_route
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.parallel import ShardedTannerGraph, cpu_mesh_2d
from bp_osd_tpu_torch.parallel.large_code import edge_sharded_bposd_fn

torch.set_num_threads(1)

PROTO = [[(0,), (1,), (3,)]]  # tests/test_large_code.py: 1x3 over F2[x]/(x^L - 1)
BENCH_PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]


def _case(lift, B, p, seed, n_shards=2):
    H = np.asarray(jlifted_hgp(PROTO, lift=lift).hx.toarray(), np.uint8)
    m, n = H.shape
    rng = np.random.default_rng(seed)
    synd = ((rng.random((B, n)) < p).astype(np.uint8) @ H.T % 2).astype(np.uint8)
    sg = ShardedTannerGraph(H, n_shards)
    synd_pad = np.pad(synd, ((0, 0), (0, sg.n_shards * sg.m_chunk - m)))
    llr0 = np.broadcast_to(np.asarray(jllr_from_channel(np.full(n, p))), (B, n)).copy()
    return H, sg, synd, synd_pad, llr0


def _unsharded(H, synd, llr0, kw, osd_kw):
    g = TannerGraph(H, device="cpu")
    bp = bp_decode(g, synd, llr0, **kw)
    osd = osd_decode(g, synd, bp.llr, consts=build_osd_consts(g, **osd_kw), skip=bp.converged,
                     **osd_kw)
    return torch.where(bp.converged[:, None], bp.hard, osd.osdw), bp.converged


@pytest.mark.parametrize("data,n_shards,p", [(4, 2, 0.04), (2, 4, 0.005)])
def test_edge_sharded_bposd_equals_unsharded_and_jax(data, n_shards, p):
    """At p = 0.04 (JAX's test) every row goes to OSD; at 0.005 a few
    converge and keep BP's decision."""
    H, sg, synd, synd_pad, llr0 = _case(40, 16, p, 5, n_shards)
    kw = dict(bp_method="minimum_sum", max_iter=10, ms_scaling_factor=0.625)
    osd_kw = dict(osd_method="osd_cs", osd_order=3)
    osdw, conv = edge_sharded_bposd_fn(sg, cpu_mesh_2d(data, n_shards), **kw, **osd_kw)(
        synd_pad, llr0)
    want, want_conv = _unsharded(H, synd, llr0, kw, osd_kw)
    assert osdw.dtype == torch.uint8 and torch.equal(osdw, want)
    assert torch.equal(conv, want_conv) and int(conv.sum()) < 16
    assert p > 0.01 or conv.any()

    # the JAX test's standard (tests/test_large_code.py:57-65) against JAX's
    jsg = JShardedTannerGraph(H, n_shards)
    josdw, jconv = (np.asarray(x) for x in jedge_sharded_bposd_fn(
        jsg, JMesh(np.asarray(jax.devices()[:8]).reshape(data, n_shards), ("data", "model")),
        **kw, **osd_kw)(synd_pad, llr0))
    osdw, conv = osdw.numpy(), conv.numpy()
    assert np.array_equal(conv, jconv)
    assert ((osdw.astype(int) @ H.T % 2) == synd).all()
    exact = (osdw == josdw).all(axis=1)
    assert exact.mean() >= 0.9, f"only {exact.sum()}/16 exact vs JAX"
    assert (osdw.sum(axis=1) <= josdw.sum(axis=1) + 1).all()


def test_osd_route_of_the_large_codes():
    """The counterpart of JAX's streamed-route test: on the card, osd_cs 15
    on the [[10000,420]] lift-400 code goes to K5 (its m, n and rank, the
    code itself is not built here), the lift-40 test code to K2."""
    lg = LiftedGraph(lifted_hgp(BENCH_PROTO, lift=8).hx_proto, 400, device="cpu")
    big = SimpleNamespace(m=lg.m, n=lg.n, rank=4790)  # K = 10000 - 2 * 4790 = 420
    assert (big.m, big.n) == (4800, 10000)
    assert osd_route(big, "osd_cs", 15) == "k5"
    assert osd_route(big, "osd0", 0) == "k5"
    H, *_ = _case(40, 1, 0.0, 0)
    assert osd_route(TannerGraph(H, device="cpu"), "osd_cs", 3) == "k2"


def test_osd_backend_and_batch_checks():
    H, sg, synd, synd_pad, llr0 = _case(24, 6, 0.05, 7)
    kw = dict(max_iter=8, osd_method="osd_cs", osd_order=3)
    with pytest.raises(RuntimeError, match="cuda"):
        edge_sharded_bposd_fn(sg, cpu_mesh_2d(2, 2), osd_backend="cuda", **kw)
    with pytest.raises(ValueError, match="backend"):
        edge_sharded_bposd_fn(sg, cpu_mesh_2d(2, 2), osd_backend="pallas", **kw)
    decode = edge_sharded_bposd_fn(sg, cpu_mesh_2d(2, 2), osd_backend="torch", **kw)
    with pytest.raises(ValueError, match="does not split evenly"):
        decode(synd_pad, llr0)  # 6 rows over 4 devices
    osdw, conv = decode(synd_pad[:4], llr0[:4])
    assert torch.equal(osdw, _unsharded(H, synd[:4], llr0[:4], dict(max_iter=8),
                                        dict(osd_method="osd_cs", osd_order=3))[0])
