"""bp_osd_tpu_torch.parallel.edge_shard on CPU meshes against the port's
unsharded BP and the JAX package's edge-sharded BP.

The same syndromes, made with numpy from a seed, go through JAX
``edge_sharded_bp_fn`` on its 8 virtual CPU devices (``tests/conftest.py``)
and the port's over ``cpu_mesh_2d`` of the same shape.  Against the port's
unsharded ``bp_decode_plain`` the sharded BP is equal bit for bit (hard, llr,
converged, iterations); against JAX it meets the JAX tests' own standard
(``tests/test_edge_shard.py``): hard and converged equal, llr signs equal
where ``|llr| > 1``, min-sum llr within 1e-3 (XLA's ``psum`` tree and its
CPU summation order change with the shard size).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.codes import rep_code as jrep_code
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.parallel.edge_shard import ShardedTannerGraph as JShardedTannerGraph
from bp_osd_tpu.parallel.edge_shard import edge_sharded_bp_fn as jedge_sharded_bp_fn

from bp_osd_tpu_torch.decoder.bp import bp_decode_plain, llr_from_channel
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.parallel import (Mesh2D, ShardedTannerGraph, cpu_mesh, cpu_mesh_2d,
                                       edge_sharded_bp_fn, make_mesh_2d)

torch.set_num_threads(1)

CODES = {
    "flagship": lambda: jhgp(jmkmn_16_4_6()).hx,
    "rep54": lambda: jhgp(jrep_code(5), jrep_code(4)).hz,  # m = 15: uneven over 4 shards
}
METHODS = {"ms0.625": ("minimum_sum", 0.625), "ms-adaptive": ("minimum_sum", 0.0),
           "ps": ("product_sum", 0.0)}


def _jmesh(data, model):
    devs = np.asarray(jax.devices()[: data * model]).reshape(data, model)
    return JMesh(devs, ("data", "model"))


def _inputs(H, sg, B, p, seed):
    rng = np.random.default_rng(seed)
    m, n = H.shape
    synd = ((rng.random((B, n)) < p).astype(np.uint8) @ H.T % 2).astype(np.uint8)
    synd_pad = np.pad(synd, ((0, 0), (0, sg.n_shards * sg.m_chunk - m)))
    llr0 = np.broadcast_to(np.asarray(jllr_from_channel(np.full(n, p))), (B, n)).copy()
    assert np.array_equal(llr0[0], llr_from_channel(np.full(n, p)).numpy())
    return synd, synd_pad, llr0


def _unsharded(H, synd, llr0, method, msf, max_iter):
    g = TannerGraph(H, device="cpu")
    return bp_decode_plain(g, torch.as_tensor(synd), torch.as_tensor(llr0), method=method,
                           max_iter=max_iter, ms_scaling_factor=msf)[:4]


def _hold_to_jax(mine, ref, method):
    """The JAX tests' standard (``tests/test_edge_shard.py:46-55``)."""
    hard, llr, conv = (np.asarray(x) for x in ref)
    assert np.array_equal(mine.converged.numpy(), conv)
    assert np.array_equal(mine.hard.numpy(), hard)
    confident = np.abs(llr) > 1.0
    assert np.array_equal(np.sign(mine.llr.numpy()[confident]), np.sign(llr[confident]))
    if method == "minimum_sum":
        np.testing.assert_allclose(mine.llr.numpy(), llr, rtol=0, atol=1e-3)


CASES = [  # code, n_shards, data groups, method
    *[("flagship", 2, 4, k) for k in METHODS],
    ("flagship", 1, 8, "ms-adaptive"),
    ("flagship", 4, 2, "ms0.625"),
    ("flagship", 4, 2, "ps"),
    ("rep54", 4, 2, "ms0.625"),
    ("rep54", 4, 2, "ps"),
]


@pytest.mark.parametrize("code,n_shards,data,method", CASES)
def test_edge_sharded_bp_equals_unsharded_and_jax(code, n_shards, data, method):
    H = np.asarray(CODES[code]().toarray(), np.uint8)
    bp_method, msf = METHODS[method]
    max_iter = 12 if code == "flagship" else 10
    sg = ShardedTannerGraph(H, n_shards)
    synd, synd_pad, llr0 = _inputs(H, sg, 16, 0.06 if code == "flagship" else 0.08, 17)
    decode = edge_sharded_bp_fn(sg, cpu_mesh_2d(data, n_shards), bp_method=bp_method,
                                max_iter=max_iter, ms_scaling_factor=msf)
    mine = decode.decode(synd_pad, llr0)
    want = _unsharded(H, synd, llr0, bp_method, msf, max_iter)
    for name, a, b in zip(mine._fields, mine, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert torch.equal(mine.llr.view(torch.int32), want[1].view(torch.int32))  # -0.0 too
    assert 0 < int(mine.converged.sum()) < 16
    assert [torch.equal(a, b) for a, b in zip(decode(synd_pad, llr0), mine[:3])] == [True] * 3

    jsg = JShardedTannerGraph(H, n_shards)
    ref = jedge_sharded_bp_fn(jsg, _jmesh(data, n_shards), bp_method=bp_method,
                              max_iter=max_iter, ms_scaling_factor=msf)(synd_pad, llr0)
    _hold_to_jax(mine, ref, bp_method)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_from_reference_round_trips_the_jax_partition(n_shards):
    """The port's partition equals JAX's field for field, and reassembles H
    (``tests/test_edge_shard.py:test_sharded_graph_partition_covers_matrix``)."""
    H = np.asarray(CODES["rep54"]().toarray(), np.uint8)
    j = JShardedTannerGraph(H, n_shards)
    fields = {f: getattr(j, f) for f in ShardedTannerGraph._FIELDS}
    sg = ShardedTannerGraph.from_reference(fields)
    m, n = H.shape
    rebuilt = np.zeros((sg.n_shards * sg.m_chunk, n), np.uint8)
    d, i, s = np.nonzero(sg.chk_mask)
    rebuilt[d * sg.m_chunk + i, sg.chk_var[d, i, s]] = 1
    assert np.array_equal(rebuilt[:m], H) and not rebuilt[m:].any()
    bad = dict(fields, chk_var=np.roll(fields["chk_var"], 1, axis=-1))
    with pytest.raises(ValueError, match="chk_var"):
        ShardedTannerGraph.from_reference(bad)
    with pytest.raises(ValueError, match="m_chunk"):
        ShardedTannerGraph.from_reference(dict(fields, m_chunk=fields["m_chunk"] + 1))


def test_mesh_and_batch_checks():
    H = np.asarray(CODES["rep54"]().toarray(), np.uint8)
    sg = ShardedTannerGraph(H, 2)
    with pytest.raises(ValueError, match="2 shards"):
        edge_sharded_bp_fn(sg, cpu_mesh_2d(2, 4))
    with pytest.raises(ValueError, match="Mesh2D"):
        edge_sharded_bp_fn(sg, cpu_mesh(2))
    with pytest.raises(ValueError, match="axis"):
        edge_sharded_bp_fn(sg, cpu_mesh_2d(1, 2), model_axis="tensor")
    decode = edge_sharded_bp_fn(sg, cpu_mesh_2d(4, 2), max_iter=5)
    synd, synd_pad, llr0 = _inputs(H, sg, 6, 0.1, 1)
    with pytest.raises(ValueError, match="does not split evenly"):
        decode(synd_pad, llr0)
    with pytest.raises(ValueError, match="syndromes_pad"):
        decode(synd, llr0)  # the unpadded width


def test_mesh_2d_axes_and_groups():
    mesh = Mesh2D(tuple(torch.device("cpu", i) for i in range(6)), (3, 2), ("batch", "tp"))
    assert len(mesh) == 6 and mesh.size("batch") == 3 and mesh.size("tp") == 2
    assert [[d.index for d in g] for g in mesh.groups("batch")] == [[0, 1], [2, 3], [4, 5]]
    assert [[d.index for d in g] for g in mesh.groups("tp")] == [[0, 2, 4], [1, 3, 5]]
    assert mesh.flat().devices == mesh.devices and mesh.flat().axis_name == "batch,tp"
    assert cpu_mesh_2d(2, 2).devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh2D((torch.device("cpu"),) * 3, (2, 2))
    with pytest.raises(ValueError, match="distinct"):
        Mesh2D((torch.device("cpu"),), (1, 1), ("data", "data"))
    with pytest.raises(ValueError, match="axis"):
        mesh.size("data")
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh_2d(1, cards + 1)
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh_2d(0, 2)
