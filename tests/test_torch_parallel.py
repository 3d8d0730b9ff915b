"""bp_osd_tpu_torch.parallel on CPU meshes against the JAX package's parallel
layer over its 8 virtual CPU devices (tests/conftest.py).

The same syndromes, made with numpy, go through JAX ``sharded_decode_fn``
over ``make_mesh(k)``, the port's over ``cpu_mesh(k)``, and the port's
unsharded ``bp_decode`` + ``osd_decode``; all four outputs must be equal,
exactly.
"""

import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.codes import rep_code as jrep_code
from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.parallel import make_mesh as jmake_mesh
from bp_osd_tpu.parallel import pad_batch as jpad_batch
from bp_osd_tpu.parallel import sharded_decode_fn as jsharded_decode_fn

from bp_osd_tpu_torch.decoder import TannerGraph, bp_decode, llr_from_channel, osd_decode
from bp_osd_tpu_torch.ops import count_launch, launch_counter
from bp_osd_tpu_torch.parallel import (Mesh, cpu_mesh, make_mesh, pad_batch, shard_batch_fn,
                                       shard_decode_fn, sharded_decode_fn)
from bp_osd_tpu_torch.parallel.shard_pallas import _Workers, replicate

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "flagship_corpus.npz")
MESHES = [1, 2, 4, 8]


def _surface_case():
    """tests/test_parallel.py's batch: the distance-3 surface code's hz,
    32 syndromes at p = 0.1."""
    H = np.asarray(jhgp(jrep_code(3), jrep_code(3)).hz.toarray(), np.uint8)
    rng = np.random.default_rng(3)
    errors = (rng.random((32, H.shape[1])) < 0.1).astype(np.uint8)
    kw = dict(bp_method="ms", max_iter=13, ms_scaling_factor=0.625)
    return H, (errors @ H.T % 2).astype(np.uint8), 0.1, kw


def _flagship_case():
    """The 512 rows of the flagship corpus ([[400,16,6]], p = 0.05, adaptive
    min-sum, max_iter 400).  All of them: XLA:CPU adds a variable's messages
    in the port's order at the flagship only from 64 rows a device on (at 8
    or 16 it picks another order, and JAX's own results change with the
    shard size), so 8 devices need 512 rows."""
    H = np.asarray(jhgp(jmkmn_16_4_6()).hx.toarray(), np.uint8)
    data = np.load(CORPUS)
    synd = np.unpackbits(data["synd_packed"], axis=1)[:, :H.shape[0]]
    kw = dict(bp_method="minimum_sum", max_iter=400, ms_scaling_factor=0.0)
    return H, synd, 0.05, kw


CASES = {
    "surface-osd_cs7": (_surface_case, "osd_cs", 7),
    "flagship-osd0": (_flagship_case, "osd0", 0),
    "flagship-osd_cs42": (_flagship_case, "osd_cs", 42),
}


def _unsharded(g, synd, llr0, osd_method, osd_order, kw):
    bp = bp_decode(g, synd, llr0, **kw)
    osd = osd_decode(g, synd, bp.llr, osd_method=osd_method, osd_order=osd_order)
    keep = bp.converged[:, None]
    return (torch.where(keep, bp.hard, osd.osdw), torch.where(keep, bp.hard, osd.osd0),
            bp.hard, bp.converged)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_decode_equals_jax_and_unsharded(case):
    make, osd_method, osd_order = CASES[case]
    H, synd, p, kw = make()
    B, n = synd.shape[0], H.shape[1]
    llr0 = np.broadcast_to(np.asarray(jllr_from_channel(np.full(n, p))), (B, n)).copy()
    assert np.array_equal(llr0[0], llr_from_channel(np.full(n, p)).numpy())
    g = TannerGraph(H, device="cpu")
    want = [x.numpy() for x in _unsharded(g, synd, llr0, osd_method, osd_order, kw)]
    assert 0 < want[3].sum() < B  # rows of both kinds
    jg = JTannerGraph(H)
    for k in MESHES:
        mesh = cpu_mesh(k)
        got = sharded_decode_fn(g, mesh, osd_method=osd_method, osd_order=osd_order, **kw)(
            synd, llr0)
        jout = jsharded_decode_fn(jg, jmake_mesh(k), osd_method=osd_method,
                                  osd_order=osd_order, **kw)(synd, llr0)
        for name, a, j, w in zip(("osdw", "osd0", "bp_hard", "converged"), got, jout, want):
            assert a.dtype == torch.from_numpy(w).dtype, name
            assert np.array_equal(a.numpy(), w), (k, name)
            assert np.array_equal(np.asarray(j).astype(w.dtype), w), (k, name)
    osdw = want[0]
    assert np.array_equal(osdw.astype(int) @ H.T % 2, synd)


def test_shards_of_one_row():
    """B equal to the mesh size: every shard decodes a single row, and the
    OSD of a row does not depend on its offset in the batch."""
    H, synd, p, kw = _flagship_case()
    n = H.shape[1]
    g = TannerGraph(H, device="cpu")
    llr0 = llr_from_channel(np.full(n, p)).expand(8, n)
    rows = synd[:8]
    want = _unsharded(g, rows, llr0, "osd_cs", 42, kw)
    got = sharded_decode_fn(g, cpu_mesh(8), osd_method="osd_cs", osd_order=42, **kw)(rows, llr0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pad_batch_matches_jax():
    for B, multiple in ((13, 8), (16, 8), (1, 4), (7, 1)):
        arr = np.arange(B * 3, dtype=np.int32).reshape(B, 3) + 1
        got, got_B = pad_batch(arr, multiple)
        want, want_B = jpad_batch(arr, multiple)
        assert got_B == want_B == B
        assert got.dtype == want.dtype and np.array_equal(got, np.asarray(want))
    padded, _ = pad_batch(np.ones((13, 4)), 8)
    assert padded.shape == (16, 4) and not padded[13:].any()


def test_indivisible_batch_raises():
    H, synd, p, kw = _surface_case()
    g = TannerGraph(H, device="cpu")
    llr0 = llr_from_channel(np.full(H.shape[1], p)).expand(30, H.shape[1])
    decode = sharded_decode_fn(g, cpu_mesh(4), **kw)
    with pytest.raises(ValueError, match="does not split evenly"):
        decode(synd[:30], llr0)
    with pytest.raises(ValueError, match="axis"):
        sharded_decode_fn(g, cpu_mesh(2), axis_name="model", **kw)


def test_make_mesh_needs_the_cards():
    count = torch.cuda.device_count()
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(count + 1)
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(0)
    if count == 0:
        with pytest.raises(ValueError, match="cpu_mesh"):
            make_mesh()


def test_mesh_devices():
    mesh = cpu_mesh(3, axis_name="batch")
    assert len(mesh) == 3 and mesh.axis_name == "batch"
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert Mesh(("cuda:1", "cuda:0")).devices == (torch.device("cuda", 1), torch.device("cuda", 0))
    with pytest.raises(ValueError, match="at least one"):
        Mesh(())
    with pytest.raises(ValueError, match="CPU and CUDA"):
        Mesh((torch.device("meta"),))


def test_shard_fns_keep_batch_order_and_replicate_constants():
    mesh = cpu_mesh(4)
    seen = []

    def batch_fn(batch, consts):
        seen.append((batch[:, 0].tolist(), consts["scale"], consts["table"]))
        assert torch.is_tensor(consts["table"]) and consts["tag"] == "c"
        return {"y": batch * consts["scale"] + consts["table"].sum(), "first": batch[:, 0]}

    x = torch.arange(24).reshape(8, 3)
    consts = {"scale": 10, "table": np.array([1, 2]), "tag": "c"}
    out = shard_batch_fn(batch_fn, mesh)(x, consts)
    assert torch.equal(out["y"], x * 10 + 3) and torch.equal(out["first"], x[:, 0])
    assert [s[0] for s in seen] == [[0, 3], [6, 9], [12, 15], [18, 21]]  # shard order
    assert all(s[1] == 10 and torch.equal(s[2], torch.tensor([1, 2])) for s in seen)

    def decode_fn(offset, a, b):
        return a + offset, (b * 2, None)

    fn = shard_decode_fn(decode_fn, mesh, n_const_args=1)
    a, (b, none) = fn(torch.tensor(5), np.arange(8), torch.arange(8).reshape(8, 1))
    assert torch.equal(a, torch.arange(8) + 5) and none is None
    assert torch.equal(b, 2 * torch.arange(8).reshape(8, 1))
    with pytest.raises(ValueError, match="does not split evenly"):
        fn(torch.tensor(0), np.arange(6), np.arange(6))


def test_replicate_walks_containers():
    H, *_ = _surface_case()
    g = TannerGraph(H, device="cpu")
    tree = {"g": g, "t": (np.zeros(3, np.int32), torch.ones(2), None, 7, "s")}
    out = replicate(tree, torch.device("cpu"))
    assert out["g"] is g  # already on the device: no copy
    t = out["t"]
    assert isinstance(t, tuple) and torch.is_tensor(t[0]) and t[0].dtype == torch.int32
    assert t[2:] == (None, 7, "s")


def test_shard_groups_on_threads_keep_order_and_raise():
    """The workers of a mesh over several devices, on the CPU: results in
    shard order, a device's shards on one thread of its own that stays from
    call to call, and a failing shard's exception reaches the caller after
    every group ran."""
    devices = [torch.device("cpu", i) for i in (0, 1, 0, 1, 2)]
    workers = _Workers(devices)
    assert workers.groups == [[0, 2], [1, 3], [4]]
    ran = {}

    def work(k):
        ran.setdefault(k, set()).add(threading.get_ident())
        return k * k

    for _ in range(3):
        assert workers.run(work) == [0, 1, 4, 9, 16]
    threads = [set().union(*(ran[k] for k in g)) for g in workers.groups]
    assert all(len(t) == 1 for t in threads)  # one thread a device, kept
    assert len(set().union(*threads)) == 3 and threading.get_ident() not in set().union(*threads)

    done = []

    def failing(k):
        if k == 1:
            raise RuntimeError("shard 1 failed")
        done.append(k)
        return k

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        workers.run(failing)
    assert sorted(done) == [0, 2, 4]  # the failing group stops at its shard


def test_launch_counts_exact_under_threads():
    """More threads than cores add launches at once with a short switch
    interval: no update is lost, in the total or by card."""
    def fake():
        pass

    launch_counter(fake)
    fake.extra = 0
    threads, per = 16, 2000
    devs = [torch.device("cuda", i % 2) for i in range(threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda d=d: [count_launch(fake, d, "extra")
                                                   for _ in range(per)]) for d in devs]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert fake.launches == fake.extra == threads * per
    assert fake.launches_on == {0: threads * per // 2, 1: threads * per // 2}


def test_jax_runs_on_the_virtual_devices():
    assert len(jax.devices()) == 8
