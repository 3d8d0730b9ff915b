"""The port's CPU product-sum BP at real thread counts, and the device its
graphs take when the caller names none.

Threads.  On the CPU, ATen splits an elementwise op on more than 32768
elements between its intra-op threads, and every thread's piece ends in a
scalar libm tail whose ``atanh`` can differ from the vector (SLEEF) path in
the last ulp.  ``decoder/bp.py:_elementwise`` pads ``tanh``/``atanh`` inputs
so that no piece has such a tail; these tests hold it to that at 2, 3, 4 and
8 threads: elementwise against 4096-element blocks (which ATen never
splits), and the edge-sharded, block-row-sharded and data-sharded
product-sum BPs against the unsharded one, bit for bit, on tensors above
32768 elements.  Under ``pytest-xdist`` every worker imports every test
module while it collects, and most ``tests/test_torch_*.py`` pin
``torch.set_num_threads(1)`` at import, so the ``threads`` fixture sets the
count inside each test and restores it after.

Devices.  ``TannerGraph``, ``LayeredTannerGraph`` and ``LiftedGraph`` with
no ``device`` take ``resolve_device``'s: the card when
``torch.cuda.is_available()``, else the CPU; ``device="cuda"`` without a
card raises.
"""

import numpy as np
import pytest
import torch

from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.codes import rep_code as jrep_code
from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder import bp_decode as jbp_decode
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.decoder.osd import build_osd_consts as jbuild_osd_consts
from bp_osd_tpu.decoder.pipeline import decode_pipeline as jdecode_pipeline

from bp_osd_tpu_torch.codes import lifted_hgp
from bp_osd_tpu_torch.decoder import LayeredTannerGraph, TannerGraph, bp_decode, decode_pipeline
from bp_osd_tpu_torch.decoder import bp as bp_module
from bp_osd_tpu_torch.decoder import tanner
from bp_osd_tpu_torch.decoder.bp import _aligned_length, _elementwise
from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
from bp_osd_tpu_torch.parallel import (ShardedTannerGraph, cpu_mesh, cpu_mesh_2d,
                                       edge_sharded_bp_fn, sharded_decode_fn)
from bp_osd_tpu_torch.parallel.lifted_shard import ShardedLiftedGraph, lifted_sharded_bp_fn

PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]
LIFT = 40  # the [[1000]] lift of tests/test_torch_kernels.py's model-sharded case
PS = dict(bp_method="product_sum", max_iter=30)


@pytest.fixture
def threads(request):
    old = torch.get_num_threads()
    torch.set_num_threads(request.param)
    yield request.param
    torch.set_num_threads(old)


def _values(fn, numel, seed):
    rng = np.random.default_rng(seed)
    hi = 1.0 if fn is torch.atanh else 8.0
    return torch.from_numpy(rng.uniform(-hi, hi, numel).astype(np.float32))


def _blocks(fn, x):
    """``fn`` over 4096-element blocks (the last zero-padded): ATen runs a
    block in one piece whatever the thread count, on the vector path."""
    pad = (-x.numel()) % 4096
    xp = torch.cat([x, x.new_zeros(pad)])
    return torch.cat([fn(b) for b in xp.split(4096)])[: x.numel()]


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("threads", [2, 3, 8], indirect=True)
@pytest.mark.parametrize("numel", [200_000, 100_003])
@pytest.mark.parametrize("fn", [torch.atanh, torch.tanh], ids=["atanh", "tanh"])
def test_elementwise_ignores_the_thread_count(threads, numel, fn):
    x = _values(fn, numel, numel)
    assert torch.get_num_threads() == threads
    assert _same_bits(_elementwise(fn, x), _blocks(fn, x))
    assert _same_bits(_elementwise(fn, x.view(-1, 1)).view(-1), _blocks(fn, x))


@pytest.mark.parametrize("threads", [1], indirect=True)
@pytest.mark.parametrize("numel", [200_000, 100_003, 1_000])
@pytest.mark.parametrize("fn", [torch.atanh, torch.tanh], ids=["atanh", "tanh"])
def test_one_thread_keeps_the_earlier_bits(threads, numel, fn):
    """At one thread the padding is the earlier one (a multiple of 64), so
    every gate measured single-threaded holds unchanged."""
    x = _values(fn, numel, numel + 1)
    earlier = fn(torch.cat([x, x.new_zeros((-numel) % 64)]))[:numel]
    assert _aligned_length(numel, 1) == numel + (-numel) % 64
    assert _same_bits(_elementwise(fn, x), earlier)


@pytest.mark.parametrize("threads", [2, 3, 5, 8, 64])
def test_aligned_length_is_the_least_whole_split(threads):
    """Against a walk over every multiple of 64: the least length >= numel
    whose ATen pieces (``T = min(threads, ceil(L / 32768))`` of
    ``ceil(L / T)`` elements) are whole multiples of 64."""
    grain = bp_module._GRAIN

    def whole(L):
        t = 1 if L <= grain else min(threads, -(-L // grain))
        return L % (64 * t) == 0

    rng = np.random.default_rng(threads)
    edges = [k * grain + d for k in range(1, 10) for d in (-64 * threads, -1, 0, 1, 63)]
    for numel in [1, 64, 32767, 32768, 32769, *edges, *rng.integers(1, 12 * grain, 40)]:
        numel = int(numel)
        L = numel + (-numel) % 64
        while not whole(L):
            L += 64
        assert _aligned_length(numel, threads) == L, numel


def _flagship(B, p, seed):
    H = np.asarray(jhgp(jmkmn_16_4_6()).hx.toarray(), np.uint8)
    rng = np.random.default_rng(seed)
    synd = ((rng.random((B, H.shape[1])) < p).astype(np.uint8) @ H.T % 2).astype(np.uint8)
    llr0 = np.broadcast_to(np.asarray(jllr_from_channel(np.full(H.shape[1], p))),
                           (B, H.shape[1])).copy()
    return H, synd, llr0


def _bit_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert _same_bits(got[1], want[1])  # llr, -0.0 too


@pytest.mark.parametrize("threads", [4], indirect=True)
@pytest.mark.parametrize("B", [64, 256])
def test_edge_sharded_product_sum_equals_unsharded(threads, B):
    H, synd, llr0 = _flagship(B, 0.06, 17)
    sg = ShardedTannerGraph(H, 2)
    assert B * sg.m_chunk * sg.wr > 32768
    synd_pad = np.pad(synd, ((0, 0), (0, 2 * sg.m_chunk - H.shape[0])))
    got = edge_sharded_bp_fn(sg, cpu_mesh_2d(1, 2), **PS).decode(synd_pad, llr0)
    want = bp_decode(TannerGraph(H, device="cpu"), synd, llr0, **PS)
    assert 0 < int(want.converged.sum()) < B
    _bit_equal(got, want)


@pytest.mark.parametrize("threads", [4], indirect=True)
def test_unsharded_product_sum_against_one_thread_and_jax(threads):
    """The unsharded product-sum BP at 4 threads equals itself at one
    thread, bit for bit (256 flagship rows), and JAX at
    ``tests/test_torch_bp.py:test_product_sum``'s standard on that test's
    code (the distance-3 surface code's hx, p = 0.08, max_iter 20) at 4096
    rows: decisions equal, llr within 1e-4.  At the flagship, XLA and torch
    part by up to 2.4 in llr within 5 iterations, at one thread as at four:
    a last-ulp difference in a check product near the ``1 - 1e-7`` clip
    moves ``2 * atanh`` by ~0.6."""
    H, synd, llr0 = _flagship(256, 0.06, 17)
    g = TannerGraph(H, device="cpu")
    mine = bp_decode(g, synd, llr0, **PS)
    torch.set_num_threads(1)
    _bit_equal(mine, bp_decode(g, synd, llr0, **PS))
    torch.set_num_threads(threads)

    H = np.asarray(jhgp(jrep_code(3), jrep_code(3)).hx.toarray(), np.uint8)
    rng = np.random.default_rng(9)
    synd = ((rng.random((4096, H.shape[1])) < 0.08).astype(np.uint8) @ H.T % 2).astype(np.uint8)
    llr0 = np.broadcast_to(np.asarray(jllr_from_channel(np.full(H.shape[1], 0.08))),
                           (4096, H.shape[1])).copy()
    g = TannerGraph(H, device="cpu")
    assert 4096 * g.m * g.wr > 32768
    kw = dict(bp_method="product_sum", max_iter=20)
    mine = bp_decode(g, synd, llr0, **kw)
    ref = jbp_decode(JTannerGraph(H), synd, llr0, **kw)
    assert 0 < int(mine.converged.sum()) < 4096
    for k in ("hard", "converged", "iterations"):
        assert np.array_equal(getattr(mine, k).numpy(), np.asarray(getattr(ref, k))), k
    np.testing.assert_allclose(mine.llr.numpy(), np.asarray(ref.llr), rtol=0, atol=1e-4)


@pytest.mark.parametrize("threads", [4], indirect=True)
@pytest.mark.parametrize("B", [64, 256])
def test_lifted_sharded_product_sum_equals_unsharded(threads, B):
    q = lifted_hgp(PROTO, lift=LIFT)
    H = np.asarray(q.hx.toarray(), np.uint8)
    m, n = H.shape
    rng = np.random.default_rng(23)
    synd = ((rng.random((B, n)) < 0.03).astype(np.uint8) @ H.T % 2).astype(np.uint8)
    llr0 = np.broadcast_to(np.asarray(jllr_from_channel(np.full(n, 0.03))), (B, n)).copy()
    lg = LiftedGraph(q.hx_proto, LIFT, device="cpu")
    sg = ShardedLiftedGraph(lg, 2)
    assert B * sg.mp_chunk * LIFT * lg.wr > 32768
    synd_pad = np.pad(synd, ((0, 0), (0, 2 * sg.mp_chunk * LIFT - m)))
    got = lifted_sharded_bp_fn(sg, cpu_mesh_2d(1, 2), **PS)(synd_pad, llr0)
    want = bp_decode_lifted(lg, synd, llr0, **PS)
    assert 0 < int(want.converged.sum()) < B
    _bit_equal(got, want)


@pytest.mark.parametrize("threads", [4], indirect=True)
def test_data_sharded_product_sum_equals_one_shard(threads):
    """2048 flagship rows at 100 iterations: 512 rows a shard, every BP
    tensor above 32768 elements until most rows have converged."""
    H, synd, llr0 = _flagship(2048, 0.06, 19)
    g = TannerGraph(H, device="cpu")
    kw = dict(bp_method="product_sum", max_iter=100, osd_method="osd_cs", osd_order=7)
    one = sharded_decode_fn(g, cpu_mesh(1), **kw)(synd, llr0)
    four = sharded_decode_fn(g, cpu_mesh(4), **kw)(synd, llr0)
    assert 0 < int(one[3].sum()) < 2048
    for name, a, b in zip(("osdw", "osd0", "bp_hard", "converged"), four, one):
        assert torch.equal(a, b), name


def test_resolve_device_follows_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tanner.resolve_device() == torch.device("cuda", 0)
    assert tanner.resolve_device(None, "cuda") == torch.device("cuda", 0)
    assert tanner.resolve_device(None, "torch") == torch.device("cpu")
    assert tanner.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tanner.resolve_device() == torch.device("cpu")
    assert tanner.resolve_device(None, "auto") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tanner.resolve_device(None, "cuda")


def _graph_makers():
    """Each graph class, as a function of its keyword arguments."""
    H = np.asarray(jhgp(jmkmn_16_4_6()).hx.toarray(), np.uint8)
    q = lifted_hgp(PROTO, lift=8)
    return (lambda **kw: TannerGraph(H, **kw), lambda **kw: LayeredTannerGraph(H, **kw),
            lambda **kw: LiftedGraph(q.hx_proto, 8, **kw))


def test_graphs_take_the_helpers_device(monkeypatch):
    makers = _graph_makers()
    for make in makers:
        assert make().device == tanner.resolve_device()
    if torch.cuda.is_available():
        return
    assert all(make().device == torch.device("cpu") for make in makers)
    # with a card reported, each graph goes for it (and this CPU build of
    # torch, having none, refuses the copy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for make in makers:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            make()


def test_graph_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in _graph_makers():
        for dev in ("cuda", "cuda:0", torch.device("cuda", 1)):
            with pytest.raises(RuntimeError, match="CUDA card"):
                make(device=dev)
    fields = TannerGraph(np.eye(3, dtype=np.uint8), device="cpu").fields()
    with pytest.raises(RuntimeError, match="CUDA card"):
        TannerGraph.from_reference(fields, device="cuda")


def test_pipeline_on_a_default_graph_equals_jax():
    """``decode_pipeline(TannerGraph(H), numpy syndromes)`` at the flagship's
    settings (adaptive min-sum, max_iter 400, osd_cs 42) against JAX."""
    H, synd, _ = _flagship(64, 0.05, 2027)
    llr0 = np.asarray(jllr_from_channel(np.full(H.shape[1], 0.05)))
    kw = dict(max_iter=400, osd_method="osd_cs", osd_order=42, bp_method="minimum_sum",
              ms_scaling_factor=0.0)
    graph = TannerGraph(H)
    mine = decode_pipeline(graph, synd, llr0, **kw)
    assert mine.osdw.device == graph.device == tanner.resolve_device()
    jg = JTannerGraph(H)
    ref = jdecode_pipeline(jg, synd, llr0, consts=jbuild_osd_consts(jg, "osd_cs", 42),
                           backend="xla", **kw)
    assert 0 < int(mine.converged.sum()) < 64
    for k in ("osdw", "osd0", "bp_hard", "converged", "iterations", "llr"):
        assert np.array_equal(getattr(mine, k).cpu().numpy(), np.asarray(getattr(ref, k))), k
