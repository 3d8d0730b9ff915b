"""``decode_pipeline(..., stage1_iters=...)`` of bp_osd_tpu_torch against the
JAX package.

The stage caps follow JAX's rule (``bp_osd_tpu/decoder/pipeline.py:170-174``),
written out here by hand.  On ``hgp(rep_code(3), rep_code(3))`` (the workload
of ``tests/test_pipeline.py:16`` and ``:45-65``: B = 64, p = 0.10, max_iter
13, min-sum with factor 0, osd_cs 4) every schedule gives JAX's staged Pallas
pipeline (interpret mode) bit for bit; on 64 rows of the flagship corpus every
schedule gives JAX's straight XLA run and the corpus bit for bit.  Every
tolerance is exact: integer outputs equal, ``llr`` equal as int32 bits.
"""

import os

import numpy as np
import pytest
import torch

from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.codes import rep_code as jrep_code
from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.decoder.osd import build_osd_consts as jbuild_osd_consts
from bp_osd_tpu.decoder.pipeline import auto_stage_schedule as jauto_stage_schedule
from bp_osd_tpu.decoder.pipeline import decode_pipeline as jdecode_pipeline
from bp_osd_tpu.ops.pallas_bp import build_bp_operators

from bp_osd_tpu_torch.decoder import TannerGraph, decode_pipeline
from bp_osd_tpu_torch.decoder import pipeline as pipeline_mod
from bp_osd_tpu_torch.decoder.layered import LayeredTannerGraph
from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph
from bp_osd_tpu_torch.decoder.osd import build_osd_consts
from bp_osd_tpu_torch.decoder.pipeline import auto_stage_schedule, stage_caps
from bp_osd_tpu_torch.utils import measure

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "flagship_corpus.npz")
FIELDS = ("osdw", "osd0", "bp_hard", "converged", "iterations", "llr")
SMALL_KW = dict(bp_method="minimum_sum", max_iter=13, ms_scaling_factor=0.0,
                osd_method="osd_cs", osd_order=4)
FLAGSHIP_KW = dict(bp_method="minimum_sum", ms_scaling_factor=0.0)
AUTO = "auto"  # the default schedule: None in the port, auto_stage_schedule in JAX
SMALL_SCHEDULES = [2, 13, 1000, (4, 8), (4,), (8, 4, 4), AUTO]
FLAGSHIP_SCHEDULES = [AUTO, 32, (8, 32, 128), 400, (24, 96), 1000]


def _bits(x):
    """An output as numpy, float32 as its int32 bits (so -0.0 is not 0.0)."""
    a = np.asarray(x.numpy() if torch.is_tensor(x) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(mine, ref):
    for k in FIELDS:
        a, b = _bits(getattr(mine, k)), _bits(getattr(ref, k))
        assert a.shape == b.shape and np.array_equal(a, b), k


@pytest.mark.parametrize("max_iter, stage1_iters, caps", [
    # int s: [min(s, max_iter)], then max_iter
    (13, 2, [2, 13]),
    (13, 13, [13]),
    (13, 1000, [13]),
    (400, 32, [32, 400]),
    (400, 400, [400]),
    (400, 1, [1, 400]),
    # sequence: entries below max_iter, sorted without repeats, then max_iter
    (13, (4, 8), [4, 8, 13]),
    (13, (4,), [4, 13]),
    (13, (8, 4, 4), [4, 8, 13]),
    (13, [8, 4], [4, 8, 13]),
    (13, (20, 30), [13]),
    (13, (13,), [13]),
    (13, (), [13]),
    (400, (8, 32, 128), [8, 32, 128, 400]),
    (400, (96, 24, 500), [24, 96, 400]),
    # None: auto_stage_schedule
    (13, None, [8, 13]),
    (400, None, [24, 96, 400]),
    (100, None, [8, 24, 100]),
    (16, None, [8, 16]),
    (8, None, [8]),
])
def test_caps_rule(max_iter, stage1_iters, caps):
    assert stage_caps(max_iter, stage1_iters) == caps
    assert measure.stage_caps is stage_caps  # one rule: the bench's bounds use the pipeline's


@pytest.mark.parametrize("mi", [5, 8, 13, 16, 30, 64, 100, 400, 625, 900])
def test_default_is_the_auto_schedule(mi):
    """``None`` gives the caps JAX's callers get by passing
    ``auto_stage_schedule`` (``bp_osd_tpu/decoder/bposd.py:356``)."""
    want = [c for c in jauto_stage_schedule(mi) if c < mi] + [mi]
    assert stage_caps(mi, None) == stage_caps(mi, auto_stage_schedule(mi)) == want


@pytest.fixture(scope="module")
def small():
    """``tests/test_pipeline.py:16``'s workload at B = 64, p = 0.10."""
    H = np.asarray(jhgp(jrep_code(3), jrep_code(3)).hx.toarray(), np.uint8)
    n = H.shape[1]
    rng = np.random.default_rng(3)
    errors = (rng.random((64, n)) < 0.10).astype(np.uint8)
    synd = (errors @ H.T % 2).astype(np.uint8)
    llr0 = np.broadcast_to(np.asarray(jllr_from_channel(np.full(n, 0.10))), (64, n)).copy()
    jg = JTannerGraph(H)
    return H, synd, llr0, jg, build_bp_operators(jg), jbuild_osd_consts(jg, "osd_cs", 4)


@pytest.mark.parametrize("schedule", SMALL_SCHEDULES, ids=str)
def test_small_code_equals_jax_staged_pallas(small, schedule):
    """Each schedule: the port's six outputs equal JAX's staged Pallas
    pipeline (interpret mode) on the same numpy inputs, bit for bit."""
    H, synd, llr0, jg, ops, jconsts = small
    jstage = jauto_stage_schedule(13) if schedule == AUTO else schedule
    ref = jdecode_pipeline(jg, synd, llr0, consts=jconsts, backend="pallas", bp_operators=ops,
                           stage1_iters=jstage, interpret=True, **SMALL_KW)
    g = TannerGraph(H, device="cpu")
    mine = decode_pipeline(g, synd, llr0, consts=build_osd_consts(g, "osd_cs", 4),
                           backend="torch", stage1_iters=None if schedule == AUTO else schedule,
                           **SMALL_KW)
    assert 0 < int(mine.converged.sum()) < 64  # OSD and the later stages have rows
    _assert_same(mine, ref)


@pytest.fixture(scope="module")
def flagship():
    """64 corpus rows and JAX's straight XLA decode of them."""
    data = np.load(CORPUS)
    _, m, n, max_iter, order, _ = (int(x) for x in data["meta"])
    synd = np.unpackbits(data["synd_packed"], axis=1)[:64, :m]
    H = np.asarray(jhgp(jmkmn_16_4_6()).hx.toarray(), np.uint8)
    llr0 = np.asarray(jllr_from_channel(np.full(n, 0.05)))
    jg = JTannerGraph(H)
    ref = jdecode_pipeline(jg, synd, llr0, max_iter=max_iter, osd_method="osd_cs",
                           osd_order=order, consts=jbuild_osd_consts(jg, "osd_cs", order),
                           backend="xla", **FLAGSHIP_KW)
    g = TannerGraph(H, device="cpu")
    return data, synd, llr0, g, build_osd_consts(g, "osd_cs", order), max_iter, order, ref


@pytest.mark.parametrize("schedule", FLAGSHIP_SCHEDULES, ids=str)
def test_flagship_equals_jax_straight_run_and_corpus(flagship, schedule, monkeypatch):
    """Each schedule on 64 corpus rows: the six outputs equal JAX's straight
    ``backend="xla"`` run bit for bit, osdw, its weights, converged and
    iterations equal the corpus, and BP ran one launch a cap with rows
    left (``it0`` the cap before, state emitted below max_iter)."""
    data, synd, llr0, g, consts, max_iter, order, ref = flagship
    calls = []
    real = pipeline_mod._bp_decode

    def recording(graph, s, l0, **kw):
        calls.append((s.shape[0], kw.get("it0", 0), kw["max_iter"], kw["emit_state"]))
        return real(graph, s, l0, **kw)

    monkeypatch.setattr(pipeline_mod, "_bp_decode", recording)
    mine = decode_pipeline(g, synd, llr0, max_iter=max_iter, osd_method="osd_cs",
                           osd_order=order, consts=consts, backend="torch",
                           stage1_iters=None if schedule == AUTO else schedule, **FLAGSHIP_KW)
    _assert_same(mine, ref)
    osdw = np.unpackbits(data["osdw_packed"], axis=1)[:64, :g.n]
    assert np.array_equal(mine.osdw.numpy(), osdw)
    assert np.array_equal(mine.osdw.numpy().sum(1), data["weights"][:64])
    assert np.array_equal(mine.converged.numpy(), data["converged"][:64])
    assert np.array_equal(mine.iterations.numpy(), data["iterations"][:64])

    caps = stage_caps(max_iter, None if schedule == AUTO else schedule)
    assert [c[2] for c in calls] == caps  # the corpus rows leave failures at every cap
    assert [c[1] for c in calls] == [0] + caps[:-1]
    assert [c[3] for c in calls] == [c < max_iter for c in caps]
    its = mine.iterations.long()
    assert [c[0] for c in calls] == [64] + [int((its > c).sum()) for c in caps[:-1]]


def _tiny():
    H = np.asarray(jhgp(jrep_code(3), jrep_code(3)).hx.toarray(), np.uint8)
    synd = np.zeros((2, H.shape[0]), np.uint8)
    return H, synd, np.full(H.shape[1], 2.0, np.float32)


@pytest.mark.parametrize("bad", [0, -3, (0, 8), (4, -1), [0]], ids=str)
def test_a_cap_below_one_raises(bad):
    H, synd, llr0 = _tiny()
    with pytest.raises(ValueError, match="at least 1"):
        stage_caps(13, bad)
    with pytest.raises(ValueError, match="at least 1"):
        decode_pipeline(TannerGraph(H, device="cpu"), synd, llr0, stage1_iters=bad,
                        **SMALL_KW)


@pytest.mark.parametrize("path", ["lifted", "layered"])
def test_stage1_iters_with_a_straight_bp_raises(path):
    """Lifted and layered BP run straight: ``stage1_iters`` there raises;
    without it both decode."""
    if path == "lifted":
        proto = [[(0,), (0,), (0,)], [(0,), (1,), (2,)]]
        from bp_osd_tpu_torch.codes import protograph_to_binary

        H = protograph_to_binary(proto, 5).toarray().astype(np.uint8)
        extra = {"lifted": LiftedGraph(proto, 5, "cpu")}
    else:
        H = _tiny()[0]
        extra = {"layered": LayeredTannerGraph(H, "cpu")}
    g = TannerGraph(H, device="cpu")
    synd = np.zeros((2, H.shape[0]), np.uint8)
    llr0 = np.full(H.shape[1], 2.0, np.float32)
    kw = dict(max_iter=10, osd_method="osd_cs", osd_order=2, **extra)
    with pytest.raises(ValueError, match="straight"):
        decode_pipeline(g, synd, llr0, stage1_iters=4, **kw)
    out = decode_pipeline(g, synd, llr0, **kw)
    assert bool(out.converged.all()) and not out.osdw.any()
