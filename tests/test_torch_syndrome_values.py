"""Syndrome entries above 1 are rejected once per public call.

A uint8 syndrome (numpy or torch) holding 2 or 255 raises ``ValueError`` at
every public entry point of the port, as a float or int64 one does; without
the check the JAX package (``1 - 2*synd``), the plain min-sum (raw parity
against the raw value) and kernel K1 (``synd & 1``) gave three answers.
Each public call checks its input exactly once
(``decoder/bp.py:_check_binary``, counted here), whatever the stage
schedule; the private functions the port calls internally check nothing,
and the flagship corpus still comes out bit for bit through them.
"""

import os

import numpy as np
import pytest
import torch

from bp_osd_tpu_torch import BpDecoder, BpOsdDecoder
from bp_osd_tpu_torch.codes import hgp, lifted_hgp, mkmn_16_4_6, rep_code
from bp_osd_tpu_torch.decoder import bp as bp_mod
from bp_osd_tpu_torch.decoder import pipeline as pipeline_mod
from bp_osd_tpu_torch.decoder.bp import bp_decode, llr_from_channel
from bp_osd_tpu_torch.decoder.layered import LayeredTannerGraph, bp_decode_layered
from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode
from bp_osd_tpu_torch.decoder.pipeline import _decode_pipeline, decode_pipeline
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.parallel import (ShardedTannerGraph, cpu_mesh, cpu_mesh_2d,
                                       edge_sharded_bp_fn, sharded_decode_fn)
from bp_osd_tpu_torch.parallel.lifted_shard import ShardedLiftedGraph, lifted_sharded_bp_fn

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "flagship_corpus.npz")
PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]
LIFT = 3
B = 4
KW = dict(bp_method="minimum_sum", max_iter=10, ms_scaling_factor=0.625)
FLAGSHIP_KW = dict(bp_method="minimum_sum", ms_scaling_factor=0.0)


def _dense(M):
    return np.asarray(M.toarray() if hasattr(M, "toarray") else M, np.uint8)


def _syndromes(H, rows, p, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((rows, H.shape[1])) < p).astype(np.uint8) @ H.T % 2).astype(np.uint8)


H = _dense(hgp(rep_code(3), rep_code(3)).hx)
M, N = H.shape
LQ = lifted_hgp(PROTO, lift=LIFT)
HL = _dense(LQ.hx)
SYND = _syndromes(H, B, 0.1, 11)
RECV = (np.random.default_rng(12).random((B, N)) < 0.1).astype(np.uint8)
SYND_L = _syndromes(HL, B, 0.05, 13)
LLR0 = llr_from_channel(np.full(N, 0.05)).numpy()
LLR0_L = llr_from_channel(np.full(HL.shape[1], 0.05)).numpy()


def _graph():
    return TannerGraph(H, device="cpu")


def _osdd(**kw):
    return BpOsdDecoder(H, error_rate=0.05, max_iter=10, osd_method="osd_cs", osd_order=2,
                        device="cpu", **kw)


def _sharded(s):
    return sharded_decode_fn(_graph(), cpu_mesh(2), osd_method="osd_cs", osd_order=2,
                             **KW)(s, np.broadcast_to(LLR0, (B, N)).copy())


def _edge_sharded(s):
    sg = ShardedTannerGraph(H, 2)
    s = s if torch.is_tensor(s) else torch.as_tensor(s)
    pad = torch.zeros(s.shape[0], 2 * sg.m_chunk - M, dtype=s.dtype)
    return edge_sharded_bp_fn(sg, cpu_mesh_2d(1, 2), **KW).decode(torch.cat([s, pad], 1),
                                                                 LLR0)


def _lifted_sharded(s):
    sg = ShardedLiftedGraph(LiftedGraph(LQ.hx_proto, LIFT, device="cpu"), 1)
    return lifted_sharded_bp_fn(sg, cpu_mesh_2d(2, 1), **KW)(
        s, np.broadcast_to(LLR0_L, (B, HL.shape[1])).copy())


# each public entry point: (the input it checks, the call)
ENTRIES = {
    "bp_decode": (SYND, lambda s: bp_decode(_graph(), s, LLR0, **KW)),
    "decode_pipeline": (SYND, lambda s: decode_pipeline(_graph(), s, LLR0, osd_method="osd_cs",
                                                        osd_order=2, **KW)),
    "osd_decode": (SYND, lambda s: osd_decode(_graph(), s, np.tile(LLR0, (B, 1)),
                                              osd_method="osd_cs", osd_order=2)),
    "bp_decode_layered": (SYND, lambda s: bp_decode_layered(
        LayeredTannerGraph(H, device="cpu"), s, LLR0, **KW)),
    "bp_decode_lifted": (SYND_L, lambda s: bp_decode_lifted(
        LiftedGraph(LQ.hx_proto, LIFT, device="cpu"), s, LLR0_L, **KW)),
    "BpOsdDecoder.decode_batch": (SYND, lambda s: _osdd().decode_batch(s)),
    "BpOsdDecoder.decode": (SYND[:1], lambda s: _osdd().decode(s[0])),
    "BpOsdDecoder.decode_batch layered": (SYND, lambda s: _osdd(
        schedule="layered").decode_batch(s)),
    "BpOsdDecoder.decode_batch lifted": (SYND_L, lambda s: BpOsdDecoder(
        LQ.hx, proto=LQ.hx_proto, lift=LIFT, error_rate=0.05, max_iter=10,
        osd_method="osd_cs", osd_order=2, device="cpu").decode_batch(s)),
    "BpOsdDecoder received_vector": (RECV, lambda s: _osdd(
        input_vector_type="received_vector").decode_batch(s)),
    "BpDecoder.decode": (SYND[:1], lambda s: BpDecoder(
        H, error_rate=0.05, max_iter=10, device="cpu").decode(s[0])),
    "BpDecoder.decode_batch": (SYND, lambda s: BpDecoder(
        H, error_rate=0.05, max_iter=10, device="cpu").decode_batch(s)),
    "sharded_decode_fn": (SYND, _sharded),
    "edge_sharded_bp_fn": (SYND, _edge_sharded),
    "lifted_sharded_bp_fn": (SYND_L, _lifted_sharded),
}


@pytest.fixture
def checks(monkeypatch):
    """The number of 0/1 checks made so far."""
    seen = []
    real = bp_mod._check_binary

    def counting(s, what):
        seen.append(what)
        return real(s, what)

    monkeypatch.setattr(bp_mod, "_check_binary", counting)
    return seen


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("value", [2, 255])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_uint8_above_one_raises(entry, value, kind):
    """Entry 2 or 255 in one row of a valid uint8 batch raises
    ``ValueError`` before any decoding."""
    good, call = ENTRIES[entry]
    bad = good.copy()
    bad[0, 1] = value
    with pytest.raises(ValueError, match="0 or 1"):
        call(torch.from_numpy(bad) if kind == "torch" else bad)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_one_check_per_public_call(entry, checks):
    """A valid call checks its input exactly once, whatever the entry
    point calls inside (the pipeline's stages and OSD, the decoder's
    chunks, the shards)."""
    good, call = ENTRIES[entry]
    call(good)
    assert len(checks) == 1, checks
    call(torch.from_numpy(good))
    assert len(checks) == 2, checks


def _corpus(rows=None):
    data = np.load(CORPUS)
    _, m, n, max_iter, order, _ = (int(x) for x in data["meta"])
    synd = np.unpackbits(data["synd_packed"], axis=1)[:rows, :m]
    return data, synd, n, max_iter, order


def _bp_calls(monkeypatch):
    calls = []
    real = pipeline_mod._bp_decode

    def recording(*args, **kw):
        calls.append(kw["max_iter"])
        return real(*args, **kw)

    monkeypatch.setattr(pipeline_mod, "_bp_decode", recording)
    return calls


def test_flagship_decoder_checks_once_over_three_stages(checks, monkeypatch):
    """``BpOsdDecoder.decode_batch`` at the flagship's defaults (max_iter
    400, stages 24 -> 96 -> 400, osd_cs 42) on 64 corpus rows: three BP
    stages and the OSD, one check; the corpus rows bit for bit."""
    data, synd, _, _, order = _corpus(64)
    bp_calls = _bp_calls(monkeypatch)
    dec = BpOsdDecoder(hgp(mkmn_16_4_6()).hx, error_rate=0.05, max_iter=0, bp_method="ms",
                       ms_scaling_factor=0, osd_method="osd_cs", osd_order=order,
                       device="cpu")
    osdw = dec.decode_batch(synd)
    assert bp_calls == [24, 96, 400]
    assert len(checks) == 1
    assert np.array_equal(osdw, np.unpackbits(data["osdw_packed"], axis=1)[:64, :dec.n])
    assert np.array_equal(dec.iter_batch, data["iterations"][:64])


def test_pipeline_checks_once_over_four_stages(checks, monkeypatch):
    """``decode_pipeline(..., stage1_iters=(8, 32, 128))`` on 64 corpus
    rows: four BP stages, one check."""
    data, synd, n, max_iter, order = _corpus(64)
    bp_calls = _bp_calls(monkeypatch)
    g = TannerGraph(_dense(hgp(mkmn_16_4_6()).hx), device="cpu")
    out = decode_pipeline(g, synd, llr_from_channel(np.full(n, 0.05)), max_iter=max_iter,
                          osd_method="osd_cs", osd_order=order, stage1_iters=(8, 32, 128),
                          **FLAGSHIP_KW)
    assert bp_calls == [8, 32, 128, 400]
    assert len(checks) == 1
    assert np.array_equal(out.converged.numpy(), data["converged"][:64])


def test_private_pipeline_reproduces_the_corpus(checks):
    """The 512 corpus syndromes as a uint8 tensor through
    ``_decode_pipeline``, the path the decoder classes and the harness
    take: osdw, weights, converged and iterations bit for bit, and no
    check made."""
    data, synd, n, max_iter, order = _corpus()
    g = TannerGraph(_dense(hgp(mkmn_16_4_6()).hx), device="cpu")
    out = _decode_pipeline(g, torch.from_numpy(synd), llr_from_channel(np.full(n, 0.05)),
                           max_iter=max_iter, osd_method="osd_cs", osd_order=order,
                           consts=build_osd_consts(g, "osd_cs", order), **FLAGSHIP_KW)
    assert not checks
    assert np.array_equal(out.osdw.numpy(), np.unpackbits(data["osdw_packed"], axis=1)[:, :n])
    assert np.array_equal(out.osdw.numpy().sum(1), data["weights"])
    assert np.array_equal(out.converged.numpy(), data["converged"])
    assert np.array_equal(out.iterations.numpy(), data["iterations"])


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int64, torch.float32])
def test_valid_dtypes_decode_alike(dtype):
    """0/1 syndromes of every dtype give the same decode."""
    want = bp_decode(_graph(), SYND, LLR0, **KW)
    got = bp_decode(_graph(), torch.from_numpy(SYND).to(dtype), LLR0, **KW)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
