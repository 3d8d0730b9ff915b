"""bp_osd_tpu_torch staged pipeline and decoder classes against the JAX package
and the committed flagship corpus (``tests/data/flagship_corpus.npz``)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_osd_tpu import BpOsdDecoder as JBpOsdDecoder
from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.decoder.osd import build_osd_consts as jbuild_osd_consts
from bp_osd_tpu.decoder.pipeline import _partition_order as j_partition_order
from bp_osd_tpu.decoder.pipeline import auto_stage_schedule as jauto_stage_schedule
from bp_osd_tpu.decoder.pipeline import decode_pipeline as jdecode_pipeline

from bp_osd_tpu_torch import BpOsdDecoder, bposd_decoder
from bp_osd_tpu_torch.codes import hamming_code, hgp, mkmn_16_4_6, protograph_to_binary, rep_code
from bp_osd_tpu_torch.decoder import BpDecoder, TannerGraph, decode_pipeline
from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph
from bp_osd_tpu_torch.decoder.osd import build_osd_consts
from bp_osd_tpu_torch.decoder.pipeline import _partition_order, auto_stage_schedule
from bp_osd_tpu_torch.gf2 import nullspace

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "flagship_corpus.npz")
FLAGSHIP_KW = dict(bp_method="minimum_sum", ms_scaling_factor=0.0)


def _corpus():
    data = np.load(CORPUS)
    B, m, n, max_iter, order, _ = (int(x) for x in data["meta"])
    synd = np.unpackbits(data["synd_packed"], axis=1)[:, :m]
    osdw = np.unpackbits(data["osdw_packed"], axis=1)[:, :n]
    return data, synd, osdw, max_iter, order


def _dense(M):
    return np.asarray(M.toarray() if hasattr(M, "toarray") else M, np.uint8)


def test_staged_pipeline_reproduces_corpus():
    data, synd, ref_osdw, max_iter, order = _corpus()
    H = _dense(hgp(mkmn_16_4_6()).hx)
    g = TannerGraph(H, device="cpu")
    out = decode_pipeline(g, synd, np.asarray(jllr_from_channel(np.full(g.n, 0.05))),
                          max_iter=max_iter, osd_method="osd_cs", osd_order=order,
                          consts=build_osd_consts(g, "osd_cs", order), **FLAGSHIP_KW)
    assert auto_stage_schedule(max_iter) == (24, 96)
    assert np.array_equal(out.osdw.numpy(), ref_osdw)
    assert np.array_equal(out.osdw.numpy().sum(1), data["weights"])
    assert np.array_equal(out.converged.numpy(), data["converged"])
    assert np.array_equal(out.iterations.numpy(), data["iterations"])


def test_decoder_class_reproduces_corpus_in_chunks():
    data, synd, ref_osdw, _, order = _corpus()
    dec = BpOsdDecoder(hgp(mkmn_16_4_6()).hx, error_rate=0.05, max_iter=0, bp_method="ms",
                       ms_scaling_factor=0, osd_method="osd_cs", osd_order=order)
    assert dec.device.type == "cpu" and dec.backend == "torch"
    osdw = dec.decode_batch(synd, chunk_size=200)
    assert np.array_equal(osdw, ref_osdw)
    assert np.array_equal(osdw.sum(1), data["weights"])
    assert np.array_equal(dec.converge_batch, data["converged"])
    assert np.array_equal(dec.iter_batch, data["iterations"])


def test_pipeline_equals_jax_on_fresh_rows():
    H = _dense(jhgp(jmkmn_16_4_6()).hx)
    rng = np.random.default_rng(2026)
    synd = ((rng.random((64, H.shape[1])) < 0.05).astype(np.uint8) @ H.T % 2).astype(np.uint8)
    llr0 = np.asarray(jllr_from_channel(np.full(H.shape[1], 0.05)))
    jg = JTannerGraph(H)
    ref = jdecode_pipeline(jg, synd, llr0, max_iter=400, osd_method="osd_cs", osd_order=42,
                           consts=jbuild_osd_consts(jg, "osd_cs", 42), backend="xla",
                           **FLAGSHIP_KW)
    mine = decode_pipeline(TannerGraph(H, device="cpu"), synd, llr0, max_iter=400,
                           osd_method="osd_cs", osd_order=42, backend="torch", **FLAGSHIP_KW)
    for k in ("osdw", "osd0", "bp_hard", "converged", "iterations", "llr"):
        assert np.array_equal(getattr(mine, k).numpy(), np.asarray(getattr(ref, k))), k


def test_partition_order_and_stage_schedule_match_jax():
    conv = np.random.default_rng(3).random(37) < 0.6
    order, nfail = _partition_order(torch.as_tensor(conv))
    jorder, _ = j_partition_order(jnp.asarray(conv))
    assert np.array_equal(order.numpy(), np.asarray(jorder))
    assert nfail == int((~conv).sum())
    for mi in (5, 13, 30, 64, 100, 400, 625, 900):
        assert auto_stage_schedule(mi) == jauto_stage_schedule(mi)


def test_readme_golden_decode():
    """Surface code, errors on qubits {5, 12}: osdw flips qubit 8, no logical
    error (the reference README's decode)."""
    surface_code = hgp(rep_code(3), rep_code(3), compute_distance=True)
    bpd = bposd_decoder(surface_code.hz, error_rate=0.05, channel_probs=[None],
                        max_iter=surface_code.N, bp_method="ms", ms_scaling_factor=0,
                        osd_method="osd_cs", osd_order=7)
    error = np.zeros(surface_code.N, int)
    error[[5, 12]] = 1
    syndrome = surface_code.hz @ error % 2
    bpd.decode(syndrome)
    expected = np.zeros(surface_code.N, np.uint8)
    expected[8] = 1
    assert np.array_equal(bpd.osdw_decoding, expected)
    residual = (bpd.osdw_decoding + error) % 2
    assert not (surface_code.lx @ residual % 2).any()


@pytest.mark.parametrize("osd_method,order", [("osd_cs", 7), ("osd_e", 3), ("osd0", 0)])
def test_decode_attribute_protocol_matches_jax(osd_method, order):
    H = _dense(hgp(rep_code(3), rep_code(3)).hz)
    kw = dict(error_rate=0.08, max_iter=13, bp_method="ms", ms_scaling_factor=0,
              osd_method=osd_method, osd_order=order)
    mine = BpOsdDecoder(H, **kw)
    ref = JBpOsdDecoder(H, backend="xla", **kw)
    rng = np.random.default_rng(4)
    for _ in range(4):
        e = (rng.random(H.shape[1]) < 0.15).astype(np.uint8)
        s = H @ e % 2
        assert np.array_equal(mine.decode(s), ref.decode(s))
        for attr in ("bp_decoding", "osd0_decoding", "osdw_decoding", "log_prob_ratios"):
            assert np.array_equal(getattr(mine, attr), np.asarray(getattr(ref, attr))), attr
        assert (mine.converge, mine.iter) == (ref.converge, ref.iter)
    probs = np.linspace(0.01, 0.2, H.shape[1])
    mine.update_channel_probs(probs)
    ref.update_channel_probs(probs)
    s = H @ np.eye(H.shape[1], dtype=np.uint8)[3] % 2
    assert np.array_equal(mine.decode(s), ref.decode(s))


def _codeword(H, idx=0):
    return nullspace(H).toarray()[idx].astype(np.uint8)


def test_received_vector_roundtrips_single_bit_errors_rep_code():
    H = _dense(rep_code(5))
    n = H.shape[1]
    cw = _codeword(H)
    bpd = BpOsdDecoder(H, error_rate=0.05, max_iter=n, bp_method="ps",
                       osd_method="osd_e", osd_order=1, input_vector_type="received_vector")
    for flip in range(n):
        received = cw.copy()
        received[flip] ^= 1
        out = bpd.decode(received)
        assert not (H @ out % 2).any()
        assert np.array_equal(out, cw), f"bit {flip} not corrected"


def test_received_vector_equals_syndrome_mode_xor_received():
    H = _dense(hamming_code(3))
    received = (np.random.default_rng(11).random((8, H.shape[1])) < 0.3).astype(np.uint8)
    kw = dict(error_rate=0.05, max_iter=7, bp_method="ms", ms_scaling_factor=0.625,
              osd_method="osd_cs", osd_order=3)
    rv = BpOsdDecoder(H, input_vector_type="received_vector", **kw)
    sy = BpOsdDecoder(H, **kw)
    rv.decode_batch(received)
    sy.decode_batch(received @ H.T % 2)
    for attr in ("osdw_decoding_batch", "osd0_decoding_batch", "bp_decoding_batch"):
        assert np.array_equal(getattr(rv, attr), getattr(sy, attr) ^ received), attr
    assert np.array_equal(rv.converge_batch, sy.converge_batch)
    assert not (rv.osdw_decoding_batch @ H.T % 2).any()


def test_received_vector_bp_only_decoder():
    H = _dense(rep_code(5))
    cw = _codeword(H)
    received = cw.copy()
    received[2] ^= 1
    bp_only = BpDecoder(H, error_rate=0.05, max_iter=10, bp_method="ps",
                        input_vector_type="received_vector")
    assert np.array_equal(bp_only.decode(received), cw)


def test_device_outputs_and_options_not_ported_yet():
    H = _dense(hamming_code(3))
    with pytest.raises(NotImplementedError):
        BpOsdDecoder(H, error_rate=0.05, input_vector_type="banana")
    layered = BpOsdDecoder(H, error_rate=0.05, max_iter=7, schedule="layered")
    e1 = np.zeros(7, np.uint8)
    e1[5] = 1
    assert layered.schedule == "layered"
    assert layered.decode(H @ e1 % 2).tolist() == e1.tolist()
    proto = [[(0, 1, 3)]]  # one circulant of lift 7: a cyclic [7,4] Hamming code
    lifted = BpOsdDecoder(protograph_to_binary(proto, 7), error_rate=0.05, proto=proto,
                          lift=7)
    assert isinstance(lifted._lifted, LiftedGraph) and lifted._lifted.n == 7
    dec = BpOsdDecoder(H, error_rate=0.05, max_iter=7, bp_method="ps", osd_method="osd0")
    e = np.zeros(7, np.uint8)
    e[3] = 1
    out = dec.decode_batch(torch.as_tensor(H @ e % 2)[None], outputs="device")
    assert torch.is_tensor(out) and torch.is_tensor(dec.converge_batch)
    assert out[0].tolist() == e.tolist()


def test_compact_osd_matches_fused_path():
    """tests/test_decoder.py:333 on the port: compact_osd=True gives the
    default path's outputs as host numpy, and refuses outputs="device"."""
    H = _dense(hgp(rep_code(3), rep_code(3)).hz)
    bpd = BpOsdDecoder(H, error_rate=0.08, max_iter=13, bp_method="ms",
                       ms_scaling_factor=0.625, osd_method="osd_cs", osd_order=4)
    errors = (np.random.default_rng(333).random((64, 13)) < 0.12).astype(np.uint8)
    synds = errors @ H.T % 2
    attrs = ("osdw_decoding_batch", "osd0_decoding_batch", "bp_decoding_batch",
             "converge_batch", "iter_batch", "log_prob_ratios_batch")
    bpd.decode_batch(synds)
    fused = {a: getattr(bpd, a).copy() for a in attrs}
    assert not fused["converge_batch"].all()
    out = bpd.decode_batch(synds, compact_osd=True)
    assert isinstance(out, np.ndarray)
    for a in attrs:
        assert isinstance(getattr(bpd, a), np.ndarray)
        assert np.array_equal(getattr(bpd, a), fused[a]), a
    with pytest.raises(ValueError, match="compact_osd"):
        bpd.decode_batch(synds, compact_osd=True, outputs="device")
