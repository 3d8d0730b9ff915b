"""Bivariate bicycle codes and the phenomenological space-time matrix, and
the staged BP's row-iteration counters, on the CPU.

The space-time matrix is held to a construction written here and to the
benchmark's own (``benchmark/families/bb_phenomenological.py``); a seeded
space-time decode of the [[72,12,6]] code through ``BpOsdDecoder`` is held
to the benchmark's frozen reference (``benchmark/reference.py``), both
loaded by path.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from bp_osd_tpu_torch import BpOsdDecoder, gf2
from bp_osd_tpu_torch.codes import (bivariate_bicycle, detection_events, gross_code,
                                    net_data_error, phenomenological, two_gross_code)
from bp_osd_tpu_torch.decoder.bp import llr_from_channel
from bp_osd_tpu_torch.decoder.pipeline import decode_pipeline, stage_caps
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.utils import profiling

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
A, B = [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)]  # arXiv:2308.07915
DECODER = dict(max_iter=400, bp_method="ms", ms_scaling_factor=0.0, osd_method="osd_cs",
               osd_order=7)  # stage caps 24, 96, 400


def _load(path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bb72():
    return bivariate_bicycle(6, 6, A, B)


def _spacetime_by_hand(h: np.ndarray, rounds: int) -> np.ndarray:
    """Detector block t: h on round t's data, the identity on the
    measurement errors of rounds t - 1 and t (noisy rounds only)."""
    m, n = h.shape
    cols = []
    for t in range(rounds + 1):
        data = np.zeros(((rounds + 1) * m, n), np.uint8)
        data[t * m:(t + 1) * m] = h
        cols.append(data)
        if t < rounds:
            meas = np.zeros(((rounds + 1) * m, m), np.uint8)
            meas[t * m:(t + 2) * m] = np.vstack([np.eye(m, dtype=np.uint8)] * 2)
            cols.append(meas)
    return np.hstack(cols)


def test_gross_code_parameters():
    q = gross_code()
    assert (q.N, q.K, q.D) == (144, 12, 12)
    assert q.hx.shape == q.hz.shape == (72, 144)
    assert gf2.rank(q.hx) == gf2.rank(q.hz) == 66
    assert not ((q.hx @ q.hz.T).toarray() % 2).any()
    assert q.test(show_tests=False)
    # row weight 6, column weight 3: three monomials in each of A and B
    assert set(np.asarray(q.hx.sum(1)).ravel()) == {6}
    assert set(np.asarray(q.hx.sum(0)).ravel()) == {3}


def test_two_gross_code_parameters():
    q = two_gross_code()
    assert (q.N, q.K, q.D) == (288, 12, 18)
    assert q.hx.shape == q.hz.shape == (144, 288)
    assert gf2.rank(q.hx) == gf2.rank(q.hz) == 138
    assert not ((q.hx @ q.hz.T).toarray() % 2).any()
    assert set(np.asarray(q.hx.sum(1)).ravel()) == {6}
    assert set(np.asarray(q.hx.sum(0)).ravel()) == {3}


def test_bb72_parameters(bb72):
    assert (bb72.N, bb72.K) == (72, 12)
    assert not ((bb72.hx @ bb72.hz.T).toarray() % 2).any()


@pytest.mark.parametrize("rounds", [0, 1, 3, 12])
def test_phenomenological_matrix(rounds):
    h = gross_code().hx.toarray()
    st = phenomenological(h, rounds)
    want = _spacetime_by_hand(h, rounds)
    got = st.H.toarray()
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    m, n = h.shape
    assert st.data.shape == (rounds + 1, n) and st.meas.shape == (rounds, m)
    cols = np.concatenate([st.data.ravel(), st.meas.ravel()])
    assert np.array_equal(np.sort(cols), np.arange(got.shape[1]))
    for t in range(rounds + 1):
        assert np.array_equal(got[:, st.data[t]], want[:, st.data[t]])
        assert np.array_equal(got[t * m:(t + 1) * m, st.data[t]], h)
    fam = _load(os.path.join(BENCH, "families", "bb_phenomenological.py"))
    H, proto, lift = fam.build({"l": 12, "m": 6, "A": [list(x) for x in A],
                                "B": [list(x) for x in B], "rounds": rounds})
    assert proto is None and lift is None
    assert H.dtype == np.uint8 and H.tobytes() == got.tobytes() and H.shape == got.shape


def test_phenomenological_gross_12_rounds():
    st = phenomenological(gross_code().hx, 12)
    assert isinstance(st.H, sp.csr_matrix) and st.H.shape == (936, 2736)
    assert st.H.nnz == int(st.H.sum()) == 7344
    assert gf2.rank(st.H) == 930
    assert set(np.asarray(st.H.sum(1)).ravel()) == {7, 8}
    assert set(np.asarray(st.H.sum(0)).ravel()) == {2, 3}


def test_phenomenological_two_gross_18_rounds():
    """The ``twogross288.ph18`` configuration's matrix: the port's
    construction equals the benchmark's family file, at the parameters the
    configuration states."""
    with open(os.path.join(BENCH, "configs", "twogross288.ph18.json")) as f:
        conf = json.load(f)
    par = conf["parameters"]
    st = phenomenological(two_gross_code().hx, par["rounds"])
    assert isinstance(st.H, sp.csr_matrix) and st.H.shape == (par["m"], par["n"]) == (2736, 8064)
    assert st.H.nnz == int(st.H.sum()) == par["edges"] == 21600
    assert gf2.rank(st.H) == par["rank"] == 2730
    assert set(np.asarray(st.H.sum(1)).ravel()) == {7, par["row_weight"]}
    assert set(np.asarray(st.H.sum(0)).ravel()) == {2, par["column_weight"]}
    fam = _load(os.path.join(BENCH, "families", "bb_phenomenological.py"))
    H, _, _ = fam.build(conf["code"])
    assert H.tobytes() == st.H.toarray().tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_events_and_the_fold(bb72, seed):
    """Each round's syndrome is that of every data error so far, with its
    measurement errors flipping the noisy rounds' outcomes; the detection
    events are H_st e, and the fold is the data errors' XOR, whose syndrome
    the perfect round measures."""
    rounds = 3
    h = bb72.hx.toarray()
    m, n = h.shape
    st = phenomenological(h, rounds)
    rng = np.random.default_rng(seed)
    e = (rng.random((16, st.H.shape[1])) < 0.05).astype(np.uint8)
    data = np.stack([e[:, st.data[t]] for t in range(rounds + 1)], 1)  # [B, R+1, n]
    meas = np.stack([e[:, st.meas[t]] for t in range(rounds)], 1)  # [B, R, m]
    acc = np.bitwise_xor.accumulate(data, axis=1)
    synd = acc @ h.T % 2
    synd[:, :rounds] ^= meas
    events = detection_events(synd)
    assert events.dtype == np.uint8 and events.shape == (16, (rounds + 1) * m)
    assert np.array_equal(events, e @ st.H.toarray().T % 2)
    net = net_data_error(e, st)
    assert net.shape == (16, n) and np.array_equal(net, acc[:, -1])
    assert np.array_equal(net @ h.T % 2, synd[:, -1])


def test_spacetime_decode_equals_the_reference(bb72):
    """[[72,12,6]] over 3 rounds, seeded, on the port's staged pipeline (CPU,
    adaptive min-sum to 400 iterations in stages 24 / 96 / 400, osd_cs 7)
    against ``benchmark/reference.py``: the same BP hard decision,
    convergence, iterations and osdw on every row."""
    ref = _load(os.path.join(BENCH, "reference.py"))
    st = phenomenological(bb72.hx, 3)
    H = st.H.toarray()
    p = 0.03
    rng = np.random.default_rng(7)
    e = (rng.random((96, H.shape[1])) < p).astype(np.uint8)
    synd = torch.from_numpy(e @ H.T % 2).to(torch.uint8)
    dec = BpOsdDecoder(H, error_rate=p, device="cpu", backend="torch", **DECODER)
    dec.decode_batch(synd, outputs="device")
    iters = dec.iter_batch
    assert int((iters > 96).sum()) > 0 and int((~dec.converge_batch).sum()) > 0

    decoder = dict(DECODER, bp_method="minimum_sum")
    g = ref.FloodGraph(H, "cpu")
    r = ref.flood_bp(g, synd, ref.prior(p, g.n), decoder)
    assert torch.equal(dec.bp_decoding_batch, r.hard)
    assert torch.equal(dec.converge_batch, r.converged)
    assert torch.equal(iters.to(torch.int32), r.iterations)
    fail = ~r.converged
    o = ref.osd_cs(g, synd[fail], r.llr[fail], decoder)
    want = r.hard.clone()
    want[fail] = o.osdw
    assert torch.equal(dec.osdw_decoding_batch, want)
    assert torch.equal(ref.syndromes_of(g, dec.osdw_decoding_batch), synd)


def test_two_gross_decode_equals_the_reference():
    """[[288,12,18]] over 2 rounds (432 x 1152), seeded, through
    ``BpOsdDecoder`` on the CPU (adaptive min-sum to 64 iterations in stages
    8 / 16 / 64, osd_cs 7) against ``benchmark/reference.py``: the same BP
    hard decision, convergence and iterations, osd0 and osdw on every
    row."""
    ref = _load(os.path.join(BENCH, "reference.py"))
    H = phenomenological(two_gross_code().hx, 2).H.toarray()
    p = 0.02
    rng = np.random.default_rng(29)
    e = (rng.random((48, H.shape[1])) < p).astype(np.uint8)
    synd = torch.from_numpy(e @ H.T % 2).to(torch.uint8)
    kw = dict(DECODER, max_iter=64)
    dec = BpOsdDecoder(H, error_rate=p, device="cpu", backend="torch", **kw)
    dec.decode_batch(synd, outputs="device")
    assert int((dec.iter_batch > 16).sum()) > 0 and int((~dec.converge_batch).sum()) > 0

    decoder = dict(kw, bp_method="minimum_sum")
    g = ref.FloodGraph(H, "cpu")
    r = ref.flood_bp(g, synd, ref.prior(p, g.n), decoder)
    assert torch.equal(dec.bp_decoding_batch, r.hard)
    assert torch.equal(dec.converge_batch, r.converged)
    assert torch.equal(dec.iter_batch.to(torch.int32), r.iterations)
    fail = ~r.converged
    o = ref.osd_cs(g, synd[fail], r.llr[fail], decoder)
    for got, part in ((dec.osd0_decoding_batch, o.osd0), (dec.osdw_decoding_batch, o.osdw)):
        want = r.hard.clone()
        want[fail] = part
        assert torch.equal(got, want)
    assert torch.equal(ref.syndromes_of(g, dec.osdw_decoding_batch), synd)


def _split(iters: torch.Tensor, caps) -> list:
    """Each stage's row-iterations: a row that ran ``t`` iterations ran
    ``clamp(t - c_{i-1}, 0, c_i - c_{i-1})`` of them in stage ``i``."""
    t = iters.to(torch.int64)
    lo = [0] + list(caps[:-1])
    return [int((t - a).clamp(0, b - a).sum()) for a, b in zip(lo, caps)]


@pytest.mark.parametrize("stage1_iters", [None, 32, (8, 32, 128)])
def test_row_iteration_counters_split_the_iterations(bb72, stage1_iters):
    st = phenomenological(bb72.hx, 3)
    H = st.H.toarray()
    rng = np.random.default_rng(11)
    e = (rng.random((64, H.shape[1])) < 0.03).astype(np.uint8)
    synd = torch.from_numpy(e @ H.T % 2).to(torch.uint8)
    g = TannerGraph(H, device="cpu")
    llr0 = llr_from_channel(np.full(H.shape[1], 0.03))
    kw = dict(bp_method="ms", max_iter=400, ms_scaling_factor=0.0, osd_method="osd_cs",
              osd_order=7, backend="torch", stage1_iters=stage1_iters)
    plain = decode_pipeline(g, synd, llr0, **kw)
    profiling.collect()
    profiling.enable()
    try:
        out = decode_pipeline(g, synd, llr0, **kw)
    finally:
        profiling.disable()
    counters = profiling.collect().counters
    for a, b in zip(plain, out):
        assert torch.equal(a, b)
    caps = stage_caps(400, stage1_iters)
    want = _split(out.iterations, caps)
    assert sum(want) == int(out.iterations.sum()) and want[-1] > 0
    got = [counters.get(f"bp.row_iters.{i}", 0) for i in range(1, len(caps) + 1)]
    assert got == want
    assert not [k for k in counters if k.startswith("bp.row_iters.")
                and int(k.rsplit(".", 1)[1]) > len(caps)]


def test_row_iteration_counters_absent_when_untraced(bb72):
    H = phenomenological(bb72.hx, 1).H.toarray()
    dec = BpOsdDecoder(H, error_rate=0.05, device="cpu", backend="torch", **DECODER)
    profiling.disable()
    profiling.collect()
    dec.decode_batch(np.zeros((4, H.shape[0]), np.uint8), outputs="device")
    assert profiling.device_counter(("bp.row_iters.1",), "cpu") is None
    assert profiling.collect().counters == {}
