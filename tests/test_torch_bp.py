"""bp_osd_tpu_torch plain BP against the JAX ``bp_decode`` (XLA on the CPU).

Both sides get the same syndromes, made with numpy from a seed, and the same
prior llr0, taken from the JAX ``llr_from_channel``.
"""

import os

import numpy as np
import pytest
import torch

from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.codes import mkmn_20_5_8 as jmkmn_20_5_8
from bp_osd_tpu.codes import rep_code as jrep_code
from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder import bp_decode as jbp_decode
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel

from bp_osd_tpu_torch.decoder.bp import bp_decode, llr_from_channel
from bp_osd_tpu_torch.decoder.tanner import TannerGraph

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "flagship_corpus.npz")
CODES = {
    "surface": lambda: jhgp(jrep_code(3), jrep_code(3)).hx.toarray(),
    "flagship": lambda: jhgp(jmkmn_16_4_6()).hx.toarray(),
    "625": lambda: jhgp(jmkmn_20_5_8()).hx.toarray(),
}


def _inputs(H, B, p, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    synd = (err @ H.T % 2).astype(np.uint8)
    llr0 = np.array(jllr_from_channel(np.full(H.shape[1], p)))
    return synd, llr0


def _both(H, synd, llr0, **kw):
    ref = jbp_decode(JTannerGraph(H), synd, np.broadcast_to(llr0, (len(synd), H.shape[1])),
                     **kw)
    mine = bp_decode(TannerGraph(H, device="cpu"), synd, llr0, **kw)
    return ({k: np.asarray(v) for k, v in ref._asdict().items()},
            {k: v.numpy() for k, v in mine._asdict().items()})


@pytest.mark.parametrize("code", ["surface", "flagship"])
@pytest.mark.parametrize("msf", [0.625, 0.0])
def test_min_sum_bit_identical(code, msf):
    H = np.asarray(CODES[code](), np.uint8)
    synd, llr0 = _inputs(H, 64, 0.06, 11)
    ref, mine = _both(H, synd, llr0, bp_method="ms", max_iter=80, ms_scaling_factor=msf)
    for k in ("hard", "llr", "converged", "iterations"):
        assert np.array_equal(ref[k], mine[k]), k


@pytest.mark.parametrize("msf", [0.625, 0.0])
def test_min_sum_at_a_shape_with_another_summation_order(msf):
    """At [[625,25,8]] XLA:CPU sums a variable's messages in another order
    than the four lanes the port fixes, so float results differ by ulps that
    the BP dynamics amplify with depth: decisions agree on >= 95% of rows at
    max_iter 30, and llr within atol 1e-4 on agreeing rows at max_iter 5,
    before the ulps have grown."""
    H = np.asarray(CODES["625"](), np.uint8)
    synd, llr0 = _inputs(H, 64, 0.05, 5)
    for max_iter in (30, 5):
        ref, mine = _both(H, synd, llr0, bp_method="ms", max_iter=max_iter,
                          ms_scaling_factor=msf)
        agree = ((ref["hard"] == mine["hard"]).all(1)
                 & (ref["converged"] == mine["converged"])
                 & (ref["iterations"] == mine["iterations"]))
        assert agree.mean() >= 0.95
        if max_iter == 5:
            np.testing.assert_allclose(mine["llr"][agree], ref["llr"][agree], rtol=0,
                                       atol=1e-4)


def test_flagship_corpus_bit_identical():
    data = np.load(CORPUS)
    B, m, n, max_iter, _, _ = (int(x) for x in data["meta"])
    synd = np.unpackbits(data["synd_packed"], axis=1)[:, :m]
    H = np.asarray(CODES["flagship"](), np.uint8)
    llr0 = np.array(jllr_from_channel(np.full(n, 0.05)))
    ref, mine = _both(H, synd, llr0, bp_method="minimum_sum", max_iter=max_iter,
                      ms_scaling_factor=0.0)
    assert np.array_equal(mine["converged"], data["converged"])
    assert np.array_equal(mine["iterations"], data["iterations"])
    assert np.array_equal(mine["llr"], ref["llr"])
    assert np.array_equal(mine["hard"], ref["hard"])


def test_product_sum():
    """tanh/atanh ulps differ between torch and XLA: llr within 1e-4."""
    H = np.asarray(CODES["surface"](), np.uint8)
    synd, llr0 = _inputs(H, 16, 0.08, 9)
    ref, mine = _both(H, synd, llr0, bp_method="product_sum", max_iter=20)
    for k in ("hard", "converged", "iterations"):
        assert np.array_equal(ref[k], mine[k]), k
    np.testing.assert_allclose(mine["llr"], ref["llr"], rtol=0, atol=1e-4)


def test_resume_chain_equals_straight_run():
    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, device="cpu")
    synd, llr0 = _inputs(H, 96, 0.05, 3)
    kw = dict(bp_method="ms", ms_scaling_factor=0.0)
    straight = bp_decode(g, synd, llr0, max_iter=400, **kw)
    res, v2c = bp_decode(g, synd, llr0, max_iter=24, emit_state=True, **kw)
    out = {k: v.clone() for k, v in res._asdict().items()}
    for s_prev, s_next in ((24, 96), (96, 400)):
        sel = torch.nonzero(~out["converged"]).flatten()
        r2 = bp_decode(g, synd[sel.numpy()], llr0, max_iter=s_next, v2c_init=v2c[sel],
                       it0=s_prev, emit_state=s_next < 400, **kw)
        r2, v2 = r2 if s_next < 400 else (r2, None)
        for k, v in r2._asdict().items():
            out[k][sel] = v
        if v2 is not None:
            v2c[sel] = v2
    for k, v in straight._asdict().items():
        assert torch.equal(out[k], v), k


def test_skip_rows_born_converged():
    H = np.asarray(CODES["surface"](), np.uint8)
    g = TannerGraph(H, device="cpu")
    synd, llr0 = _inputs(H, 32, 0.08, 4)
    skip = np.zeros(32, bool)
    skip[::3] = True
    full = bp_decode(g, synd, llr0, max_iter=30)
    res, v2c = bp_decode(g, synd, llr0, max_iter=40, skip=skip, it0=10, emit_state=True,
                         v2c_init=torch.zeros(32, g.m * g.wr))
    s = torch.as_tensor(skip)
    assert not res.hard[s].any()
    assert torch.equal(res.llr[s], torch.as_tensor(llr0).expand(int(s.sum()), g.n))
    assert res.converged[s].all() and (res.iterations[s] == 10).all()
    assert not v2c[s].any()
    plain = bp_decode(g, synd[~skip], llr0, max_iter=30)
    skipped = bp_decode(g, synd, llr0, max_iter=30, skip=skip)
    for k, v in plain._asdict().items():
        assert torch.equal(getattr(skipped, k)[~s], v), k
        assert torch.equal(getattr(full, k)[~s], v), k


def test_row_weight_one_code():
    """A check of weight 1 (the TPU kernel cannot trace it) gets the 1e30
    cap as its exclusive minimum, as in the JAX XLA path."""
    H = np.zeros((4, 5), np.uint8)
    H[0, 0] = 1
    H[1, [1, 2]] = 1
    H[2, 3] = 1
    H[3, [2, 3, 4]] = 1
    synd, llr0 = _inputs(H, 32, 0.2, 8)
    for msf in (0.0, 0.625):
        ref, mine = _both(H, synd, llr0, bp_method="ms", max_iter=10,
                          ms_scaling_factor=msf)
        for k in ("hard", "llr", "converged", "iterations"):
            assert np.array_equal(ref[k], mine[k]), k
    eye = np.eye(6, dtype=np.uint8)
    synd, llr0 = _inputs(eye, 16, 0.2, 8)
    ref, mine = _both(eye, synd, llr0, bp_method="ms", max_iter=6, ms_scaling_factor=0.0)
    for k in ("hard", "llr", "converged", "iterations"):
        assert np.array_equal(ref[k], mine[k]), k


def test_llr_from_channel():
    """Equal at p = 0.05; elsewhere within an ulp of the two log terms
    (rtol 1e-6, and atol 1e-7 where llr nears 0 at p near 0.5)."""
    p = np.random.default_rng(1).uniform(1e-6, 0.5, 257)
    p[:3] = (0.0, 0.05, 1.0)
    np.testing.assert_allclose(llr_from_channel(p).numpy(),
                               np.asarray(jllr_from_channel(p)), rtol=1e-6, atol=1e-7)
    assert np.array_equal(llr_from_channel(np.full(400, 0.05)).numpy(),
                          np.asarray(jllr_from_channel(np.full(400, 0.05))))
