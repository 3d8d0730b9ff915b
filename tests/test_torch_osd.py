"""bp_osd_tpu_torch plain OSD against the JAX ``osd_decode`` on identical LLRs.

OSD is integer work once the reliability order is fixed, so every comparison
is exact.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_osd_tpu.codes import hamming_code as jhamming_code
from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.codes import rep_code as jrep_code
from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder import osd_decode as josd_decode
from bp_osd_tpu.decoder.osd import build_osd_consts as jbuild_osd_consts
from bp_osd_tpu.ops.pallas_osd import osd_cs_pallas

from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode
from bp_osd_tpu_torch.decoder.tanner import TannerGraph

torch.set_num_threads(1)

CODES = {
    "surface": lambda: jhgp(jrep_code(3), jrep_code(3)).hx.toarray(),
    "flagship": lambda: jhgp(jmkmn_16_4_6()).hx.toarray(),
}
METHODS = [("osd0", 0), ("osd_cs", 0), ("osd_cs", 7), ("osd_cs", 42), ("osd_e", 8)]


def _inputs(H, B, seed, p=0.06):
    rng = np.random.default_rng(seed)
    err = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    synd = (err @ H.T % 2).astype(np.uint8)
    llr = rng.normal(2.0, 2.0, (B, H.shape[1])).astype(np.float32)  # scrambled reliabilities
    llr[:, ::5] = np.round(llr[:, ::5])  # ties exercise the stable argsort
    return synd, llr


@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("method,order", METHODS)
def test_osd_exact_vs_jax(code, method, order):
    H = np.asarray(CODES[code](), np.uint8)
    synd, llr = _inputs(H, 48, 21)
    jg = JTannerGraph(H)
    ref = josd_decode(jg, synd, llr, osd_method=method, osd_order=order,
                      consts=jbuild_osd_consts(jg, method, order))
    g = TannerGraph(H, device="cpu")
    mine = osd_decode(g, synd, llr, osd_method=method, osd_order=order,
                      consts=build_osd_consts(g, method, order))
    assert np.array_equal(mine.osd0.numpy(), np.asarray(ref.osd0))
    assert np.array_equal(mine.osdw.numpy(), np.asarray(ref.osdw))


def test_osd_cs_matches_the_pallas_kernel_interpreted():
    H = np.asarray(CODES["surface"](), np.uint8)
    synd, llr = _inputs(H, 32, 4, p=0.08)
    perm = jnp.argsort(jnp.asarray(llr), axis=1, stable=True).astype(jnp.int32)
    e0, ew = osd_cs_pallas(JTannerGraph(H), perm, jnp.asarray(synd, jnp.int32),
                           osd_order=4, interpret=True)
    mine = osd_decode(TannerGraph(H, device="cpu"), synd, llr, osd_method="osd_cs", osd_order=4)
    assert np.array_equal(mine.osd0.numpy(), np.asarray(e0).astype(np.uint8))
    assert np.array_equal(mine.osdw.numpy(), np.asarray(ew).astype(np.uint8))


def _brute_force_min_weight(H, s):
    n = H.shape[1]
    best = n + 1
    for bits in itertools.product((0, 1), repeat=n):
        e = np.array(bits, np.uint8)
        if np.array_equal(H @ e % 2, s):
            best = min(best, int(e.sum()))
    return best


def test_osd_e_full_order_is_maximum_likelihood():
    """With order = |T|, osd_e searches every coset solution -> min weight
    (as ``tests/test_decoder.py`` checks for the JAX package)."""
    H = jhamming_code(3).toarray().astype(np.uint8)  # rank 3, n 7 -> |T| = 4
    rng = np.random.default_rng(7)
    synd = rng.integers(0, 2, (8, 3)).astype(np.uint8)
    llr = rng.normal(0, 1, (8, 7)).astype(np.float32)
    res = osd_decode(TannerGraph(H, device="cpu"), synd, llr, osd_method="osd_e", osd_order=4)
    for b in range(8):
        sol = res.osdw[b].numpy()
        assert np.array_equal(H @ sol % 2, synd[b])
        assert sol.sum() == _brute_force_min_weight(H, synd[b])


@pytest.mark.parametrize("method,order", [("osd_cs", 42), ("osd_e", 6)])
def test_skip_rows_masked(method, order):
    H = np.asarray(CODES["flagship"](), np.uint8)
    synd, llr = _inputs(H, 48, 5)
    skip = np.zeros(48, bool)
    skip[::3] = True  # deliberately not clustered
    jg = JTannerGraph(H)
    ref = josd_decode(jg, synd, llr, osd_method=method, osd_order=order,
                      consts=jbuild_osd_consts(jg, method, order))
    mine = osd_decode(TannerGraph(H, device="cpu"), synd, llr, osd_method=method, osd_order=order,
                      skip=skip)
    for got, want in ((mine.osd0, ref.osd0), (mine.osdw, ref.osdw)):
        got = got.numpy()
        assert not got[skip].any()
        assert np.array_equal(got[~skip], np.asarray(want)[~skip])
    assert np.array_equal(mine.osdw.numpy()[~skip] @ H.T % 2, synd[~skip])


@pytest.mark.parametrize("method,order", [("osd_cs", 42), ("osd_cs", 1), ("osd_e", 8),
                                          ("osd0", 5)])
def test_candidate_tables_equal_jax(method, order):
    H = np.asarray(CODES["flagship"](), np.uint8)
    mine = build_osd_consts(TannerGraph(H, device="cpu"), method, order)
    ref = jbuild_osd_consts(JTannerGraph(H), method, order)
    for field in ref._fields:
        a, b = getattr(mine, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert np.array_equal(a, b), field
