"""bp_osd_tpu_torch host code (gf2, codes, TannerGraph) against the JAX package."""

import numpy as np
import pytest
import torch

import bp_osd_tpu.gf2 as jgf2
from bp_osd_tpu.codes import css_code as jcss_code
from bp_osd_tpu.codes import hamming_code as jhamming_code
from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.codes import mkmn_20_5_8 as jmkmn_20_5_8
from bp_osd_tpu.codes import rep_code as jrep_code
from bp_osd_tpu.decoder.tanner import TannerGraph as JTannerGraph

from bp_osd_tpu_torch import gf2
from bp_osd_tpu_torch.codes import (css_code, hamming_code, hgp, mkmn_16_4_6,
                                    mkmn_20_5_8, rep_code, stab_code)
from bp_osd_tpu_torch.decoder.tanner import TannerGraph

torch.set_num_threads(1)

PAIRS = {  # port constructor, JAX constructor
    "surface": (lambda: hgp(rep_code(3), rep_code(3)),
                lambda: jhgp(jrep_code(3), jrep_code(3))),
    "flagship": (lambda: hgp(mkmn_16_4_6()), lambda: jhgp(jmkmn_16_4_6())),
    "625": (lambda: hgp(mkmn_20_5_8()), lambda: jhgp(jmkmn_20_5_8())),
}


def _dense(M):
    return np.asarray(M.toarray() if hasattr(M, "toarray") else M, np.uint8)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_hgp_matrices_bit_identical(name):
    mine, ref = PAIRS[name][0](), PAIRS[name][1]()
    for attr in ("hx", "hz", "lx", "lz"):
        assert np.array_equal(_dense(getattr(mine, attr)), _dense(getattr(ref, attr))), attr
    assert (mine.N, mine.K, mine.L, mine.Q) == (ref.N, ref.K, ref.L, ref.Q)


def test_flagship_shape_and_distance():
    q = hgp(mkmn_16_4_6())
    assert (q.N, q.K) == (400, 16)
    assert q.hx.shape == (192, 400) and q.hx.nnz == 1344
    assert gf2.rank(q.hx) == 192
    surf = hgp(rep_code(3), rep_code(3), compute_distance=True)
    assert surf.code_params == "(2,4)-[[13,1,3]]"
    assert surf.D == jhgp(jrep_code(3), jrep_code(3), compute_distance=True).D


def test_css_steane_and_stab_code():
    steane = css_code(hx=hamming_code(3), hz=hamming_code(3))
    assert steane.test(show_tests=False)
    ref = jcss_code(hx=jhamming_code(3), hz=jhamming_code(3))
    assert np.array_equal(_dense(steane.lx), _dense(ref.lx))
    st = stab_code(_dense(steane.to_stab_code().hx), _dense(steane.to_stab_code().hz))
    assert st.test(show_tests=False) and st.K == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gf2_matches_jax_package(seed):
    A = (np.random.default_rng(seed).random((13, 21)) < 0.3).astype(np.uint8)
    assert gf2.rank(A) == jgf2.rank(A)
    for mine, ref in zip(gf2.row_echelon(A, full=True), jgf2.row_echelon(A, full=True)):
        assert np.array_equal(np.asarray(mine), np.asarray(ref))
    assert np.array_equal(gf2.nullspace(A).toarray(), jgf2.nullspace(A).toarray())
    assert np.array_equal(gf2.pivot_rows(A), jgf2.pivot_rows(A))


def _jax_fields(jg):
    out = {f: np.asarray(getattr(jg, f)) for f in JTannerGraph._LEAF_FIELDS
           if f != "edge_var_onehot"}
    out.update({k: getattr(jg, k) for k in ("m", "n", "wr", "wc", "num_words", "rank")})
    return out


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_tanner_fields_equal_jax(name):
    H = _dense(PAIRS[name][0]().hx)
    mine, ref = TannerGraph(H, device="cpu").fields(), _jax_fields(JTannerGraph(H))
    assert mine.keys() == ref.keys()
    for k in mine:
        r = ref[k].view(np.int32) if k == "H_packed" else ref[k]
        assert np.array_equal(mine[k], r), k


def test_from_reference_round_trips():
    H = _dense(hgp(mkmn_16_4_6()).hx)
    ref = _jax_fields(JTannerGraph(H))
    g = TannerGraph.from_reference(ref, device="cpu")
    assert np.array_equal(g.H, H)
    back = g.fields()
    for k in ref:
        r = ref[k].view(np.int32) if k == "H_packed" else ref[k]
        assert np.array_equal(back[k], r), k
    bad = dict(ref, rank=ref["rank"] - 1)
    with pytest.raises(ValueError, match="rank"):
        TannerGraph.from_reference(bad, device="cpu")
    bad = dict(ref, var_edge=np.roll(ref["var_edge"], 1, axis=1))
    with pytest.raises(ValueError, match="var_edge"):
        TannerGraph.from_reference(bad, device="cpu")
