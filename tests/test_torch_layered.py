"""bp_osd_tpu_torch layered (serial-schedule) BP against the JAX package's
``bp_decode_layered`` (XLA on the CPU).

Min-sum is held bit for bit: within a layer each variable takes one message
change, and XLA:CPU contracts that change into a fused multiply-add, which
``_fma_f32`` reproduces.  The adaptive factor ``1 - exp2(-t)`` is exact in
XLA at every integer ``t`` (checked below), so adaptive min-sum is held bit
for bit too.  Product-sum goes through XLA's and torch's own tanh/atanh,
which differ in the last ulps; it is held to >= 95% of rows agreeing on the
hard decision, convergence and iteration count.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_osd_tpu import BpOsdDecoder as JBpOsdDecoder
from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.codes import rep_code as jrep_code
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.decoder.layered import LayeredTannerGraph as JLayeredTannerGraph
from bp_osd_tpu.decoder.layered import bp_decode_layered as jbp_decode_layered
from bp_osd_tpu.decoder.layered import color_checks as jcolor_checks

from bp_osd_tpu_torch import BpOsdDecoder
from bp_osd_tpu_torch.decoder import BpDecoder, TannerGraph, osd_decode
from bp_osd_tpu_torch.decoder.layered import (LayeredTannerGraph, _fma_f32, bp_decode_layered,
                                              color_checks)

torch.set_num_threads(1)

CODES = {
    "surface_hz": lambda: jhgp(jrep_code(3), jrep_code(3)).hz,
    "surface5_hx": lambda: jhgp(jrep_code(5), jrep_code(5)).hx,
    "flagship_hx": lambda: jhgp(jmkmn_16_4_6()).hx,
    "flagship_hz": lambda: jhgp(jmkmn_16_4_6()).hz,
}
P = {"surface_hz": 0.08, "surface5_hx": 0.08, "flagship_hx": 0.05, "flagship_hz": 0.05}


def _case(name, B, seed=7):
    H = np.asarray(CODES[name]().toarray(), np.uint8)
    rng = np.random.default_rng(seed)
    synd = ((rng.random((B, H.shape[1])) < P[name]).astype(np.uint8) @ H.T % 2).astype(np.uint8)
    llr0 = np.asarray(jllr_from_channel(np.full(H.shape[1], P[name])))
    return H, synd, llr0


@pytest.mark.parametrize("name", list(CODES))
def test_coloring_and_row_perm_equal_jax(name):
    H = np.asarray(CODES[name]().toarray(), np.uint8)
    layers = color_checks(H)
    want = jcolor_checks(H)
    assert len(layers) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(layers, want))
    g, jg = LayeredTannerGraph(H, device="cpu"), JLayeredTannerGraph(H)
    assert np.array_equal(g.row_perm, jg.row_perm)
    assert g.layer_bounds == jg.layer_bounds
    assert np.array_equal(g.H, H[g.row_perm])
    for (lo, hi), edges, variables in zip(g.layer_bounds, g.layer_edges, g.layer_vars):
        # a layer's valid slots touch each variable once
        assert variables.numel() == int(H[g.row_perm[lo:hi]].sum())
        assert variables.unique().numel() == variables.numel()


def test_adaptive_alpha_exact_in_xla():
    alpha = jax.jit(lambda t: 1.0 - jnp.exp2(-t.astype(jnp.float32)))
    for t in range(1, 401):
        assert float(alpha(jnp.int32(t))) == float(np.float32(1.0 - 2.0 ** -t)), t


def _round_f32(x: Fraction) -> np.float32:
    """``x`` rounded to nearest float32, ties to even (exact reference)."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    # 4097 * 16773121 = 2^36 + 1: a * b = 2^-24 + 2^-60, a hair above the tie
    # between 1 and 1 + 2^-23 that a float64 sum would round to first
    a = torch.tensor([4097 * 2.0 ** -12, 1.0, -4097 * 2.0 ** -12, 3.0])
    b = torch.tensor([16773121 * 2.0 ** -48, 2.0 ** -24, 16773121 * 2.0 ** -48, 0.0])
    c = torch.tensor([1.0, 1.0, -1.0, -0.5])
    want = [1 + 2.0 ** -23, 1.0, -(1 + 2.0 ** -23), -0.5]
    assert _fma_f32(a, b, c).tolist() == want
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 2000)).astype(np.float32) * np.float32([[1], [1e-7], [1]])
    got = _fma_f32(*(torch.from_numpy(r) for r in x)).numpy()
    ref = [_round_f32(Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r)))
           for p, q, r in x.T]
    assert np.array_equal(got, np.asarray(ref, np.float32))


@pytest.mark.parametrize("name", list(CODES))
@pytest.mark.parametrize("scale", [0.0, 0.625])
def test_layered_min_sum_bit_exact(name, scale):
    H, synd, llr0 = _case(name, 64)
    kw = dict(bp_method="minimum_sum", max_iter=60, ms_scaling_factor=scale)
    ref = jbp_decode_layered(JLayeredTannerGraph(H), synd, llr0, **kw)
    got = bp_decode_layered(LayeredTannerGraph(H, device="cpu"), synd, llr0, **kw)
    for k in ("hard", "llr", "converged", "iterations"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k))), k
    assert 0 < int(got.converged.sum()) < 64 or name.startswith("surface")


@pytest.mark.parametrize("name", ["surface_hz", "flagship_hx", "flagship_hz"])
def test_layered_product_sum_rows_agree(name):
    """Measured at B = 128, 20 iterations: all rows agree on surface_hz, 127
    on flagship_hx, 124 on flagship_hz (the disagreements are rows neither
    side converges on, where ulp differences steer the trajectory)."""
    H, synd, llr0 = _case(name, 128)
    kw = dict(bp_method="product_sum", max_iter=20)
    ref = jbp_decode_layered(JLayeredTannerGraph(H), synd, llr0, **kw)
    got = bp_decode_layered(LayeredTannerGraph(H, device="cpu"), synd, llr0, **kw)
    rows = ((got.hard.numpy() == np.asarray(ref.hard)).all(1)
            & (got.converged.numpy() == np.asarray(ref.converged))
            & (got.iterations.numpy() == np.asarray(ref.iterations)))
    assert rows.mean() >= 0.95, rows.mean()


@pytest.mark.parametrize("schedule", ["serial", "layered"])
def test_layered_decoder_equals_jax(schedule):
    """BpOsdDecoder(schedule=...) against the JAX decoder's layered path on
    backend="xla"; every osdw satisfies its syndrome.

    The JAX ``BpOsdDecoder`` drops ``schedule`` (it lands in ``**unused``)
    and floods (ROADMAP F5), so the reference gets the two attributes the
    JAX ``BpDecoder`` constructor sets for a layered schedule.
    """
    H, synd, _ = _case("flagship_hx", 48, seed=11)
    kw = dict(error_rate=0.05, max_iter=80, bp_method="ms", ms_scaling_factor=0,
              osd_method="osd_cs", osd_order=10)
    ref = JBpOsdDecoder(H, backend="xla", schedule=schedule, **kw)
    assert ref.schedule == "parallel"
    ref.schedule, ref.graph = "layered", JLayeredTannerGraph(H)
    dec = BpOsdDecoder(H, schedule=schedule, **kw)
    assert dec.schedule == "layered"
    out = dec.decode_batch(synd)
    assert np.array_equal(out, ref.decode_batch(synd))
    for attr in ("bp_decoding_batch", "osd0_decoding_batch", "converge_batch", "iter_batch",
                 "log_prob_ratios_batch"):
        assert np.array_equal(getattr(dec, attr), np.asarray(getattr(ref, attr))), attr
    assert not dec.converge_batch.all()
    assert np.array_equal(out @ H.T % 2, synd)


def test_layered_osd_step_runs_on_unpermuted_graph():
    """The OSD of a layered decoder equals osd_decode on the unpermuted graph
    for the decoder's own LLRs of the rows BP failed."""
    H, synd, _ = _case("flagship_hz", 48, seed=12)
    dec = BpOsdDecoder(H, error_rate=0.05, max_iter=30, bp_method="ms", ms_scaling_factor=0.625,
                       osd_method="osd_cs", osd_order=8, schedule="serial")
    assert not np.array_equal(dec._layered.H, H)  # the layers permute the checks
    dec.decode_batch(synd)
    fail = ~dec.converge_batch
    assert fail.any()
    ref = osd_decode(TannerGraph(H, device="cpu"), synd[fail], dec.log_prob_ratios_batch[fail],
                     osd_method="osd_cs", osd_order=8)
    assert np.array_equal(dec.osdw_decoding_batch[fail], ref.osdw.numpy())
    assert np.array_equal(dec.osd0_decoding_batch[fail], ref.osd0.numpy())
    ok = dec.converge_batch
    assert np.array_equal(dec.osdw_decoding_batch[ok], dec.bp_decoding_batch[ok])


def test_layered_bp_decoder_equals_bp_decode_layered():
    H, synd, llr0 = _case("surface5_hx", 32)
    dec = BpDecoder(H, error_rate=P["surface5_hx"], max_iter=20, bp_method="ps",
                    schedule="serial")
    hard = dec.decode_batch(synd)
    ref = bp_decode_layered(LayeredTannerGraph(H, device="cpu"), synd, llr0, bp_method="ps",
                            max_iter=20)
    assert np.array_equal(hard, ref.hard.numpy())
    assert np.array_equal(dec.iter_batch, ref.iterations.numpy())
    conv = dec.converge_batch
    assert conv.any() and np.array_equal(hard[conv] @ H.T % 2, synd[conv])
