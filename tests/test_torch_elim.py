"""bp_osd_tpu_torch's elimination (the plain version of kernel K4), the torch
steps after it, the plain osd_e (of kernel K3) and the kernel routing, against
the JAX package on inputs made with numpy from a seed.

All of it is integer work once the column order is fixed, so every comparison
is exact equality.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.codes import rep_code as jrep_code
from bp_osd_tpu.decoder import TannerGraph as JTannerGraph
from bp_osd_tpu.decoder import bp_decode as jbp_decode
from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.decoder.osd import _eliminate as j_eliminate
from bp_osd_tpu.ops.pallas_gf2 import eliminate_pallas
from bp_osd_tpu.ops.pallas_osd import osd_e_pallas

from bp_osd_tpu_torch.codes import lifted_hgp
from bp_osd_tpu_torch.decoder.osd import (
    eliminate_plain,
    osd_after_elimination,
    osd_decode_plain,
    osd_route,
)
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.ops.cuda_bp import bp_flood_smem_bytes, k1_fits
from bp_osd_tpu_torch.ops.cuda_gf2 import gf2_elim_smem_bytes, k4_fits
from bp_osd_tpu_torch.ops.cuda_osd import k2_fits, k3_fits

torch.set_num_threads(1)

CODES = {
    "surface": lambda: jhgp(jrep_code(3), jrep_code(3)).hx.toarray(),
    "flagship": lambda: jhgp(jmkmn_16_4_6()).hx.toarray(),
}
# the (3,4)-regular protograph of bench_large.py: lift L gives a 12L x 25L
# matrix of row weight 7 and column weight 4
PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]


def _lifted_shape(L, rank=None):
    return SimpleNamespace(m=12 * L, n=25 * L, wr=7, wc=4, rank=rank)


def _inputs(H, B, seed, p=0.07):
    rng = np.random.default_rng(seed)
    err = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    synd = (err @ H.T % 2).astype(np.uint8)
    perm = np.argsort(rng.normal(0, 1, (B, H.shape[1])), axis=1, kind="stable").astype(np.int32)
    return synd, perm


@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("with_skip", [False, True])
def test_eliminate_plain_equals_jax(code, with_skip):
    """All five outputs of ``eliminate_plain`` equal JAX ``_eliminate`` and
    ``eliminate_pallas(interpret=True)`` exactly (``h_work`` compared as
    uint32) on every live row; skipped rows are zero in the port's five."""
    H = np.asarray(CODES[code](), np.uint8)
    B = 12 if with_skip else 8
    synd, perm = _inputs(H, B, 5 + B)
    skip = np.arange(B) % 3 == 1 if with_skip else None
    jg = JTannerGraph(H)
    jskip = None if skip is None else jnp.asarray(skip.astype(np.int32))
    refs = (
        j_eliminate(jg, jnp.asarray(perm), jnp.asarray(synd.astype(np.int32)), skip=jskip),
        eliminate_pallas(jg, perm, synd.astype(np.int32), skip=jskip, block=16 if with_skip else 8,
                         interpret=True),
    )
    mine = eliminate_plain(TannerGraph(H, device="cpu"), torch.as_tensor(perm),
                           torch.as_tensor(synd),
                           skip=None if skip is None else torch.as_tensor(skip))
    assert mine.h_work.dtype == torch.int32 and mine.pivot_mask.dtype == torch.bool
    live = np.ones(B, bool) if skip is None else ~skip
    for ref in refs:
        for name, got, want in zip(mine._fields, mine, ref):
            got = got.numpy()
            if name == "h_work":
                got = got.view(np.uint32)
            assert np.array_equal(got[live], np.asarray(want)[live]), name
            assert not got[~live].any(), name


@pytest.mark.parametrize("method,order", [("osd0", 0), ("osd_e", 0), ("osd_e", 1),
                                          ("osd_e", 6)])
@pytest.mark.parametrize("code", sorted(CODES))
def test_osd_after_elimination_equals_plain_osd(code, method, order):
    """K4's route on the card (elimination, then osd0 read-off, T-column
    extraction and the torch search) gives exactly ``osd_decode_plain``'s
    osd0 and osdw, with zeros on skipped rows."""
    H = np.asarray(CODES[code](), np.uint8)
    synd, perm = _inputs(H, 16, 9)
    g = TannerGraph(H, device="cpu")
    perm_t, synd_t = torch.as_tensor(perm), torch.as_tensor(synd)
    skip = torch.as_tensor(np.arange(16) % 4 == 0)
    for sk in (None, skip):
        got = osd_after_elimination(eliminate_plain(g, perm_t, synd_t, skip=sk), perm_t,
                                    method=method, osd_order=order, skip=sk)
        want = osd_decode_plain(g, perm_t, synd_t, method=method, osd_order=order, skip=sk)
        for a, b in zip(got, want):
            assert a.dtype == torch.uint8 and torch.equal(a, b)


@pytest.fixture(scope="module")
def rep4_case():
    """``tests/test_pallas_osd.py``'s osd_e case: hgp(rep(4), rep(4)).hx,
    B = 24 at p = 0.12, BP min-sum 0.625 for 6 iterations."""
    H = np.asarray(jhgp(jrep_code(4), jrep_code(4)).hx.toarray(), np.uint8)
    rng = np.random.default_rng(31)
    synd = (((rng.random((24, H.shape[1])) < 0.12).astype(np.uint8)) @ H.T % 2).astype(np.uint8)
    llr0 = np.asarray(jllr_from_channel(np.full(H.shape[1], 0.12)))
    bp = jbp_decode(JTannerGraph(H), synd, llr0, bp_method="ms", max_iter=6,
                    ms_scaling_factor=0.625)
    perm = np.array(jnp.argsort(bp.llr, axis=1, stable=True).astype(jnp.int32))
    return H, synd, perm


@pytest.mark.parametrize("order", [1, 3, 7, 14])
def test_plain_osd_e_equals_pallas_kernel_interpreted(rep4_case, order):
    """The plain version of K3 equals the JAX package's
    ``osd_e_pallas(interpret=True)`` exactly in osd0 and osdw, tie-breaks
    included."""
    H, synd, perm = rep4_case
    e0, ew = osd_e_pallas(JTannerGraph(H), jnp.asarray(perm), jnp.asarray(synd, jnp.int32),
                          osd_order=order, interpret=True)
    g = TannerGraph(H, device="cpu")
    plain = osd_decode_plain(g, torch.as_tensor(perm), torch.as_tensor(synd), method="osd_e",
                             osd_order=order)
    assert np.array_equal(plain[0].numpy(), np.asarray(e0).astype(np.uint8))
    assert np.array_equal(plain[1].numpy(), np.asarray(ew).astype(np.uint8))


def test_osd_route_table():
    """The card's kernel for each (method, order) at the surface, flagship,
    lift-60 and lift-400 shapes, as the JAX package routes its Pallas
    backend with K2's fit in the place of ``fused_osd_fits``."""
    surface = TannerGraph(np.asarray(CODES["surface"](), np.uint8), device="cpu")
    flagship = TannerGraph(np.asarray(CODES["flagship"](), np.uint8), device="cpu")
    lift60 = TannerGraph(np.asarray(lifted_hgp(PROTO, lift=60).hx.toarray(), np.uint8),
                         device="cpu")
    lift400 = _lifted_shape(400, rank=4790)
    cases = [("osd0", 0), ("osd_cs", 0), ("osd_cs", 7), ("osd_cs", 42), ("osd_e", 0),
             ("osd_e", 4), ("osd_e", 12)]
    table = {
        "surface": ["k4", "k4", "k2", "k2", "k4", "k3", "k3"],
        "flagship": ["k4", "k4", "k2", "k2", "k4", "k3", "k3"],
        "lift60": ["k5", "k5", "k5", "k5", "k5", "k4", "k4"],
        "lift400": ["k5", "k5", "k5", "k5", "k5", "k4", "k4"],
    }
    graphs = {"surface": surface, "flagship": flagship, "lift60": lift60, "lift400": lift400}
    for name, g in graphs.items():
        assert [osd_route(g, mth, o) for mth, o in cases] == table[name], name
    assert k3_fits(flagship, 16) and k2_fits(flagship, 16)
    assert k4_fits(flagship) and k4_fits(lift60) and not k4_fits(lift400)
    assert not k4_fits(_lifted_shape(80))
    assert gf2_elim_smem_bytes(192, 400) == 10_068  # flagship: 192 x 13 words + state
    assert gf2_elim_smem_bytes(720, 1500) == 135_648
    assert gf2_elim_smem_bytes(960, 2000) == 242_292  # lift 80: above 232,448
    assert gf2_elim_smem_bytes(4800, 10000, in_global=True) == 4 * (3 * 150 + 3)


def test_k1_fits_at_lifts():
    """K1's shared memory (mirror of ``csrc/bp_flood.cu:bp_flood_smem_bytes``)
    fits the dense lifted product up to lift 140 and not from lift 141."""
    real = TannerGraph(np.asarray(lifted_hgp(PROTO, lift=60).hx.toarray(), np.uint8), device="cpu")
    shape = _lifted_shape(60)
    assert (real.m, real.n, real.wr, real.wc) == (shape.m, shape.n, shape.wr, shape.wc)
    assert [k1_fits(_lifted_shape(L)) for L in (60, 140, 141, 400)] == [True, True, False, False]
    assert bp_flood_smem_bytes(1680, 3500, 7, 4) == 231_840
    assert bp_flood_smem_bytes(4800, 10000, 7, 4) == 662_400
    assert k1_fits(TannerGraph(np.asarray(CODES["flagship"](), np.uint8), device="cpu"))
