"""The CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test skips without a CUDA card, since a CUDA kernel has
no CPU mode.  Run on a machine with a card, where jax is not needed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from bp_osd_tpu_torch.codes import hgp, lifted_hgp, mkmn_16_4_6, mkmn_20_5_8, rep_code
from bp_osd_tpu_torch.decoder.bp import bp_decode, bp_decode_plain, llr_from_channel
from bp_osd_tpu_torch.decoder.osd import (build_osd_consts, eliminate_plain, osd_decode,
                                          osd_decode_plain)
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.ops.cuda_bp import (bp_flood, bp_flood_plan, k1_fits, latency_smem_bytes,
                                          latency_team, wide_grid, wide_plan, wide_smem_bytes)
from bp_osd_tpu_torch.ops.cuda_gf2 import (eliminate, gf2_elim_plan, k4_fits, k4_placement,
                                           k4_warp_fits)
from bp_osd_tpu_torch.ops.cuda_osd import k2_fits, osd_cs, osd_cs_plan, osd_e
from bp_osd_tpu_torch.ops.cuda_osd_large import osd_large

pytestmark = pytest.mark.gpu

CODES = {
    "surface": lambda: hgp(rep_code(3), rep_code(3)).hx.toarray(),
    "flagship": lambda: hgp(mkmn_16_4_6()).hx.toarray(),
    "625": lambda: hgp(mkmn_20_5_8()).hx.toarray(),
    "weight1": lambda: np.eye(6, dtype=np.uint8),
}
PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _batch(H, B, p, seed, dev):
    rng = np.random.default_rng(seed)
    err = torch.as_tensor((rng.random((B, H.shape[1])) < p).astype(np.float32), device=dev)
    H_f = torch.as_tensor(np.asarray(H), dtype=torch.float32, device=dev)
    synd = torch.remainder(err @ H_f.T, 2).to(torch.uint8)  # exact: sums of 0/1 below 2^24
    llr0 = llr_from_channel(np.full(H.shape[1], p)).to(dev).expand(B, H.shape[1])
    return synd, llr0


def _equal(a, b):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("code", ["surface", "flagship", "625", "weight1"])
@pytest.mark.parametrize("msf", [0.0, 0.625])
def test_bp_flood_min_sum_bit_identical(dev, code, msf):
    H = np.asarray(CODES[code](), np.uint8)
    g = TannerGraph(H, dev)
    synd, llr0 = _batch(H, 96, 0.06, 1, dev)
    kw = dict(method="minimum_sum", max_iter=60, ms_scaling_factor=msf, emit_state=True)
    skip = torch.zeros(96, dtype=torch.bool, device=dev)
    skip[::7] = True
    for extra in ({}, {"skip": skip}):
        _equal(bp_flood(g, synd, llr0, **kw, **extra),
               bp_decode_plain(g, synd, llr0, **kw, **extra))


def test_bp_flood_resume_bit_identical(dev):
    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, dev)
    synd, llr0 = _batch(H, 128, 0.05, 2, dev)
    kw = dict(method="minimum_sum", ms_scaling_factor=0.0)
    first = bp_flood(g, synd, llr0, max_iter=24, emit_state=True, **kw)
    _equal(bp_flood(g, synd, llr0, max_iter=96, v2c_init=first[4], it0=24, **kw),
           bp_decode_plain(g, synd, llr0, max_iter=96, v2c_init=first[4], it0=24, **kw))


def test_bp_flood_product_sum(dev):
    """tanhf/atanhf in the kernel and torch's CUDA tanh/atanh may round
    differently by an ulp: llr within 1e-4, decisions identical."""
    H = np.asarray(CODES["surface"](), np.uint8)
    g = TannerGraph(H, dev)
    synd, llr0 = _batch(H, 64, 0.08, 3, dev)
    kw = dict(method="product_sum", max_iter=20, ms_scaling_factor=1.0)
    k = bp_flood(g, synd, llr0, **kw)
    p = bp_decode_plain(g, synd, llr0, **kw)
    for i in (0, 2, 3):
        assert torch.equal(k[i], p[i])
    assert torch.allclose(k[1], p[1], atol=1e-4)


@pytest.mark.parametrize("code,order", [("surface", 4), ("flagship", 0),
                                        ("flagship", 7), ("flagship", 42),
                                        ("625", 42)])
def test_osd_cs_bit_identical(dev, code, order):
    H = np.asarray(CODES[code](), np.uint8)
    g = TannerGraph(H, dev)
    synd, llr0 = _batch(H, 80, 0.06, 4, dev)
    res = bp_decode(g, synd, llr0, bp_method="ms", max_iter=30, ms_scaling_factor=0.0)
    perm = torch.argsort(res.llr, dim=1, stable=True).to(torch.int32)
    pairs = build_osd_consts(g, "osd_cs", order).pairs
    skip = res.converged.clone()
    skip[::2] = False
    for sk in (None, skip):
        k = osd_cs(g, perm, synd, osd_order=order, pairs=pairs, skip=sk)
        p = osd_decode_plain(g, perm, synd, method="osd_cs", osd_order=order,
                             pairs=pairs, skip=sk)
        _equal(k, p)
        Hf = torch.as_tensor(H, dtype=torch.float32, device=dev)
        live = torch.ones_like(res.converged) if sk is None else ~sk
        got = torch.remainder(k[1][live].float() @ Hf.T, 2).to(torch.uint8)
        assert torch.equal(got, synd[live])


def test_wrappers_count_launches_and_check_inputs(dev):
    H = np.asarray(CODES["surface"](), np.uint8)
    g = TannerGraph(H, dev)
    synd, llr0 = _batch(H, 8, 0.05, 5, dev)
    before = bp_flood.launches
    bp_decode(g, synd, llr0, max_iter=5, backend="cuda")
    assert bp_flood.launches == before + 1
    with pytest.raises(ValueError):
        bp_flood(g, synd.to(torch.int32), llr0, method="minimum_sum", max_iter=5,
                 ms_scaling_factor=0.0)
    with pytest.raises(ValueError):
        bp_decode(g, synd, llr0, backend="torch")


def _osd_inputs(H, B, seed, dev, p=0.06):
    """Syndromes of random errors and the order of random reliabilities."""
    rng = np.random.default_rng(seed)
    err = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    synd = torch.as_tensor(err @ H.T % 2, dtype=torch.uint8, device=dev)
    llr = torch.as_tensor(rng.normal(2.0, 1.0, (B, H.shape[1])).astype(np.float32), device=dev)
    return synd, torch.argsort(llr, dim=1, stable=True).to(torch.int32)


_LIFTED = {}  # lift -> (H, graph): the rank of a large code takes seconds


def _lifted(lift, dev):
    if lift not in _LIFTED:
        H = np.asarray(lifted_hgp(PROTO, lift=lift).hx.toarray(), np.uint8)
        _LIFTED[lift] = H, TannerGraph(H, dev)
    return _LIFTED[lift]


@pytest.mark.parametrize("lift", [60, 100, 400, 500, 700])
@pytest.mark.parametrize("order", [0, 6, 15])
def test_osd_large_bit_identical(dev, lift, order):
    """K5 == the plain version at lifts 60 and 100 (24 rows), 400 (m 4800,
    the 5-word registers of warp 0), 500 (m 6000, 8 words) and 700 (m 8400,
    32 words; a few rows: the plain version takes about a second a row)."""
    H, g = _lifted(lift, dev)
    assert not k2_fits(g, order)
    synd, perm = _osd_inputs(H, 24 if lift <= 100 else 3, lift + order, dev)
    pairs = build_osd_consts(g, "osd_cs", order).pairs
    k = osd_large(g, perm, synd, osd_order=order, pairs=pairs)
    _equal(k, osd_decode_plain(g, perm, synd, method="osd_cs", osd_order=order, pairs=pairs))
    Hf = torch.as_tensor(H, dtype=torch.float32, device=dev)
    for e in k:
        assert torch.equal(torch.remainder(e.float() @ Hf.T, 2).to(torch.uint8), synd)
    assert bool((k[1].sum(1) <= k[0].sum(1)).all())


@pytest.mark.parametrize("order", [0, 7, 42])
def test_osd_large_equals_k2_on_flagship(dev, order):
    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, 64, order, dev)
    pairs = build_osd_consts(g, "osd_cs", order).pairs
    _equal(osd_large(g, perm, synd, osd_order=order, pairs=pairs),
           osd_cs(g, perm, synd, osd_order=order, pairs=pairs))


def test_osd_large_row_chunks(dev, monkeypatch):
    """Rows beyond one scratch buffer go out in several launches."""
    import bp_osd_tpu_torch.ops.cuda_osd_large as k5

    H = np.asarray(lifted_hgp(PROTO, lift=60).hx.toarray(), np.uint8)
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, 11, 8, dev)
    pairs = build_osd_consts(g, "osd_cs", 15).pairs
    whole = osd_large(g, perm, synd, osd_order=15, pairs=pairs)
    monkeypatch.setattr(k5, "_SCRATCH_BYTES", 3 * 4 * k5._row_words(g.m, g.n))
    before = osd_large.launches
    _equal(osd_large(g, perm, synd, osd_order=15, pairs=pairs), whole)
    assert osd_large.launches == before + 4  # 11 rows, 3 per launch


def test_osd_large_skip_rows_and_launches(dev):
    H = np.asarray(lifted_hgp(PROTO, lift=60).hx.toarray(), np.uint8)
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, 12, 3, dev)
    pairs = build_osd_consts(g, "osd_cs", 15).pairs
    skip = torch.zeros(12, dtype=torch.bool, device=dev)
    skip[::3] = True
    full = osd_large(g, perm, synd, osd_order=15, pairs=pairs)
    part = osd_large(g, perm, synd, osd_order=15, pairs=pairs, skip=skip)
    for a, b in zip(part, full):
        assert not bool(a[skip].any()) and torch.equal(a[~skip], b[~skip])
    # osd_decode on the card routes a code K2 cannot hold to K5
    before, before_k2 = osd_large.launches, osd_cs.launches
    llr = torch.as_tensor(np.random.default_rng(4).normal(2, 1, (12, g.n)).astype(np.float32),
                          device=dev)
    osd_decode(g, synd, llr, osd_method="osd_cs", osd_order=15, backend="cuda")
    assert osd_large.launches == before + 1 and osd_cs.launches == before_k2


@pytest.mark.parametrize("code,order", [("surface", 1), ("surface", 16), ("flagship", 1),
                                        ("flagship", 16), ("625", 12)])
def test_osd_e_bit_identical(dev, code, order):
    """K3 against the plain osd_e, with and without skip rows."""
    H = np.asarray(CODES[code](), np.uint8)
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, 48, order, dev)
    skip = torch.zeros(48, dtype=torch.bool, device=dev)
    skip[::3] = True
    for sk in (None, skip):
        _equal(osd_e(g, perm, synd, osd_order=order, skip=sk),
               osd_decode_plain(g, perm, synd, method="osd_e", osd_order=order, skip=sk))


@pytest.mark.parametrize("code", ["surface", "flagship", "625", "weight1", "lift60", "lift100"])
def test_eliminate_both_placements(dev, code, monkeypatch):
    """K4's warp kernel (where its layout fits) and its block kernel in shared
    and device memory against ``eliminate_plain`` in all five outputs, skip
    rows included, and with the batch split over launches."""
    import bp_osd_tpu_torch.ops.cuda_gf2 as k4

    H = (np.asarray(lifted_hgp(PROTO, lift=int(code[4:])).hx.toarray(), np.uint8)
         if code.startswith("lift") else np.asarray(CODES[code](), np.uint8))
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, 20, 7, dev)
    skip = torch.zeros(20, dtype=torch.bool, device=dev)
    skip[1::4] = True
    placements = (("warp",) * k4_warp_fits(g) + ("shared",) * k4_fits(g) + ("global",))
    assert k4_fits(g) == (code != "lift100")
    assert k4_warp_fits(g) == (not code.startswith("lift"))
    assert k4_placement(g) == placements[0]
    for sk in (None, skip):
        want = eliminate_plain(g, perm, synd, skip=sk)
        for pl in placements + ("auto",):
            _equal(eliminate(g, perm, synd, skip=sk, placement=pl), want)
    monkeypatch.setattr(k4, "_LAUNCH_BYTES", 6 * 4 * g.m * g.num_words)
    for pl in {placements[0], placements[-1]}:
        before, before_warp = eliminate.launches, eliminate.warp_launches
        _equal(eliminate(g, perm, synd, skip=skip, placement=pl),
               eliminate_plain(g, perm, synd, skip=skip))
        assert eliminate.launches == before + 4  # 20 rows, 6 per launch
        assert eliminate.warp_launches == before_warp + 4 * (pl == "warp")


@pytest.mark.parametrize("B", [1, 33, 140, 1001])
def test_eliminate_warp_batch_sizes(dev, B):
    """K4's warp kernel on one row, on fewer rows than the card has SMs, on
    two warps a block and on several warps a block with a ragged last block:
    all five outputs equal ``eliminate_plain`` and the block kernel's, skip
    rows zero."""
    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, B, 80 + B, dev)
    plan = gf2_elim_plan(g, B)
    assert plan["grid"] * plan["warps_per_block"] >= B
    assert plan["resident_per_sm"] >= plan["warps_per_block"] >= 1
    if B == 1001:
        assert plan["warps_per_block"] > 1 and B % plan["warps_per_block"]
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[2::3] = True
    for sk in (None, skip):
        want = eliminate_plain(g, perm, synd, skip=sk)
        _equal(eliminate(g, perm, synd, skip=sk, placement="warp"), want)
        _equal(eliminate(g, perm, synd, skip=sk, placement="shared"), want)


def test_osd_decode_routes_to_k3_and_k4(dev):
    """On the flagship, osd0 and order-0 decodes launch K4's warp kernel and
    not K2, osd_e launches K3, and both equal the plain OSD."""
    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, dev)
    synd, _ = _osd_inputs(H, 32, 11, dev)
    llr = torch.as_tensor(np.random.default_rng(2).normal(2, 1, (32, g.n)).astype(np.float32),
                          device=dev)
    perm = torch.argsort(llr, dim=1, stable=True).to(torch.int32)
    for method, order, counter in (("osd0", 0, eliminate), ("osd_cs", 0, eliminate),
                                   ("osd_e", 10, osd_e)):
        before, before_k2 = counter.launches, osd_cs.launches
        before_warp = eliminate.warp_launches
        out = osd_decode(g, synd, llr, osd_method=method, osd_order=order, backend="cuda")
        assert counter.launches == before + 1 and osd_cs.launches == before_k2
        assert eliminate.warp_launches == before_warp + (counter is eliminate)
        _equal(out, osd_decode_plain(g, perm, synd, method=method, osd_order=order))


def test_bp_flood_device_memory_placement(dev, monkeypatch):
    """The dense [[10000,420]] lifted product (lift 400) is above K1's shared
    memory: K1 keeps the state in device memory, bit-identical to the plain
    version, also when the rows go out in several launches."""
    import bp_osd_tpu_torch.ops.cuda_bp as k1

    H = np.asarray(lifted_hgp(PROTO, lift=400).hx.toarray(), np.uint8)
    g = TannerGraph(H, dev)
    assert not k1_fits(g)
    synd, llr0 = _batch(H, 10, 0.02, 12, dev)
    kw = dict(method="minimum_sum", max_iter=40, ms_scaling_factor=0.625, emit_state=True)
    want = bp_decode_plain(g, synd, llr0, **kw)
    _equal(bp_flood(g, synd, llr0, **kw), want)
    monkeypatch.setattr(k1, "_SCRATCH_BYTES", 4 * 4 * (g.m + 2 * g.m * g.wr + 2 * g.n))
    before = bp_flood.launches
    _equal(bp_flood(g, synd, llr0, **kw), want)
    assert bp_flood.launches == before + 3  # 10 rows, 4 per launch


# ---- the team kernel's scheduling (persistent blocks, a row counter) ----

_MS = dict(method="minimum_sum", ms_scaling_factor=0.0)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("B", [1, 5, 3000, 4096, 65536])
def test_bp_flood_team_batch_sizes(dev, B):
    """One row, fewer rows than an SM's teams, and far more rows than the
    card's resident teams (each team takes many rows from the counter):
    bit-identical to the plain version in every output, the state
    included.  The plan follows its rule: wherever ``B`` reaches the SMs
    times the resident teams an SM of the graph's throughput team, that
    team (at 4096 rows and more the very plan of 16384 rows); below it, the
    latency plan where its kernel takes the graph: a block an SM of the
    whole-row team, ``ceil(B / SMs)`` rows in the busiest, its shared memory
    that of the Python mirror ``latency_smem_bytes``."""
    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, dev)
    synd, llr0 = _batch(H, B, 0.05, 20 + B, dev)
    plan = bp_flood_plan(g, B)
    full = bp_flood_plan(g, 16384)
    k = -(-B // _sms(dev))
    team = latency_team(g.m, g.n, g.wr, g.wc, k)
    assert not full["latency"]
    if B >= _sms(dev) * full["resident_per_sm"] or team is None:
        assert not plan["latency"] and plan["team_threads"] == full["team_threads"]
        assert plan["teams_per_block"] * plan["grid"] >= min(B, plan["teams_per_block"])
        if B >= 4096:
            assert plan == full
    else:
        assert plan["latency"] and plan["grid"] == min(B, _sms(dev))
        assert plan["team_threads"] == team and plan["teams_per_block"] == k
        assert plan["smem_bytes"] == latency_smem_bytes(team, k, g.wr)
    max_iter = 400 if B <= 3000 else 40
    kw = dict(max_iter=max_iter, emit_state=True, **_MS)
    _equal(bp_flood(g, synd, llr0, **kw), bp_decode_plain(g, synd, llr0, **kw))


def _spacetime():
    """The gross code's space-time matrix over 12 noisy rounds (936 x 2736)."""
    from bp_osd_tpu_torch.codes import gross_code, phenomenological

    return phenomenological(gross_code().hx, 12).H.toarray()


CODES["spacetime"] = _spacetime
_LATENCY_ROWS = {"1": lambda sms: 1, "5": lambda sms: 5, "sms": lambda sms: sms,
                 "sms+9": lambda sms: sms + 9, "2sms": lambda sms: 2 * sms,
                 "2sms+1": lambda sms: 2 * sms + 1}


@pytest.mark.parametrize("code", ["spacetime", "flagship"])
@pytest.mark.parametrize("rows", list(_LATENCY_ROWS))
@pytest.mark.parametrize("msf", [0.0, 0.625])
def test_bp_flood_latency_plan_bit_identical(dev, code, rows, msf):
    """The latency plan (a block an SM of one row or two, each thread's
    check row in registers) at 1 and 5 rows, a row on every SM, nine SMs
    with two, two on every SM and one past it, fresh (the channel prior
    broadcast) and resumed (skip rows, a prior a row, a random message state
    at it0 = 9), adaptive and fixed min-sum: the plain version's five
    outputs bit for bit, the state emitted.  The plan engages where its rule
    says: ``B`` below the SMs times the throughput team's resident teams
    an SM, and a team the latency kernel takes, with the shared memory of
    the Python mirror ``latency_smem_bytes``; on both graphs it takes every
    launch of one row an SM and of a few SMs with two."""
    H = np.asarray(CODES[code](), np.uint8)
    g = TannerGraph(H, dev)
    B = _LATENCY_ROWS[rows](_sms(dev))
    k = -(-B // _sms(dev))
    plan = bp_flood_plan(g, B)
    team = latency_team(g.m, g.n, g.wr, g.wc, k)
    engaged = team is not None and B < _sms(dev) * bp_flood_plan(g, 16384)["resident_per_sm"]
    assert plan["latency"] == engaged
    if engaged:
        assert plan["team_threads"] == team and plan["grid"] == min(B, _sms(dev))
        assert plan["teams_per_block"] == k
        assert plan["smem_bytes"] == latency_smem_bytes(team, k, g.wr)
    if rows in ("1", "5", "sms", "sms+9"):
        assert engaged
    synd, llr0 = _batch(H, B, 0.03 if code == "spacetime" else 0.06, 30 + B, dev)
    rng = np.random.default_rng(31 + B)
    prior = torch.as_tensor(rng.uniform(1.0, 4.0, (B, g.n)).astype(np.float32), device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[1::4] = True
    v2c = torch.as_tensor(rng.normal(1.0, 2.0, (B, g.m * g.wr)).astype(np.float32), device=dev)
    for l0, extra in ((llr0, {}), (prior, {"skip": skip, "v2c_init": v2c, "it0": 9})):
        kw = dict(method="minimum_sum", ms_scaling_factor=msf, max_iter=60, emit_state=True,
                  **extra)
        _equal(bp_flood(g, synd, l0, **kw), bp_decode_plain(g, synd, l0, **kw))


def _wide_rows():
    """A random code whose rows weigh 9 to 13: the team kernel's generic
    check path (rows of more than 8 slots)."""
    rng = np.random.default_rng(5)
    H = np.zeros((40, 120), np.uint8)
    for c in range(40):
        H[c, rng.choice(120, size=9 + c % 5, replace=False)] = 1
    return H


CODES["wide"] = _wide_rows


@pytest.mark.parametrize("code", ["surface", "flagship", "625", "weight1", "wide"])
@pytest.mark.parametrize("team_warps", [0, 1, 2, 3])
def test_bp_flood_team_sizes_and_skip_rows(dev, code, team_warps, monkeypatch):
    """Teams of one warp (__syncwarp) and of several (a named barrier each)
    give the plain version's results bit for bit, with skip rows, a
    per-row prior and a resumed state."""
    import bp_osd_tpu_torch.ops.cuda_bp as k1

    H = np.asarray(CODES[code](), np.uint8)
    g = TannerGraph(H, dev)
    if team_warps and -(-g.m // (32 * team_warps)) > 8:
        pytest.skip("a team this small would own more than 8 checks a thread")
    B = 300
    synd, _ = _batch(H, B, 0.06, 7, dev)
    rng = np.random.default_rng(8)
    llr0 = torch.as_tensor(rng.uniform(1.0, 4.0, (B, g.n)).astype(np.float32), device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[::5] = True
    v2c = torch.as_tensor(rng.normal(1.0, 2.0, (B, g.m * g.wr)).astype(np.float32), device=dev)
    monkeypatch.setattr(k1, "_TEAM_WARPS", team_warps)
    for extra in ({"skip": skip}, {"skip": skip, "v2c_init": v2c, "it0": 9}):
        kw = dict(max_iter=50, emit_state=True, **_MS, **extra)
        _equal(bp_flood(g, synd, llr0, **kw),
               bp_decode_plain(g, synd, llr0, **kw))


def test_bp_flood_team_resume_chain(dev):
    """The pipeline's chain 24 -> 96 -> 400 through the team kernel equals a
    straight run and the plain version's chain."""
    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, dev)
    synd, llr0 = _batch(H, 2048, 0.05, 21, dev)
    straight = bp_flood(g, synd, llr0, max_iter=400, **_MS)
    _equal(straight, bp_decode_plain(g, synd, llr0, max_iter=400, **_MS))
    hard, llr, conv, iters, v2c = (x.clone() for x in
                                  bp_flood(g, synd, llr0, max_iter=24, emit_state=True, **_MS))
    for s_prev, s_next in ((24, 96), (96, 400)):
        sel = torch.nonzero(~conv).flatten()
        out = bp_flood(g, synd[sel], llr0[sel], max_iter=s_next, v2c_init=v2c[sel],
                       it0=s_prev, emit_state=s_next < 400, **_MS)
        want = bp_decode_plain(g, synd[sel], llr0[sel], max_iter=s_next, v2c_init=v2c[sel],
                               it0=s_prev, emit_state=s_next < 400, **_MS)
        _equal(out, want)
        hard[sel], llr[sel], conv[sel], iters[sel] = out[:4]
        if out[4] is not None:
            v2c[sel] = out[4]
    _equal((hard, llr, conv, iters), straight[:4])


def test_bp_flood_spacetime_chain_and_row_iteration_counts(dev, monkeypatch):
    """The gross code's space-time matrix over 12 noisy rounds (936 x 2736):
    the chain 624 -> 2496 -> 10000 of adaptive min-sum, each launch with and
    without a row-iteration counter, equals the plain version's bit for bit,
    and each counter reads the rows' iterations past the launch's ``it0``,
    in the team kernel and in the device-memory placement; the staged
    pipeline with the recorder on gives the same bits and the counters
    ``bp.row_iters.<i>`` of the split of each row's iterations by the caps,
    and ``bp_flood.latency_rows`` the rows of its stages that the latency
    plan took."""
    import bp_osd_tpu_torch.ops.cuda_bp as k1
    from bp_osd_tpu_torch.decoder.pipeline import decode_pipeline
    from bp_osd_tpu_torch.utils import profiling

    H = CODES["spacetime"]()
    g = TannerGraph(H, dev)
    assert k1_fits(g)
    B = 512
    synd, llr0 = _batch(H, B, 0.025, 24, dev)
    caps = (624, 2496, 10000)
    sel, v2c, it0 = torch.arange(B, device=dev), None, 0
    for cap in caps:
        assert sel.numel() > 0, f"no row left for the launch to {cap}"
        args = (g, synd[sel], llr0[sel])
        kw = dict(max_iter=cap, it0=it0, v2c_init=v2c, emit_state=cap < caps[-1], **_MS)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        out = bp_flood(*args, row_iters=count, **kw)
        _equal(out, bp_flood(*args, **kw))
        _equal(out, bp_decode_plain(*args, **kw))
        assert int(count) == int((out[3].long() - it0).sum()) > 0
        with monkeypatch.context() as mp:
            mp.setattr(k1, "k1_fits", lambda graph, product_sum=False: False)
            count_g = torch.zeros(1, dtype=torch.int64, device=dev)
            _equal(bp_flood(*args, row_iters=count_g, **kw), out)
            assert int(count_g) == int(count)
        keep = ~out[2]
        sel, v2c, it0 = sel[keep], out[4][keep] if out[4] is not None else None, cap

    kw = dict(bp_method="ms", max_iter=10000, ms_scaling_factor=0.0, osd_method="osd_cs",
              osd_order=7)
    plain = decode_pipeline(g, synd, llr0[0], **kw)
    profiling.collect()
    profiling.enable()
    try:
        traced = decode_pipeline(g, synd, llr0[0], **kw)
    finally:
        profiling.disable()
    counters = profiling.collect().counters
    _equal(traced, plain)
    t = traced.iterations.long()
    want = [int((t - a).clamp(0, b - a).sum()) for a, b in zip((0,) + caps[:-1], caps)]
    assert [counters.get(f"bp.row_iters.{i}", 0) for i in (1, 2, 3)] == want
    stage_rows = [counters.get(f"bp.stage_rows.{i}", 0) for i in (1, 2, 3)]
    latency = sum(r for r in stage_rows if r and bp_flood_plan(g, r)["latency"])
    assert latency > 0 and counters.get("bp_flood.latency_rows", 0) == latency


def _two_gross():
    """The two-gross code's space-time matrix over 18 noisy rounds (2736 x
    8064), above the team kernel's shared memory."""
    from bp_osd_tpu_torch.codes import phenomenological, two_gross_code

    return phenomenological(two_gross_code().hx, 18).H.toarray()


CODES["two_gross"] = _two_gross
_WIDE_ROWS = {"1": lambda sms: 1, "sms": lambda sms: sms, "sms+1": lambda sms: sms + 1,
              "stage2": lambda sms: 180, "2sms": lambda sms: 2 * sms,
              "2sms+1": lambda sms: 2 * sms + 1, "3sms+7": lambda sms: 3 * sms + 7,
              "4096": lambda sms: 4096}


@pytest.mark.parametrize("rows", list(_WIDE_ROWS))
@pytest.mark.parametrize("msf", [0.0, 0.625])
def test_bp_flood_wide_plan_bit_identical(dev, rows, msf):
    """The wide plan (persistent blocks of 1024 threads, one an SM, a row
    at a time, its tables and the row's totals and messages in shared
    memory) at 1 row, a row on every SM, one past it, a stage-2-sized
    launch, two rows an SM and one past, three and more rows an SM and a
    whole stage 1 of 4096 rows, fresh (the channel prior broadcast) and
    resumed (skip rows, a prior a row, a random message state at it0 = 9),
    adaptive and fixed min-sum: the plain version's five outputs bit for
    bit, the state emitted, and a row-iteration counter that reads the
    rows' iterations past ``it0``.  It engages at every batch, on the grid
    of the Python mirror ``wide_grid`` and with the shared memory of
    ``wide_smem_bytes``."""
    H = CODES["two_gross"]()
    g = TannerGraph(H, dev)
    B = _WIDE_ROWS[rows](_sms(dev))
    assert not k1_fits(g) and wide_plan(g, B)
    plan = bp_flood_plan(g, B)
    assert plan["wide"] and not plan["latency"] and plan["grid"] == wide_grid(B, _sms(dev))
    assert plan["team_threads"] == 1024 and plan["teams_per_block"] == 1
    assert plan["blocks_per_sm"] == 1
    assert plan["smem_bytes"] == wide_smem_bytes(g.m, g.n, g.wc)
    synd, llr0 = _batch(H, B, 0.015, 40 + B, dev)
    rng = np.random.default_rng(41 + B)
    prior = torch.as_tensor(rng.uniform(1.0, 4.0, (B, g.n)).astype(np.float32), device=dev)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[1::4] = True
    v2c = torch.as_tensor(rng.normal(1.0, 2.0, (B, g.m * g.wr)).astype(np.float32), device=dev)
    for l0, extra in ((llr0, {}), (prior, {"skip": skip, "v2c_init": v2c, "it0": 9})):
        kw = dict(method="minimum_sum", ms_scaling_factor=msf, max_iter=60, emit_state=True,
                  **extra)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        out = bp_flood(g, synd, l0, row_iters=count, **kw)
        _equal(out, bp_decode_plain(g, synd, l0, **kw))
        assert int(count) == int((out[3].long() - kw.get("it0", 0)).sum())


def test_bp_flood_two_gross_chain_and_wide_counters(dev):
    """The two-gross space-time matrix: the chain 624 -> 2496 -> 10000 of
    adaptive min-sum (every stage in the wide plan) equals the plain
    version's launch by launch, and the staged pipeline with the recorder on
    gives the same bits, with ``bp_flood.wide_rows`` every staged row and
    ``bp_flood.wide_row_iters`` the iterations of every stage."""
    from bp_osd_tpu_torch.decoder.pipeline import decode_pipeline
    from bp_osd_tpu_torch.utils import profiling

    H = CODES["two_gross"]()
    g = TannerGraph(H, dev)
    B = 1024
    synd, llr0 = _batch(H, B, 0.015, 29, dev)
    caps = (624, 2496, 10000)
    sel, v2c, it0 = torch.arange(B, device=dev), None, 0
    for cap in caps:
        assert sel.numel() > 0, f"no row left for the launch to {cap}"
        args = (g, synd[sel], llr0[sel])
        kw = dict(max_iter=cap, it0=it0, v2c_init=v2c, emit_state=cap < caps[-1], **_MS)
        assert wide_plan(g, sel.numel())
        out = bp_flood(*args, **kw)
        _equal(out, bp_decode_plain(*args, **kw))
        keep = ~out[2]
        sel, v2c, it0 = sel[keep], out[4][keep] if out[4] is not None else None, cap

    kw = dict(bp_method="ms", max_iter=10000, ms_scaling_factor=0.0, osd_method="osd_cs",
              osd_order=7)
    plain = decode_pipeline(g, synd, llr0[0], **kw)
    profiling.collect()
    profiling.enable()
    try:
        traced = decode_pipeline(g, synd, llr0[0], **kw)
    finally:
        profiling.disable()
    counters = profiling.collect().counters
    _equal(traced, plain)
    t = traced.iterations.long()
    want = [int((t - a).clamp(0, b - a).sum()) for a, b in zip((0,) + caps[:-1], caps)]
    assert [counters.get(f"bp.row_iters.{i}", 0) for i in (1, 2, 3)] == want
    stage_rows = [counters.get(f"bp.stage_rows.{i}", 0) for i in (1, 2, 3)]
    assert stage_rows[0] == B and stage_rows[1] > 0
    assert counters.get("bp_flood.wide_rows", 0) == sum(stage_rows)
    assert counters.get("bp_flood.wide_row_iters", 0) == sum(want)


@pytest.mark.parametrize("method,team_warps", [("product_sum", 0), ("minimum_sum", 1)])
def test_bp_flood_two_gross_off_the_wide_plan(dev, method, team_warps, monkeypatch):
    """On the two-gross space-time matrix, product-sum and a forced team
    size (``_TEAM_WARPS``) stay on the device-memory kernel at a batch of
    more rows than SMs: no wide row is counted, and the outputs are the
    plain version's (min-sum bit for bit; product-sum within the first
    design's tolerance, as in the teams)."""
    import bp_osd_tpu_torch.ops.cuda_bp as k1
    from bp_osd_tpu_torch.utils import profiling

    H = CODES["two_gross"]()
    g = TannerGraph(H, dev)
    B = 2 * _sms(dev) + 3
    synd, llr0 = _batch(H, B, 0.015, 23, dev)
    kw = dict(method=method, max_iter=20, ms_scaling_factor=1.0 if method == "product_sum"
              else 0.0, emit_state=True)
    assert wide_plan(g, B, method == "product_sum") == (method == "minimum_sum")
    monkeypatch.setattr(k1, "_TEAM_WARPS", team_warps)
    profiling.collect()
    profiling.enable()
    try:
        k = bp_flood(g, synd, llr0, **kw)
    finally:
        profiling.disable()
    counters = profiling.collect().counters
    assert counters.get("bp_flood.wide_rows", 0) == 0
    assert counters.get("bp_flood.wide_row_iters", 0) == 0
    p = bp_decode_plain(g, synd, llr0, **kw)
    if method == "minimum_sum":
        _equal(k, p)
    else:
        for i in (0, 2, 3):
            assert torch.equal(k[i], p[i])
        assert torch.allclose(k[1], p[1], atol=1e-4)


@pytest.mark.parametrize("code,team_warps", [("surface", 0), ("flagship", 0), ("flagship", 2),
                                             ("625", 0)])
def test_bp_flood_team_product_sum(dev, code, team_warps, monkeypatch):
    """Product-sum in the teams (c2v double-buffered) equals the one-block-
    per-sample kernel (the device-memory placement, forced) bit for bit in
    every output, and the plain version within the first design's tolerance
    (torch's CUDA tanh/atanh may round differently by an ulp: llr within
    1e-4, decisions identical)."""
    import bp_osd_tpu_torch.ops.cuda_bp as k1

    H = np.asarray(CODES[code](), np.uint8)
    g = TannerGraph(H, dev)
    synd, llr0 = _batch(H, 128, 0.05, 22, dev)
    kw = dict(method="product_sum", max_iter=20, ms_scaling_factor=1.0, emit_state=True)
    monkeypatch.setattr(k1, "_TEAM_WARPS", team_warps)
    k = bp_flood(g, synd, llr0, **kw)
    monkeypatch.setattr(k1, "k1_fits", lambda graph, product_sum=False: False)
    _equal(k, bp_flood(g, synd, llr0, **kw))
    p = bp_decode_plain(g, synd, llr0, **kw)
    for i in (0, 2, 3):
        assert torch.equal(k[i], p[i])
    assert torch.allclose(k[1], p[1], atol=1e-4)


@pytest.mark.parametrize("order", [0, 1, 42])
@pytest.mark.parametrize("B", [1, 700])
def test_osd_cs_warp_kernel_orders_and_skip(dev, order, B):
    """K2 (one warp a sample, several a block) at orders 0, 1 and 42, with
    skip rows, on one row and on more rows than a wave of blocks holds."""
    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, B, 30 + order, dev)
    pairs = build_osd_consts(g, "osd_cs", order).pairs
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[1::3] = True
    plan = osd_cs_plan(g, B, order)
    assert plan["warps_per_block"] >= 1 and plan["grid"] * plan["warps_per_block"] >= B
    for sk in (None, skip):
        _equal(osd_cs(g, perm, synd, osd_order=order, pairs=pairs, skip=sk),
               osd_decode_plain(g, perm, synd, method="osd_cs", osd_order=order,
                                pairs=pairs, skip=sk))


# ---- K5's panel design and K3 on the warp layout ----


@pytest.mark.parametrize("B", [1, 8, 140])
def test_osd_large_batches_and_chunks(dev, B, monkeypatch):
    """K5 on one row, on 8 and on more rows than the card has SMs, with skip
    rows and with the rows split over launches: bit-identical to the plain
    version."""
    import bp_osd_tpu_torch.ops.cuda_osd_large as k5

    H = np.asarray(lifted_hgp(PROTO, lift=60).hx.toarray(), np.uint8)
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, B, 40 + B, dev, p=0.04)
    pairs = build_osd_consts(g, "osd_cs", 15).pairs
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[1::4] = True
    for sk in (None, skip):
        want = osd_decode_plain(g, perm, synd, method="osd_cs", osd_order=15, pairs=pairs,
                                skip=sk)
        _equal(osd_large(g, perm, synd, osd_order=15, pairs=pairs, skip=sk), want)
    rows = max(1, B // 3)
    monkeypatch.setattr(k5, "_SCRATCH_BYTES", rows * 4 * k5._row_words(g.m, g.n))
    before = osd_large.launches
    _equal(osd_large(g, perm, synd, osd_order=15, pairs=pairs, skip=skip),
           osd_decode_plain(g, perm, synd, method="osd_cs", osd_order=15, pairs=pairs,
                            skip=skip))
    assert osd_large.launches == before + -(-B // rows)


@pytest.mark.parametrize("P", [1, 2, 7, 16, 31, 32])
def test_osd_large_panel_widths(dev, P, monkeypatch):
    """Panels of 1 to 32 columns give the same bits at lift 100 (a panel of
    one column is one trailing pass a pivot, 32 the widest the kernel
    takes); 33 columns are refused."""
    import bp_osd_tpu_torch.ops.cuda_osd_large as k5

    H = np.asarray(lifted_hgp(PROTO, lift=100).hx.toarray(), np.uint8)
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, 6, 50 + P, dev, p=0.04)
    pairs = build_osd_consts(g, "osd_cs", 15).pairs
    monkeypatch.setattr(k5, "_PANEL", P)
    _equal(osd_large(g, perm, synd, osd_order=15, pairs=pairs),
           osd_decode_plain(g, perm, synd, method="osd_cs", osd_order=15, pairs=pairs))
    monkeypatch.setattr(k5, "_PANEL", 33)
    with pytest.raises(RuntimeError):
        osd_large(g, perm, synd, osd_order=15, pairs=pairs)


@pytest.mark.parametrize("lift", [100, 400])
def test_osd_large_counts_pivots_and_passes(dev, lift):
    """With the recorder on, ``osd_large.pivots`` is the pivots the rows
    found (rank a row; none on a skip row) and ``osd_large.panel_passes`` at
    most ceil(last pivot column / P) + 1 a row, well below the pivots."""
    from bp_osd_tpu_torch.ops.cuda_osd_large import osd_large_panel
    from bp_osd_tpu_torch.utils import profiling

    H, g = _lifted(lift, dev)
    B = 8
    synd, perm = _osd_inputs(H, B, 7 + lift, dev, p=0.03)
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[3] = True
    pairs = build_osd_consts(g, "osd_cs", 15).pairs
    P = osd_large_panel(g.m, g.n, min(15, g.n - g.rank))
    profiling.collect()
    profiling.enable()
    try:
        osd_large(g, perm, synd, osd_order=15, pairs=pairs, skip=skip)
    finally:
        profiling.disable()
    counters = profiling.collect().counters
    el = eliminate_plain(g, perm[~skip], synd[~skip])
    assert counters["osd_large.pivots"] == int(el.pivot_mask.sum()) == (B - 1) * g.rank
    last = el.pivot_mask.int().cumsum(1).argmax(1) + 1  # columns up to the last pivot
    bound = int((-(-last // P) + 1).sum())
    passes = counters["osd_large.panel_passes"]
    assert B - 1 <= passes <= bound
    print(f"\nlift {lift}, panels of {P}: {counters['osd_large.pivots']} pivots in {passes} "
          f"passes, {counters['osd_large.pivots'] / passes:.2f} a pass")
    assert counters["osd_large.pivots"] / passes > P / 2


@pytest.mark.parametrize("lift,rows,panel", [(60, 1, 0), (60, 5, 0), (100, 16, 0), (100, 40, 0),
                                             (400, 2, 0), (500, 3, 0), (700, 3, 0), (100, 6, 1),
                                             (100, 6, 7), (100, 6, 31), (400, 2, 5)])
def test_osd_large_cluster_plans_bit_identical(dev, lift, rows, panel, monkeypatch):
    """A block a sample, clusters of 2, 4 and 8 blocks and the rule's
    choice give the plain version's bits, with and without skip rows,
    where warp 0 keeps 5 words a lane (lift 400 and below), 8 (lift 500)
    or 32 (lift 700), and at panels of 1 to 31 columns (``_PANEL``; 0: the
    default width); the rule takes the cluster plan below SMs / 2 rows
    where the card holds the clusters, and the recorder counts the
    launch's rows in ``osd_large.rows`` and, in the cluster plan, in
    ``osd_large.cluster_rows``."""
    import bp_osd_tpu_torch.ops.cuda_osd_large as k5
    from bp_osd_tpu_torch.utils import profiling

    H, g = _lifted(lift, dev)
    synd, perm = _osd_inputs(H, rows, 3 * lift + rows + panel, dev, p=0.04)
    pairs = build_osd_consts(g, "osd_cs", 15).pairs
    monkeypatch.setattr(k5, "_PANEL", panel)
    skip = torch.zeros(rows, dtype=torch.bool, device=dev)
    skip[1::3] = True
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    held = {c: k5.osd_large_clusters(g, 15, c)["clusters"] for c in (2, 4, 8)}
    rule = k5.osd_large_cluster(rows, sms, held.get)
    assert rule > 1 and rows * rule <= sms and held[rule] >= rows
    for sk in (None, skip):
        want = osd_decode_plain(g, perm, synd, method="osd_cs", osd_order=15, pairs=pairs,
                                skip=sk)
        for c in (None, 1, 2, 4, 8):
            _equal(k5._osd_large(g, perm, synd, 15, pairs, sk, c), want)
    profiling.collect()
    profiling.enable()
    try:
        osd_large(g, perm, synd, osd_order=15, pairs=pairs)
        k5._osd_large(g, perm, synd, 15, pairs, None, 1)
    finally:
        profiling.disable()
    counters = profiling.collect().counters
    assert counters["osd_large.rows"] == 2 * rows
    assert counters["osd_large.cluster_rows"] == rows


def test_osd_large_counters_absent_with_the_recorder_off(dev):
    """With the recorder off the kernel gets no counter and adds nothing:
    the next collection has no ``osd_large`` counter."""
    from bp_osd_tpu_torch.utils import profiling

    H, g = _lifted(100, dev)
    synd, perm = _osd_inputs(H, 4, 3, dev)
    pairs = build_osd_consts(g, "osd_cs", 15).pairs
    profiling.collect()
    assert not profiling._on
    osd_large(g, perm, synd, osd_order=15, pairs=pairs)
    torch.cuda.synchronize()
    assert not [k for k in profiling.collect().counters if k.startswith("osd_large.")]


@pytest.mark.parametrize("order", [1, 2, 12, 16])
@pytest.mark.parametrize("B", [1, 37, 1001])
def test_osd_e_warp_kernel_orders_and_skip(dev, order, B):
    """K3 (one warp a sample) at orders 1, 2, 12 and 16, with skip rows, on
    one row and on batches that are not a multiple of the samples a block
    holds: bit-identical to the plain osd_e."""
    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, B, 60 + order, dev)
    plan = osd_cs_plan(g, B, order, method="osd_e")
    assert plan["grid"] * plan["warps_per_block"] >= B
    skip = torch.zeros(B, dtype=torch.bool, device=dev)
    skip[2::5] = True
    for sk in (None, skip):
        _equal(osd_e(g, perm, synd, osd_order=order, skip=sk),
               osd_decode_plain(g, perm, synd, method="osd_e", osd_order=order, skip=sk))


@pytest.mark.parametrize("code", ["surface", "flagship", "625"])
def test_osd_e_and_osd_cs_share_the_elimination(dev, code):
    """K3 and K2 run the same warp elimination: their osd0 agree bit for bit
    at every order."""
    H = np.asarray(CODES[code](), np.uint8)
    g = TannerGraph(H, dev)
    synd, perm = _osd_inputs(H, 300, 71, dev)
    for order in (1, 8, 12):
        pairs = build_osd_consts(g, "osd_cs", order).pairs
        assert torch.equal(osd_e(g, perm, synd, osd_order=order)[0],
                           osd_cs(g, perm, synd, osd_order=order, pairs=pairs)[0])


def test_sharded_decode_on_the_cards_equals_unsharded(dev):
    """sharded_decode_fn over make_mesh() (every card) equals bp_decode +
    osd_decode on one card, and each card launched K1 and K2."""
    from bp_osd_tpu_torch.parallel import make_mesh, sharded_decode_fn

    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, dev)
    mesh = make_mesh()
    synd, llr0 = _batch(H, 64 * len(mesh), 0.05, 12, dev)
    kw = dict(bp_method="minimum_sum", max_iter=400, ms_scaling_factor=0.0)
    before = {f: dict(f.launches_on) for f in (bp_flood, osd_cs)}
    got = sharded_decode_fn(g, mesh, osd_method="osd_cs", osd_order=42, **kw)(synd, llr0)
    for f in (bp_flood, osd_cs):
        assert all(f.launches_on[d.index] > before[f].get(d.index, 0) for d in mesh.devices)
    bp = bp_decode(g, synd, llr0, **kw)
    osd = osd_decode(g, synd, bp.llr, osd_method="osd_cs", osd_order=42)
    keep = bp.converged[:, None]
    want = (torch.where(keep, bp.hard, osd.osdw), torch.where(keep, bp.hard, osd.osd0),
            bp.hard, bp.converged)
    _equal(got, want)


def test_kernels_on_a_second_card_while_the_first_is_current(dev):
    """K1-K5 on tensors on cuda:1 while cuda:0 is current: each wrapper makes
    its tensors' card current, and equals its plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA cards, found {torch.cuda.device_count()}")
    d1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    H = np.asarray(CODES["flagship"](), np.uint8)
    g = TannerGraph(H, d1)
    synd, llr0 = _batch(H, 96, 0.05, 13, d1)
    kw = dict(method="minimum_sum", max_iter=60, ms_scaling_factor=0.0)
    before = bp_flood.launches_on[1]
    _equal(bp_flood(g, synd, llr0, **kw), bp_decode_plain(g, synd, llr0, **kw))
    assert bp_flood.launches_on[1] == before + 1 and torch.cuda.current_device() == 0
    synd, perm = _osd_inputs(H, 64, 14, d1)
    pairs = build_osd_consts(g, "osd_cs", 42).pairs
    _equal(osd_cs(g, perm, synd, osd_order=42, pairs=pairs),
           osd_decode_plain(g, perm, synd, method="osd_cs", osd_order=42, pairs=pairs))
    _equal(osd_e(g, perm, synd, osd_order=12),
           osd_decode_plain(g, perm, synd, method="osd_e", osd_order=12))
    for pl in ("warp", "shared", "global"):
        _equal(eliminate(g, perm, synd, placement=pl), eliminate_plain(g, perm, synd))
    _equal(osd_large(g, perm, synd, osd_order=42, pairs=pairs),
           osd_decode_plain(g, perm, synd, method="osd_cs", osd_order=42, pairs=pairs))
    for f in (osd_cs, osd_e, eliminate, osd_large):
        assert f.launches_on[1] > 0, f.__name__
    assert torch.cuda.current_device() == 0



@pytest.mark.parametrize("osd_order", [3, 15])
def test_model_sharded_bposd_on_the_card(dev, osd_order):
    """Edge-sharded and block-row-sharded BP on a 1 x 2 mesh (both shards on
    the card; with two cards, one each) equal the unsharded BP bit for bit
    (K1; ``bp_decode_lifted``), and their gather-to-DP OSD the unsharded OSD,
    through the kernel ``osd_route`` picks, launched on every card of the
    mesh."""
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
    from bp_osd_tpu_torch.decoder.osd import osd_route
    from bp_osd_tpu_torch.parallel import Mesh2D, ShardedTannerGraph, edge_sharded_bp_fn
    from bp_osd_tpu_torch.parallel.large_code import (edge_sharded_bposd_fn,
                                                      lifted_sharded_bposd_fn)
    from bp_osd_tpu_torch.parallel.lifted_shard import ShardedLiftedGraph, lifted_sharded_bp_fn

    last = min(torch.cuda.device_count(), 2) - 1
    mesh = Mesh2D((torch.device("cuda", 0), torch.device("cuda", last)), (1, 2))
    q = lifted_hgp(PROTO, lift=40)
    H = np.asarray(q.hx.toarray(), np.uint8)
    g, lg = TannerGraph(H, dev), LiftedGraph(q.hx_proto, 40, dev)
    synd, llr0 = _batch(H, 64, 0.03, 21, dev)
    kw = dict(bp_method="minimum_sum", max_iter=60, ms_scaling_factor=0.625)
    osd_kw = dict(osd_method="osd_cs", osd_order=osd_order)
    kernel = {"k2": osd_cs, "k5": osd_large}[osd_route(g, "osd_cs", osd_order)]
    sg = ShardedTannerGraph(H, 2)
    assert sg.m_chunk * 2 == g.m  # 12 block rows of 40: no pad rows
    runs = (
        (edge_sharded_bp_fn(sg, mesh, **kw).decode, bp_decode(g, synd, llr0, **kw),
         edge_sharded_bposd_fn(sg, mesh, **kw, **osd_kw)),
        (lifted_sharded_bp_fn(ShardedLiftedGraph(lg, 2), mesh, **kw),
         bp_decode_lifted(lg, synd, llr0, **kw),
         lifted_sharded_bposd_fn(lg, H, mesh, n_shards=2, **kw, **osd_kw)))
    for bp_fn, want, bposd in runs:
        assert 0 < int(want.converged.sum()) < 64
        _equal(bp_fn(synd, llr0), want)
        before = dict(kernel.launches_on)
        osdw, conv = bposd(synd, llr0)
        osd = osd_decode(g, synd, want.llr, skip=want.converged, **osd_kw)
        _equal((osdw, conv), (torch.where(want.converged[:, None], want.hard, osd.osdw),
                              want.converged))
        assert all(kernel.launches_on[d.index] > before.get(d.index, 0) for d in mesh.devices)


def _lifted_case(lift, B, p, seed, dev):
    """The lifted product of ``PROTO`` at ``lift``: its ``hx_proto`` graph on
    the card, ``B`` syndromes of errors of rate ``p`` and the prior."""
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph

    q = lifted_hgp(PROTO, lift=lift)
    H = np.asarray(q.hx.toarray(), np.uint8)
    synd, llr0 = _batch(H, B, p, seed, dev)
    return LiftedGraph(q.hx_proto, lift, dev), synd, llr0


def _bits_equal(got, want):
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("lift", [8, 60])
@pytest.mark.parametrize("method,msf", [("minimum_sum", 0.625), ("minimum_sum", 0.0),
                                        ("product_sum", 1.0)])
@pytest.mark.parametrize("device_route", [False, True])
def test_bp_lifted_bit_identical(dev, lift, method, msf, device_route, monkeypatch):
    """K6 against its plain version ``_bp_rows`` on the card, both routes:
    hard, llr bits, converged and iterations equal; one launch a call."""
    import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6
    from bp_osd_tpu_torch.decoder.lifted_bp import _bp_rows

    monkeypatch.setattr(k6, "_FORCE_DEVICE_ROUTE", device_route)
    g, synd, llr0 = _lifted_case(lift, 96, 0.05, lift, dev)
    assert k6.k6_route(g) == ("device" if device_route else "shared")
    before = k6.bp_lifted.launches
    got = k6.bp_lifted(g, synd, llr0, method, 40, msf)
    assert k6.bp_lifted.launches == before + 1
    _bits_equal(got, _bp_rows(g, synd, llr0, method, 40, msf))
    assert 0 < int(got[2].sum()) < 96


@pytest.mark.parametrize("B", [1, 7, 300, 2000])
def test_bp_lifted_batch_sizes_and_one_launch(dev, B):
    """Any batch is one launch of K6 through ``bp_decode_lifted`` (persistent
    blocks take rows from a counter), equal to the plain version; a
    contiguous prior equals the broadcast one."""
    import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6
    from bp_osd_tpu_torch.decoder.lifted_bp import _bp_rows, bp_decode_lifted

    g, synd, llr0 = _lifted_case(60, B, 0.04, B, dev)
    before = k6.bp_lifted.launches
    res = bp_decode_lifted(g, synd, llr0[0], bp_method="ms", max_iter=50,
                           ms_scaling_factor=0.625)
    assert k6.bp_lifted.launches == before + 1
    _bits_equal(res, _bp_rows(g, synd, llr0, "minimum_sum", 50, 0.625))
    _bits_equal(k6.bp_lifted(g, synd, llr0.contiguous(), "minimum_sum", 50, 0.625), res)


def _proto_case(lift, B, p, seed, dev, proto=None):
    """A lifted graph of ``proto`` (default: the [[10000,420]] code's shape,
    the lift-8 product's ``hx_proto``) at ``lift`` on the card, ``B``
    syndromes of errors of rate ``p`` routed through ``chk_var`` (no dense
    matrix is built) and the prior."""
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph

    g = LiftedGraph(lifted_hgp(PROTO, lift=8).hx_proto if proto is None else proto, lift, dev)
    rng = np.random.default_rng(seed)
    err = torch.as_tensor((rng.random((B, g.n)) < p).astype(np.uint8), device=dev)
    pad = torch.cat([err, err.new_zeros(B, 1)], 1)
    synd = (pad[:, g.chk_var].view(B, g.m, g.wr).sum(-1) & 1).to(torch.uint8)
    llr0 = llr_from_channel(np.full(g.n, p)).to(dev).expand(B, g.n)
    return g, synd, llr0


@pytest.mark.parametrize("lift,route", [(942, "shared"), (943, "device")])
@pytest.mark.parametrize("method,msf", [("minimum_sum", 0.625), ("minimum_sum", 0.0)])
def test_bp_lifted_route_boundary(dev, lift, route, method, msf):
    """The lifts on either side of the min-sum shared route's boundary (the
    row's 3 m + n words and the tables in 232,448 bytes) take their routes
    by size and equal ``_bp_rows`` bit for bit."""
    import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6
    from bp_osd_tpu_torch.decoder.lifted_bp import _bp_rows

    g, synd, llr0 = _proto_case(lift, 48, 0.02, lift, dev)
    assert k6.k6_route(g) == route
    got = k6.bp_lifted(g, synd, llr0, method, 40, msf)
    _bits_equal(got, _bp_rows(g, synd, llr0, method, 40, msf))
    assert 0 < int(got[2].sum()) < 48


@pytest.mark.parametrize("lift", [60, 400])
@pytest.mark.parametrize("threads", [128, 256, 512, 1024])
@pytest.mark.parametrize("method,msf", [("minimum_sum", 0.625), ("product_sum", 1.0)])
def test_bp_lifted_team_sizes(dev, lift, threads, method, msf, monkeypatch):
    """Every team size of the plan's sweep (forced through ``_THREADS``)
    equals ``_bp_rows`` bit for bit; the plan reports the forced size."""
    import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6
    from bp_osd_tpu_torch.decoder.lifted_bp import _bp_rows

    monkeypatch.setattr(k6, "_THREADS", threads)
    g, synd, llr0 = _proto_case(lift, 300, 0.03, threads, dev)
    plan = k6.bp_lifted_plan(g, product_sum=method == "product_sum")
    assert plan["threads"] == threads and plan["rows_per_sm"] >= 1
    got = k6.bp_lifted(g, synd, llr0, method, 50, msf)
    _bits_equal(got, _bp_rows(g, synd, llr0, method, 50, msf))
    assert 0 < int(got[2].sum()) < 300


def test_bp_lifted_two_rows_an_sm(dev, monkeypatch):
    """At lift 400 a 512-thread min-sum row needs 100,024 bytes, so two rows
    share an SM; on a batch of more rows than the card holds at once, with
    rows of every iteration count, both stay bit for bit."""
    import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6
    from bp_osd_tpu_torch.decoder.lifted_bp import _bp_rows

    monkeypatch.setattr(k6, "_THREADS", 512)
    g, synd, llr0 = _proto_case(400, 8, 0.03, 0, dev)
    plan = k6.bp_lifted_plan(g)
    assert plan["route"] == "shared" and plan["rows_per_sm"] == 2, plan
    assert plan["smem_bytes"] == 100_024
    B = 2 * plan["sms"] * plan["rows_per_sm"] + 37
    g, synd, llr0 = _proto_case(400, B, 0.03, 1, dev)
    got = k6.bp_lifted(g, synd, llr0, "minimum_sum", 100, 0.625)
    _bits_equal(got, _bp_rows(g, synd, llr0, "minimum_sum", 100, 0.625))
    assert 0 < int(got[2].sum()) < B and int(got[3].max()) == 100


@pytest.mark.parametrize("B", [1, 100, 2000])
def test_bp_lifted_lift400_batch_sizes(dev, B):
    """At the [[10000,420]] code's shape, with the plan's own team size: one
    row, fewer rows than SMs x rows an SM, and 2000 rows, each one launch
    through ``bp_decode_lifted``, equal to ``_bp_rows``."""
    import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6
    from bp_osd_tpu_torch.decoder.lifted_bp import _bp_rows, bp_decode_lifted

    g, synd, llr0 = _proto_case(400, B, 0.01, B, dev)
    plan = k6.bp_lifted_plan(g)
    assert B == 2000 or B < plan["sms"] * plan["rows_per_sm"]
    before = k6.bp_lifted.launches
    res = bp_decode_lifted(g, synd, llr0[0], bp_method="ms", max_iter=60,
                           ms_scaling_factor=0.625)
    assert k6.bp_lifted.launches == before + 1
    _bits_equal(res, _bp_rows(g, synd, llr0, "minimum_sum", 60, 0.625))


def _shape_proto(shape):
    """A protograph of each loop shape K6 compiles: ``wide`` (row weight 10,
    depth 7: the generic loops), ``uneven`` (row weights 3 and 4: the slot
    loop unrolled to 8 with guards), ``fullW`` (every block row of weight W:
    the slot loop unrolled to W without guards)."""
    rng = np.random.default_rng(7)
    if shape == "wide":
        return [[tuple(int(x) for x in rng.integers(0, 50, int(rng.integers(1, 3))))
                 for _ in range(6)] for _ in range(4)]
    if shape == "uneven":
        return [[(0, 1), (2,), ()], [(3,), (0, 4), (1,)]]
    w = int(shape[4:])
    cols = [set(rng.permutation(8)[:w].tolist()) for _ in range(4)]
    return [[(int(rng.integers(0, 50)),) if J in row else () for J in range(8)] for row in cols]


@pytest.mark.parametrize("method,msf", [("minimum_sum", 0.625), ("minimum_sum", 0.0),
                                        ("product_sum", 1.0)])
@pytest.mark.parametrize("device_route", [False, True])
@pytest.mark.parametrize("shape", ["wide", "uneven", "full4", "full5", "full6", "full8"])
def test_bp_lifted_graph_shapes(dev, method, msf, device_route, shape, monkeypatch):
    """Every loop shape K6 compiles (``_shape_proto``), bit for bit on both
    routes."""
    import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6
    from bp_osd_tpu_torch.decoder.lifted_bp import _bp_rows

    monkeypatch.setattr(k6, "_FORCE_DEVICE_ROUTE", device_route)
    g, synd, llr0 = _proto_case(50, 96, 0.02, 3, dev, proto=_shape_proto(shape))
    if shape == "wide":
        assert g.wr > 8 and g.depth > 4
    else:
        assert g.depth <= 4 and k6.full_rows(g) == (shape != "uneven")
        assert g.wr == (4 if shape == "uneven" else int(shape[4:]))
    got = k6.bp_lifted(g, synd, llr0, method, 40, msf)
    _bits_equal(got, _bp_rows(g, synd, llr0, method, 40, msf))


def test_bp_lifted_checks_inputs(dev):
    import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6

    g, synd, llr0 = _lifted_case(8, 4, 0.05, 1, dev)
    with pytest.raises(ValueError):
        k6.bp_lifted(g, synd.to(torch.int32), llr0, "minimum_sum", 5, 0.625)
    with pytest.raises(ValueError):
        k6.bp_lifted(g, synd, llr0[:, :-1], "minimum_sum", 5, 0.625)
    with pytest.raises(ValueError):  # neither contiguous nor one broadcast row
        k6.bp_lifted(g, synd, llr0.contiguous()[:, ::1].t().contiguous().t(), "minimum_sum",
                     5, 0.625)
