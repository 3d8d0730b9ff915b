"""Kernel K6 (``csrc/bp_lifted.cu``, the whole lifted BP decode in one launch)
on the CPU: its routing tables against the plain version's index tables, a
torch emulation of the first design's three-pass iteration (routed by those
tables) against the plain version and the JAX package, the Python mirror of
its shared memory and route, and its wrapper's input checks, which refuse
CPU tensors.  The kernel's
own two-barrier order is emulated in ``tests/test_torch_k6_fused.py``.  The
card's side is ``tests/test_torch_kernels.py`` (marked ``gpu``) and
``chip_smoke.py`` phase 21."""

import jax
import numpy as np
import pytest
import torch

from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.decoder.lifted_bp import LiftedGraph as JLiftedGraph
from bp_osd_tpu.decoder.lifted_bp import bp_decode_lifted as jbp_decode_lifted

from bp_osd_tpu_torch.codes import lifted_hgp
from bp_osd_tpu_torch.decoder.bp import _alpha, _elementwise, normalize_bp_method
from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, _bp_rows, _route_tables
from bp_osd_tpu_torch.ops.cuda_bp import _SMEM_LIMIT
import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6

torch.set_num_threads(1)

# tests/test_torch_lifted.py's protographs
PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]
MULTI = [[(0, 1), (2,), ()], [(3,), (0, 4), (1,)]]
_BIG = 1e30
_TANH_CLIP = 1.0 - 1e-7


def _jax_fields(jg, proto):
    return dict(proto=proto, L=jg.L, edges=jg.edges, wr=jg.wr, chk_mask=jg.chk_mask)


def _case(proto, lift, B, p, seed):
    """The lifted product of ``proto`` at ``lift`` (its ``hx_proto``, the
    graph a ``proto``/``lift`` decoder builds) and ``B`` syndromes of errors
    of rate ``p``, as ``tests/test_torch_lifted.py`` makes them."""
    q = lifted_hgp(proto, lift=lift)
    H = np.asarray(q.hx.toarray(), np.uint8)
    rng = np.random.default_rng(seed)
    synd = ((rng.random((B, H.shape[1])) < p).astype(np.uint8) @ H.T % 2).astype(np.uint8)
    llr0 = np.array(jllr_from_channel(np.full(H.shape[1], p)), np.float32)
    return q.hx_proto, synd, llr0


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(got, want):
    for name, a, b in zip(("hard", "llr", "converged", "iterations"), got, want):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), name


# ---- (a) the tables name the plain version's routes, in its order ----------

@pytest.mark.parametrize("proto,lift", [(PROTO, 1), (PROTO, 8), (PROTO, 400), (MULTI, 6)])
@pytest.mark.parametrize("product", [False, True])
def test_route_tables_name_the_index_tables_routes(proto, lift, product):
    """Slot ``s`` of check ``(I, l)`` reads variable ``J L + (l + e) mod L``
    (``chk_var``), and entry ``d`` of variable ``(J, l')`` is edge
    ``(I L + (l' - e) mod L) wr + s`` (``var_edge``, whose column order is
    the plain version's summation order); pads on the same places.  On the
    protograph itself and on its lifted product's ``hx_proto`` (at lift 400
    the lift-8 one, whose exponents are a protograph too: building the
    lift-400 product takes ~20 s)."""
    if product:
        proto = lifted_hgp(proto, lift=8 if lift == 400 else lift).hx_proto
    g = LiftedGraph(proto, lift, device="cpu")
    L, m, n, wr, depth = g.L, g.m, g.n, g.wr, g.depth
    slots, blocks = g.slot_table.numpy(), g.block_edges.numpy()
    assert slots.shape == (g.mp, wr, 2) and blocks.shape == (g.np_, depth, 3)
    assert slots.dtype == blocks.dtype == np.int32
    ll = np.arange(L)
    J, e = slots[..., 0][:, None, :], slots[..., 1][:, None, :]   # [mp, 1, wr]
    var = np.where(J >= 0, J * L + (ll[None, :, None] + e) % L, n)  # [mp, L, wr]
    assert np.array_equal(var.reshape(-1), g.chk_var.numpy())
    I, s, e = (blocks[..., k][:, None, :] for k in range(3))        # [np, 1, depth]
    edge = np.where(I >= 0, (I * L + (ll[None, :, None] - e) % L) * wr + s, m * wr)
    assert np.array_equal(edge.reshape(-1), g.var_edge.numpy())
    # the pad slots of the slot table are the plain version's masked slots
    assert np.array_equal(slots[..., 0] >= 0, g.chk_mask[:, :, 0, 0].T)


@pytest.mark.parametrize("proto,lift", [(PROTO, 8), (MULTI, 6)])
@pytest.mark.parametrize("table", ["slot_table", "block_edges"])
def test_route_tables_checked_by_from_reference(proto, lift, table, monkeypatch):
    """The JAX graph's ``edges`` give the port's tables; a port whose K6
    tables disagree with them is refused; the tables travel with ``to``."""
    jg = JLiftedGraph(proto, lift)
    g = LiftedGraph.from_reference(_jax_fields(jg, proto), device="cpu")
    slots, blocks = _route_tables(jg.edges, g.np_, g.wr, g.depth)
    assert np.array_equal(slots, g.slot_table.numpy())
    assert np.array_equal(blocks, g.block_edges.numpy())
    assert getattr(g.to("meta"), table).device.type == "meta"
    init = LiftedGraph.__init__

    def init_shifted(self, *args, **kw):  # one entry of one table moved
        init(self, *args, **kw)
        t = getattr(self, table).clone()
        t.view(-1)[1] += 1
        setattr(self, table, t)

    monkeypatch.setattr(LiftedGraph, "__init__", init_shifted)
    with pytest.raises(ValueError, match=table):
        LiftedGraph.from_reference(_jax_fields(jg, proto), device="cpu")


# ---- (b) K6's iteration, emulated through the tables ------------------------

def k6_emulation(g: LiftedGraph, synd, llr0, method: str, max_iter: int, msf: float):
    """The first design of K6's iteration in torch (three passes: the check
    update v2c -> c2v, the variable sum, then v2c = total - c2v with the
    parity), routed by ``slot_table``/``block_edges`` as the kernel routes
    it: the min-sum check update as the kernel's running
    two-minimum (first minimum over ascending slots, 1e30 cap, then alpha
    times the magnitude), the tanh rule with forward and backward products,
    the variable sum from +0.0 over each block's edge list, and the rows
    frozen at first convergence.  Every row runs until all stop; a stopped
    row's outputs are kept."""
    L, mp, np_, wr = g.L, g.mp, g.np_, g.wr
    B, n = synd.shape[0], g.n
    slots, blocks = g.slot_table.long(), g.block_edges.long()
    deg = (slots[..., 0] >= 0).sum(1)
    ll = torch.arange(L)
    syn = synd.long().view(B, mp, L)

    def var_ix(I, s):  # [L] variables of block row I's slot s
        J, e = slots[I, s]
        return J * L + (ll + e) % L

    msg = torch.zeros(B, mp, L, wr)
    for I in range(mp):
        for s in range(int(deg[I])):
            msg[:, I, :, s] = llr0[:, var_ix(I, s)]
    out_hard = torch.zeros(B, n, dtype=torch.uint8)
    out_llr = llr0.clone()
    out_conv = torch.zeros(B, dtype=torch.bool)
    out_it = torch.zeros(B, dtype=torch.int32)
    live = torch.ones(B, dtype=torch.bool)
    for it in range(1, max_iter + 1):
        c2v = torch.zeros_like(msg)
        for I in range(mp):
            dc = int(deg[I])
            x = msg[:, I, :, :dc]
            if method == "minimum_sum":
                m1 = torch.full((B, L), _BIG)
                m2 = torch.full((B, L), _BIG)
                i1 = torch.full((B, L), 31)
                neg = torch.zeros(B, L, dtype=torch.long)
                for s in range(dc):
                    mag = x[..., s].abs()
                    neg += (x[..., s] < 0).long()
                    i1 = torch.where(mag < m1, s, i1)
                    m2 = torch.minimum(m2, torch.maximum(m1, mag))
                    m1 = torch.minimum(m1, mag)
                alpha = _alpha(msf, it)
                parity = (neg + syn[:, I]) & 1
                for s in range(dc):
                    val = torch.where(i1 == s, m2 * alpha, m1 * alpha)
                    flip = (parity ^ (x[..., s] < 0).long()) == 1
                    c2v[:, I, :, s] = torch.where(flip, -val, val)
            else:
                t = _elementwise(torch.tanh, 0.5 * x)
                sgn = 1.0 - 2.0 * syn[:, I].float()
                fwd = [torch.ones(B, L)]
                for s in range(dc - 1):
                    fwd.append(fwd[-1] * t[..., s])
                bwd = torch.ones(B, L)
                for s in range(dc - 1, -1, -1):
                    y = torch.clamp(sgn * fwd[s] * bwd, -_TANH_CLIP, _TANH_CLIP)
                    c2v[:, I, :, s] = 2.0 * _elementwise(torch.atanh, y)
                    bwd = bwd * t[..., s]
        tot = torch.empty(B, n)
        flat = c2v.reshape(B, mp * L, wr)
        for J in range(np_):
            acc = torch.zeros(B, L)
            for I, s, e in blocks[J].tolist():
                if I < 0:
                    break
                acc = acc + flat[:, I * L + (ll - e) % L, s]
            tot[:, J * L:(J + 1) * L] = llr0[:, J * L:(J + 1) * L] + acc
        hard = (tot <= 0).to(torch.uint8)
        ok = torch.ones(B, dtype=torch.bool)
        msg = torch.zeros_like(msg)
        for I in range(mp):
            parity = syn[:, I].clone()
            for s in range(int(deg[I])):
                v = var_ix(I, s)
                msg[:, I, :, s] = tot[:, v] - c2v[:, I, :, s]
                parity ^= hard[:, v].long()
            ok &= (parity == 0).all(1)
        stop = live & (ok | (it == max_iter))
        out_hard[stop], out_llr[stop] = hard[stop], tot[stop]
        out_conv[stop], out_it[stop] = ok[stop], it
        live &= ~stop
        if not bool(live.any()):
            break
    return out_hard, out_llr, out_conv, out_it


@pytest.mark.parametrize("proto,lift", [(PROTO, 8), (MULTI, 6)])
@pytest.mark.parametrize("bp_method,msf", [("minimum_sum", 0.625), ("minimum_sum", 0.0),
                                           ("product_sum", 1.0)])
def test_k6_emulation_equals_plain_and_jax(proto, lift, bp_method, msf):
    """The emulation equals ``_bp_rows`` bit for bit (llr as int32 bits) and,
    through it, JAX's ``bp_decode_lifted`` under ``jax.jit``: min-sum bit
    for bit; product-sum with decisions equal and llr at the tolerance of
    ``tests/test_torch_lifted.py`` (rtol 0.02, atol 1e-3: one ulp of torch's
    tanh against XLA's, near the 1 - 1e-7 clip, becomes up to ~2% of the
    llr through atanh)."""
    hx_proto, synd, llr0 = _case(proto, lift, 12, 0.06, 5)
    g = LiftedGraph(hx_proto, lift, device="cpu")
    method = normalize_bp_method(bp_method)
    s_t = torch.as_tensor(synd)
    l_t = torch.as_tensor(llr0).expand(12, -1)
    got = k6_emulation(g, s_t, l_t, method, 25, msf)
    plain = _bp_rows(g, s_t, l_t, method, 25, msf)
    _equal(got, plain)
    assert 0 < int(got[2].sum()) < 12
    jg = JLiftedGraph(hx_proto, lift)
    kw = dict(bp_method=bp_method, max_iter=25, ms_scaling_factor=msf)
    ref = jax.jit(lambda s, l: jbp_decode_lifted(jg, s, l, **kw))(synd, llr0)
    for k, a in zip(("hard", "llr", "converged", "iterations"), got):
        b = np.asarray(getattr(ref, k))
        if k == "llr" and method == "product_sum":
            np.testing.assert_allclose(a.numpy(), b, rtol=0.02, atol=1e-3)
        else:
            assert np.array_equal(a.numpy(), b), k


def test_k6_emulation_takes_the_first_minimum_and_the_cap():
    """Ties and a check of weight 1: a row weight of 1 takes the 1e30 cap,
    tied magnitudes give every slot the tied value, as in ``_bp_rows``."""
    proto = [[(0,), (1,)], [(0,), ()]]
    g = LiftedGraph(proto, 3, device="cpu")
    synd = torch.tensor([[1, 0, 1, 0, 0, 1], [0, 0, 0, 0, 0, 0]], dtype=torch.uint8)
    llr0 = torch.full((2, g.n), 2.0)
    llr0[0, :3] = -2.0
    for method in ("minimum_sum", "product_sum"):
        _equal(k6_emulation(g, synd, llr0, method, 6, 0.625),
               _bp_rows(g, synd, llr0, method, 6, 0.625))


# ---- (c) shared memory and route -----------------------------------------

@pytest.mark.parametrize("lift,route", [(8, "shared"), (60, "shared"), (100, "shared"),
                                        (400, "shared"), (942, "shared"), (943, "device"),
                                        (1000, "device")])
def test_k6_shared_memory_mirror_and_route(lift, route):
    """``4 (4 np depth + 2 mp wr + mp + np + 1)`` bytes of tables (the edges
    as four words, the slots as two, the degrees of block rows and variable
    blocks, the row slot) and, on the shared route, the row's state: ``3 m +
    n`` words for min-sum (each check's compressed message and the totals),
    ``m wr + n`` for product-sum.  The shared route while that fits 232,448
    bytes: min-sum to lift 942 of this protograph, product-sum to lift 527.
    The [[10000,420]] code (lift 400) needs 97,600 bytes of min-sum state
    (100,024 with the tables, against the first design's 176,324), so two
    rows fit an SM.  The graph is the lifted product's ``hx_proto`` (its
    lift-8 exponents: the sizes depend on the protograph's shape and the
    lift alone)."""
    g = LiftedGraph(lifted_hgp(PROTO, lift=8).hx_proto, lift, device="cpu")
    mp, np_, wr, depth = g.mp, g.np_, g.wr, g.depth
    assert (mp, np_, wr, depth) == (12, 25, 7, 4)
    tables = 4 * np_ * depth + 2 * mp * wr + mp + np_ + 1
    assert k6.bp_lifted_table_words(mp, np_, wr, depth) == tables
    for product_sum, state in ((False, 3 * g.m + g.n), (True, g.m * wr + g.n)):
        assert k6.bp_lifted_state_words(mp, np_, lift, wr, product_sum) == state
        assert (k6.bp_lifted_smem_bytes(mp, np_, lift, wr, depth, product_sum, False)
                == 4 * (tables + state))
        assert k6.bp_lifted_smem_bytes(mp, np_, lift, wr, depth, product_sum, True) == 4 * tables
        want = "shared" if 4 * (tables + state) <= _SMEM_LIMIT else "device"
        assert k6.k6_route(g, product_sum) == want
        assert (want == "shared") == (lift <= (527 if product_sum else 942))
    assert k6.k6_route(g) == route
    if lift == 400:
        assert 4 * (3 * g.m + g.n) == 97_600 and 4 * (tables + 3 * g.m + g.n) == 100_024
    if lift == 1000:
        assert 4 * (3 * g.m + g.n) == 244_000
    k6._FORCE_DEVICE_ROUTE = True
    try:
        assert k6.k6_route(g) == "device" and k6.k6_route(g, True) == "device"
    finally:
        k6._FORCE_DEVICE_ROUTE = False


# ---- (d) the wrapper's input checks ----------------------------------------

def test_bp_lifted_refuses_other_devices_dtypes_and_shapes():
    g = LiftedGraph(MULTI, 6, device="cpu")
    B, m, n = 4, g.m, g.n
    synd = torch.zeros(B, m, dtype=torch.uint8)
    llr0 = torch.ones(B, n)
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA"):
            k6.bp_lifted(g, synd.to(dev), llr0.to(dev), "minimum_sum", 5, 0.625)
    bad = [(synd.float(), llr0, "synd"), (synd.to(torch.int32), llr0, "synd"),
           (synd[:, :-1], llr0, "synd"), (synd[0], llr0, "synd"),
           (synd, llr0.double(), "llr0"), (synd, llr0[:, :-1], "llr0"),
           (synd, llr0[:-1], "llr0"), (synd, llr0.to("meta"), "llr0")]
    for s, l, what in bad:
        with pytest.raises(ValueError, match=what):
            k6.bp_lifted(g, s, l, "minimum_sum", 5, 0.625)
    with pytest.raises(ValueError, match="bp_method"):
        k6.bp_lifted(g, synd, llr0, "bogus", 5, 0.625)
    with pytest.raises(ValueError, match="bp_method"):
        k6.bp_lifted(g, synd, llr0, "ms", 5, 0.625)  # the decoder normalises the name
    with pytest.raises(ValueError, match="max_iter"):
        k6.bp_lifted(g, synd, llr0, "minimum_sum", 0, 0.625)  # 0 means n in the decoder
    with pytest.raises(ValueError, match="max_iter"):
        k6.bp_lifted(g, synd, llr0, "minimum_sum", -1, 0.625)
