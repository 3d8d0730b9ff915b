"""Kernel K6's iteration order (``csrc/bp_lifted.cu``) on the CPU: a torch
emulation that carries between iterations only what the kernel keeps, each
check's compressed min-sum message ``(m1a, m2a, sg)`` (product-sum: its c2v
row) and the totals, routed by ``slot_table``/``block_edges``, in K1's
two-barrier order: the check update of iteration t + 1 reads ``tot_t``,
takes the stop parity of iteration t on the way and forms ``v2c_t = tot_t -
c2v_t`` from the check's own message; a row that passed at t, or reached
``max_iter``, emits ``tot_t`` and drops the new message.  It is held to the
plain version ``_bp_rows`` bit for bit and to the JAX package's
``bp_decode_lifted``.  Also the team-size rule of K6's launch plan
(``ops/cuda_lifted_bp.py:k6_threads``).  The card's side is
``tests/test_torch_kernels.py`` (marked ``gpu``) and ``chip_smoke.py`` phase
21."""

import jax
import numpy as np
import pytest
import torch

from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.decoder.lifted_bp import bp_decode_lifted as jbp_decode_lifted

from bp_osd_tpu_torch.codes import lifted_hgp
from bp_osd_tpu_torch.decoder.bp import _alpha, _elementwise, normalize_bp_method
from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, _bp_rows
import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6

torch.set_num_threads(1)

# tests/test_torch_lifted.py's protographs
PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]
MULTI = [[(0, 1), (2,), ()], [(3,), (0, 4), (1,)]]
_BIG = 1e30
_TANH_CLIP = 1.0 - 1e-7
_I1_SHIFT = 27  # bp_check.cuh: sign bits 0..26, the first-minimum slot above


def k6_fused(g: LiftedGraph, synd, llr0, method: str, max_iter: int, msf: float):
    """K6's decode in its own order; returns ``(hard, llr, converged,
    iterations)`` and the tensors carried from one iteration to the next
    (``{name: [B, ...]}``)."""
    L, mp, np_ = g.L, g.mp, g.np_
    B, n = synd.shape[0], g.n
    ms = method == "minimum_sum"
    slots, blocks = g.slot_table.long(), g.block_edges.long()
    deg = (slots[..., 0] >= 0).sum(1)
    ll = torch.arange(L)
    syn = synd.long().view(B, mp, L)

    def var_ix(I, s):  # [L] variables of block row I's slot s
        J, e = slots[I, s]
        return J * L + (ll + e) % L

    def c2v_of(state, I, s):  # [B, L] c2v of block row I's slot s
        if not ms:
            return state["c2v"][:, I, :, s]
        w = state["sg"][:, I]
        mag = torch.where((w >> _I1_SHIFT) == s, state["m2a"][:, I], state["m1a"][:, I])
        return torch.where((w >> s) & 1 == 1, -mag, mag)

    def check(state, tot, it):
        """The check update of iteration ``it`` from ``tot_{it-1}`` and the
        state (``tot`` None: from v2c_0 = llr0); returns the new state and
        each row's parity failure of iteration ``it - 1``."""
        if ms:
            new = {k: torch.zeros(B, mp, L) for k in ("m1a", "m2a")}
            new["sg"] = torch.zeros(B, mp, L, dtype=torch.long)
        else:
            new = {"c2v": torch.zeros(B, mp, L, g.wr)}
        fail = torch.zeros(B, dtype=torch.bool)
        for I in range(mp):
            dc = int(deg[I])
            hp = syn[:, I].clone()
            xs = []
            for s in range(dc):
                v = var_ix(I, s)
                if tot is None:
                    xs.append(llr0[:, v])
                else:
                    hp ^= (tot[:, v] <= 0).long()
                    xs.append(tot[:, v] - c2v_of(state, I, s))
            fail |= (hp != 0).any(1)
            if ms:
                m1 = torch.full((B, L), _BIG)
                m2 = torch.full((B, L), _BIG)
                i1 = torch.full((B, L), 31, dtype=torch.long)
                neg = torch.zeros(B, L, dtype=torch.long)
                for s, x in enumerate(xs):
                    neg |= (x < 0).long() << s
                    mag = x.abs()
                    i1 = torch.where(mag < m1, s, i1)
                    m2 = torch.minimum(m2, torch.maximum(m1, mag))
                    m1 = torch.minimum(m1, mag)
                alpha = _alpha(msf, it)
                negs = sum(((neg >> s) & 1) for s in range(dc))
                flip = ((syn[:, I] + negs) & 1) * ((1 << dc) - 1)
                new["m1a"][:, I], new["m2a"][:, I] = m1 * alpha, m2 * alpha
                new["sg"][:, I] = (neg ^ flip) | (i1 << _I1_SHIFT)
            else:
                t = _elementwise(torch.tanh, 0.5 * torch.stack(xs, -1))
                sgn = 1.0 - 2.0 * syn[:, I].float()
                fwd = [torch.ones(B, L)]
                for s in range(dc - 1):
                    fwd.append(fwd[-1] * t[..., s])
                bwd = torch.ones(B, L)
                for s in range(dc - 1, -1, -1):
                    y = torch.clamp(sgn * fwd[s] * bwd, -_TANH_CLIP, _TANH_CLIP)
                    new["c2v"][:, I, :, s] = 2.0 * _elementwise(torch.atanh, y)
                    bwd = bwd * t[..., s]
        return new, fail

    def totals(state):  # llr0 + the c2v sum from +0.0 over each block's edges
        tot = torch.empty(B, n)
        for J in range(np_):
            acc = torch.zeros(B, L)
            for I, s, e in blocks[J].tolist():
                if I < 0:
                    break
                acc = acc + c2v_of(state, I, s)[:, (ll - e) % L]
            tot[:, J * L:(J + 1) * L] = llr0[:, J * L:(J + 1) * L] + acc
        return tot

    out_hard = torch.zeros(B, n, dtype=torch.uint8)
    out_llr = llr0.clone()
    out_conv = torch.zeros(B, dtype=torch.bool)
    out_it = torch.zeros(B, dtype=torch.int32)
    state, _ = check(None, None, 1)
    tot = totals(state)
    live = torch.ones(B, dtype=torch.bool)
    for it in range(1, max_iter + 1):
        nxt, fail = check(state, tot, it + 1)  # the parity of it, q_{it+1}
        ok = ~fail
        stop = live & (ok | (it == max_iter))
        out_hard[stop], out_llr[stop] = (tot[stop] <= 0).to(torch.uint8), tot[stop]
        out_conv[stop], out_it[stop] = ok[stop], it
        live &= ~stop
        if not bool(live.any()):
            break
        state = nxt
        tot = totals(state)
    return (out_hard, out_llr, out_conv, out_it), {**state, "tot": tot}


def _case(proto, lift, B, p, seed):
    """The lifted product of ``proto`` at ``lift`` (its ``hx_proto``) and
    ``B`` syndromes of errors of rate ``p``, with the prior."""
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


RULES = [("minimum_sum", 0.625), ("minimum_sum", 0.0), ("product_sum", 1.0)]


@pytest.mark.parametrize("proto,lift", [(PROTO, 8), (MULTI, 6)])
@pytest.mark.parametrize("bp_method,msf", RULES)
def test_fused_order_equals_plain_and_jax(proto, lift, bp_method, msf):
    """The two-barrier order equals ``_bp_rows`` bit for bit (llr as int32
    bits) and JAX's ``bp_decode_lifted`` under ``jax.jit``: min-sum bit for
    bit; product-sum with decisions equal and llr at the tolerance of
    ``tests/test_torch_lifted.py`` (rtol 0.02, atol 1e-3: one ulp of
    torch's tanh against XLA's, near the 1 - 1e-7 clip, becomes up to ~2%
    of the llr through atanh).  Some rows converge early, some run to
    ``max_iter``."""
    hx_proto, synd, llr0 = _case(proto, lift, 12, 0.06, 5)
    g = LiftedGraph(hx_proto, lift, device="cpu")
    method = normalize_bp_method(bp_method)
    s_t, l_t = torch.as_tensor(synd), torch.as_tensor(llr0).expand(12, -1)
    got, _ = k6_fused(g, s_t, l_t, method, 25, msf)
    _equal(got, _bp_rows(g, s_t, l_t, method, 25, msf))
    assert 0 < int(got[2].sum()) < 12 and int(got[3].max()) == 25
    kw = dict(bp_method=bp_method, max_iter=25, ms_scaling_factor=msf)
    from bp_osd_tpu.decoder.lifted_bp import LiftedGraph as JLiftedGraph

    jg = JLiftedGraph(hx_proto, lift)
    ref = jax.jit(lambda s, l: jbp_decode_lifted(jg, s, l, **kw))(synd, llr0)
    for k, a in zip(("hard", "llr", "converged", "iterations"), got):
        b = np.asarray(getattr(ref, k))
        if k == "llr" and method == "product_sum":
            np.testing.assert_allclose(a.numpy(), b, rtol=0.02, atol=1e-3)
        else:
            assert np.array_equal(a.numpy(), b), k


@pytest.mark.parametrize("bp_method,msf", RULES)
def test_fused_order_carries_the_kernels_state(bp_method, msf):
    """Between iterations the emulation carries exactly the words a K6 row
    keeps: ``3 m + n`` for min-sum, ``m wr + n`` for product-sum
    (:func:`bp_lifted_state_words`), with rows of different iteration
    counts held to the plain version, a prior that differs by row
    included."""
    hx_proto, synd, llr0 = _case(PROTO, 8, 6, 0.05, 11)
    g = LiftedGraph(hx_proto, 8, device="cpu")
    method = normalize_bp_method(bp_method)
    s_t = torch.as_tensor(synd)
    l_t = torch.as_tensor(llr0)[None] * torch.linspace(0.8, 1.2, 6)[:, None]
    got, carried = k6_fused(g, s_t, l_t, method, 30, msf)
    _equal(got, _bp_rows(g, s_t, l_t, method, 30, msf))
    words = sum(t[0].numel() for t in carried.values())
    assert words == k6.bp_lifted_state_words(g.mp, g.np_, g.L, g.wr, method == "product_sum")


@pytest.mark.parametrize("bp_method", ["minimum_sum", "product_sum"])
def test_fused_order_first_minimum_ties_and_the_cap(bp_method):
    """Ties and a check of weight 1: tied magnitudes give every slot the
    tied value (the first minimum over ascending slots), a block row of
    weight 1 takes the 1e30 cap, as in ``_bp_rows``."""
    proto = [[(0,), (1,)], [(0,), ()]]
    g = LiftedGraph(proto, 3, device="cpu")
    assert [int(d) for d in (g.slot_table[..., 0] >= 0).sum(1)] == [2, 1]
    synd = torch.tensor([[1, 0, 1, 0, 0, 1], [0, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1]],
                        dtype=torch.uint8)
    llr0 = torch.full((3, g.n), 2.0)
    llr0[0, :3] = -2.0
    for max_iter in (1, 2, 6):
        got, _ = k6_fused(g, synd, llr0, bp_method, max_iter, 0.625)
        _equal(got, _bp_rows(g, synd, llr0, bp_method, max_iter, 0.625))


@pytest.mark.parametrize("bp_method,msf", RULES)
def test_fused_order_zero_syndromes_converge_at_iteration_one(bp_method, msf):
    """Zero syndromes with a positive prior pass at iteration 1: the parity
    of tot_1 is taken in the check update of iteration 2, and the row
    stops there with ``iterations = 1``."""
    hx_proto, _, llr0 = _case(PROTO, 8, 1, 0.05, 0)
    g = LiftedGraph(hx_proto, 8, device="cpu")
    synd = torch.zeros(5, g.m, dtype=torch.uint8)
    l_t = torch.as_tensor(llr0).expand(5, -1)
    got, _ = k6_fused(g, synd, l_t, bp_method, 10, msf)
    _equal(got, _bp_rows(g, synd, l_t, bp_method, 10, msf))
    assert bool(got[2].all()) and bool((got[3] == 1).all())


@pytest.mark.parametrize("bp_method,msf", RULES)
@pytest.mark.parametrize("max_iter", [1, 2, 7])
def test_fused_order_rows_stop_at_max_iter(bp_method, msf, max_iter):
    """Uniform random syndromes never converge: every row stops at
    ``max_iter`` with the extra parity check's verdict (converged False) and
    ``tot_max_iter``, also at ``max_iter`` 1 (the first check update's
    totals)."""
    hx_proto, _, llr0 = _case(MULTI, 6, 1, 0.05, 0)
    g = LiftedGraph(hx_proto, 6, device="cpu")
    synd = torch.as_tensor(np.random.default_rng(max_iter).integers(0, 2, (4, g.m)),
                           dtype=torch.uint8)
    l_t = torch.as_tensor(llr0).expand(4, -1)
    got, _ = k6_fused(g, synd, l_t, bp_method, max_iter, msf)
    _equal(got, _bp_rows(g, synd, l_t, bp_method, max_iter, msf))
    assert not bool(got[2].any()) and bool((got[3] == max_iter).all())


# ---- the launch plan's team-size rule --------------------------------------

@pytest.mark.parametrize("rows,want", [
    ({128: 2, 256: 2, 512: 2, 1024: 1}, 1024),  # lift 400: 2 rows / 150 = 1 / 75, the larger team
    ({128: 2, 256: 2, 512: 2, 1024: 0}, 512),   # 2 / 150 > 2 / 295
    ({128: 1, 256: 1, 512: 1, 1024: 1}, 1024),  # one row an SM at any size: the least path
    ({128: 2, 256: 2, 512: 1, 1024: 0}, 256),   # 2 / 295 > 1 / 150
    ({1024: 1}, 1024),
])
def test_k6_threads_rule(rows, want):
    """Most rows an SM per path (``ceil(m/T) wr + ceil(n/T) depth``), ties
    to the larger team, at the [[10000,420]] code's shape."""
    assert k6.k6_threads(4800, 10000, 7, 4, rows) == want


def test_k6_threads_rule_limits():
    """No team that fits, or only teams whose threads would own more than 64
    checks, raises; small graphs take small teams."""
    with pytest.raises(ValueError, match="fits no team"):
        k6.k6_threads(4800, 10000, 7, 4, {T: 0 for T in k6.TEAM_SIZES})
    with pytest.raises(ValueError, match="fits no team"):
        k6.k6_threads(70_000, 140_000, 7, 4, {1024: 1})  # 69 checks a thread
    assert k6.k6_threads(96, 200, 7, 4, {128: 16, 256: 8, 512: 4, 1024: 2}) == 128
    # 4 rows / (2 * 4 + 4 * 2) = 2 rows / (1 * 4 + 2 * 2): the larger team
    assert k6.k6_threads(256, 512, 4, 2, {128: 4, 256: 2}) == 256


def test_k6_full_rows():
    """The slot loop runs unguarded when every block row has ``wr`` slots:
    so on the [[10000,420]] code's protograph (seven slots a row), not on
    one with rows of three and four slots."""
    g = LiftedGraph(lifted_hgp(PROTO, lift=8).hx_proto, 400, device="cpu")
    assert k6.full_rows(g) and g.wr == 7
    assert not k6.full_rows(LiftedGraph(MULTI, 6, device="cpu"))
    assert k6.full_rows(LiftedGraph(PROTO, 8, device="cpu"))
