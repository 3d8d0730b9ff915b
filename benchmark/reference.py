"""The plain reference that decides a run's ``correct``.

A frozen copy, in plain torch, of the decode that ``BpOsdDecoder`` runs:
flooding min-sum BP (fixed or adaptive scaling ``1 - 2^-t``), the
shift-routed lifted BP of a protograph lift, and osd_cs (Gauss-Jordan
elimination in reliability order, then the zero, weight-1 and weight-2
candidates).  It imports nothing of the program: it builds its own tables
from the parity-check matrix the benchmark made, and its own prior from the
error rate.  Each function reads its options from the configuration's whole
``decoder`` entry; :func:`supports` says which entries it computes (min-sum,
the parallel schedule, osd_cs at any order) and refuses the others, so a
configuration that needs more brings a copy of its own
(``references/<name>.py``, :mod:`.spec`).

Rounding is the program's: float32 messages, a variable's incoming messages
added in the order the program adds them (four lanes by flat edge ``e % 4``,
``(p0 + p1) + (p2 + p3)``, for flooding BP; block row outer, slot inner for
lifted BP), the 1e30 cap of an exclusive minimum, first-minimum ties.  So a
sound program agrees bit for bit.  ``dtype=torch.bfloat16`` computes the same
BP with bfloat16 messages: the control, which must come out not correct.

Three departures from the program's plain versions change no result: the
elimination XORs only the columns from the pivot column on (the columns
before it never hold a bit in an unused row, so their hits are always zero);
it runs through every column instead of stopping at rank(H) pivots (after
them no column has a bit in an unused row), so it never waits for the host
and needs no rank beforehand; and it takes a pivot row's bit as the lowest
set bit of its word (``w & -w``), its index read once at the end.  The elimination also
counts the work it needs (:class:`ElimCount`), for the benchmark's roofline
shares.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_BIG = 1e30  # min-sum magnitude cap; pad value of an exclusive minimum
_MSG_FLOATS = 1 << 26  # message floats of one BP call's [rows, m * wr] tensor
_OSD_WORDS = 1 << 27  # int32 words of one OSD call's [rows, n + 1, Wm] matrix


# the method names the program takes, as the program normalises them
NAMES = {
    "bp_method": dict.fromkeys(("minimum_sum", "min_sum", "ms", "minimum_sum_log", "1"),
                               "minimum_sum")
    | dict.fromkeys(("product_sum", "prod_sum", "ps", "product_sum_log", "0"), "product_sum"),
    "schedule": {"parallel": "parallel", "serial": "layered", "layered": "layered"},
    "osd_method": dict.fromkeys(("osd0", "osd_0", "zero"), "osd0")
    | dict.fromkeys(("osd_e", "osde", "exhaustive"), "osd_e")
    | dict.fromkeys(("osd_cs", "osdcs", "combination_sweep"), "osd_cs"),
}
COMPUTES = {"bp_method": "minimum_sum", "schedule": "parallel", "osd_method": "osd_cs"}
NUMBERS = ("max_iter", "ms_scaling_factor", "osd_order")


def supports(decoder: dict) -> str | None:
    """``None`` where this reference computes the decode that ``decoder``
    (a configuration's ``decoder`` entry) states, else the reason it cannot:
    an option it does not compute, or one that the decoder leaves out
    (``schedule`` alone may be left out, and is then parallel)."""
    extra = sorted(set(decoder) - set(NAMES) - set(NUMBERS))
    if extra:
        return f"it computes no decoder option {extra}"
    for key, names in NAMES.items():
        given = decoder.get(key, "parallel" if key == "schedule" else None)
        if given is None:
            return f"the decoder states no {key}"
        if names.get(str(given).lower()) != COMPUTES[key]:
            return f"{key} {given!r}: it computes {COMPUTES[key]} alone"
    missing = [k for k in NUMBERS if k not in decoder]
    if missing:
        return f"the decoder states no {missing}"
    return None


def _bp_options(decoder: dict, n: int) -> tuple[int, float]:
    """``(max_iter, scale)`` of ``decoder``: ``max_iter`` 0 is ``n``, scale 0
    is adaptive."""
    return int(decoder["max_iter"]) or n, float(decoder["ms_scaling_factor"])


def prior(p: float, n: int) -> torch.Tensor:
    """The channel's prior log-likelihood ratio ``[n]`` float32, on the CPU:
    ``log1p(-p) - log(p)`` with ``p`` clamped to ``[1e-30, 1 - 1e-7]``."""
    q = torch.clamp(torch.full((n,), float(p), dtype=torch.float32), 1e-30, 1.0 - 1e-7)
    return torch.log1p(-q) - torch.log(q)


def alpha(scale: float, it: int) -> float:
    """The float32 min-sum factor of iteration ``it``; 0 is adaptive."""
    if scale == 0.0:
        return float(np.float32(1.0 - 2.0 ** -it))
    return float(np.float32(scale))


# ---- graphs -------------------------------------------------------------------

class FloodGraph:
    """Tables of flooding BP and of OSD for a parity-check matrix ``H``."""

    def __init__(self, H: np.ndarray, device):
        H = np.asarray(H, np.uint8)
        m, n = H.shape
        self.m, self.n, self.device = m, n, torch.device(device)
        rows, cols = np.nonzero(H)  # row-major: sorted by (row, col)
        row_counts = np.bincount(rows, minlength=m)
        col_counts = np.bincount(cols, minlength=n)
        self.wr, self.wc = int(row_counts.max()), int(col_counts.max())
        slot = np.concatenate([np.arange(c) for c in row_counts])
        chk_var = np.full((m, self.wr), n, np.int64)
        chk_var[rows, slot] = cols
        edge = rows * self.wr + slot
        order = np.lexsort((rows, cols))
        vslot = np.concatenate([np.arange(c) for c in col_counts])
        var_edge = np.full((n, self.wc), m * self.wr, np.int64)
        var_edge[cols[order], vslot] = edge[order]
        self.chk_var = torch.from_numpy(chk_var).to(self.device)
        self.chk_mask = self.chk_var != n
        self.var_edge = var_edge
        self.H_cols = pack_columns(H, self.device)
        self._rank = self._lanes = None

    @property
    def Wm(self) -> int:
        return -(-self.m // 32)

    @property
    def lanes(self) -> list[torch.Tensor]:
        """Each lane's edges of every variable, ascending, padded with the
        zero column ``m * wr``: ``[n * depth]`` gather indices."""
        if self._lanes is None:
            pad = self.m * self.wr
            self._lanes = []
            for k in range(4):
                sel = [[e for e in r if e != pad and e % 4 == k] for r in self.var_edge]
                depth = max(1, max(len(r) for r in sel))
                idx = np.full((self.n, depth), pad, np.int64)
                for v, r in enumerate(sel):
                    idx[v, : len(r)] = r
                self._lanes.append(torch.from_numpy(idx.reshape(-1)).to(self.device))
        return self._lanes

    @property
    def rank(self) -> int:
        """GF(2) rank of H: the pivots of an elimination (an OSD call's, or
        one in column order)."""
        if self._rank is None:
            cols = torch.cat([self.H_cols, torch.zeros_like(self.H_cols[:1])])[None].clone()
            self._rank = int((eliminate(cols)[0] >= 0).sum())
        return self._rank


class LiftedGraph:
    """Routing tables of the lift of ``proto`` by ``L``: ``chk_var [m * wr]``
    (edge -> variable, pad ``n``) and ``var_edge [n * depth]`` (variable ->
    its edges, block row outer and slot inner, pad ``m * wr``), each column
    a cyclic shift of one ``L`` block."""

    def __init__(self, proto, L: int, device):
        self.L = L = int(L)
        self.mp, self.np_ = len(proto), len(proto[0])
        self.m, self.n = self.mp * L, self.np_ * L
        self.device = torch.device(device)
        edges = [[(J, int(e) % L) for J, exps in enumerate(row) for e in exps]
                 for row in proto]
        self.wr = max(len(e) for e in edges)
        m, n, wr = self.m, self.n, self.wr
        ar = torch.arange(L)
        chk_var = torch.full((self.mp, L, wr), n, dtype=torch.int64)
        mask = torch.zeros(self.mp, wr, dtype=torch.bool)
        into = [[] for _ in range(self.np_)]
        for I, row in enumerate(edges):
            for s, (J, e) in enumerate(row):
                chk_var[I, :, s] = J * L + torch.roll(ar, -e)
                into[J].append((I * L + torch.roll(ar, e)) * wr + s)
                mask[I, s] = True
        self.depth = max(len(c) for c in into)
        var_edge = torch.full((self.np_, L, self.depth), m * wr, dtype=torch.int64)
        for J, cs in enumerate(into):
            for d, c in enumerate(cs):
                var_edge[J, :, d] = c
        self.chk_var = chk_var.reshape(m * wr).to(self.device)
        self.var_edge = var_edge.reshape(n * self.depth).to(self.device)
        self.edge_mask = mask[:, None, :].expand(self.mp, L, wr).reshape(m, wr).to(self.device)


# ---- BP -----------------------------------------------------------------------

class BP(NamedTuple):
    hard: torch.Tensor  # [B, n] uint8
    llr: torch.Tensor  # [B, n] the messages' dtype
    converged: torch.Tensor  # [B] bool
    iterations: torch.Tensor  # [B] int32


def _check_update(v2c, mask, syn, a: float):
    """Scaled min-sum c2v of ``v2c [B, m, wr]``, zero on pad slots: sign
    product with the syndrome, exclusive minimum by prefix and suffix scans
    seeded with the cap."""
    neg = (v2c < 0.0) & mask
    parity = (neg.sum(-1, dtype=torch.int32) + syn) & 1
    mags = v2c.abs().masked_fill(~mask, _BIG).unbind(-1)
    wr = len(mags)
    big = torch.full_like(mags[0], _BIG)
    fwd = [big]
    for s in range(1, wr):
        fwd.append(torch.minimum(fwd[-1], mags[s - 1]))
    bwd = [big]
    for s in range(wr - 2, -1, -1):
        bwd.append(torch.minimum(bwd[-1], mags[s + 1]))
    bwd.reverse()
    excl = torch.stack([torch.minimum(f, b) for f, b in zip(fwd, bwd)], -1)
    out_neg = (parity[..., None] != 0) ^ neg
    scale = torch.where(mask, torch.where(out_neg, -a, a), 0.0).to(v2c.dtype)
    return scale * excl


def _freeze(state, it, max_iter, ok, h, total):
    """Freeze the rows that converged (or all, at ``max_iter``); returns the
    rows kept."""
    hard, llr, conv, iters, active = state
    done = ok if it < max_iter else torch.ones_like(ok)
    if not bool(done.any()):
        return None
    idx = active[done]
    hard[idx] = h[done]
    llr[idx] = total[done]
    conv[idx] = ok[done]
    iters[idx] = it
    return ~done


def flood_bp(g: FloodGraph, synd: torch.Tensor, llr0: torch.Tensor, decoder: dict,
             dtype=torch.float32) -> BP:
    """Flooding min-sum BP of ``synd [B, m]`` uint8 from the prior row
    ``llr0 [n]`` at ``decoder``'s options; rows freeze at first convergence,
    a row that never converges runs ``max_iter`` iterations."""
    max_iter, scale = _bp_options(decoder, g.n)
    parts = []
    rows = max(1, _MSG_FLOATS // (g.m * g.wr))
    for lo in range(0, synd.shape[0], rows):
        parts.append(_flood_rows(g, synd[lo : lo + rows], llr0, max_iter, scale, dtype))
    return BP(*(torch.cat(x) for x in zip(*parts)))


def _flood_rows(g, synd, llr0, max_iter, scale, dtype):
    dev = g.device
    B, n, m, wr = synd.shape[0], g.n, g.m, g.wr
    E = m * wr
    mask = g.chk_mask
    zcol = torch.zeros(B, 1, dtype=dtype, device=dev)
    flat = g.chk_var.reshape(-1)

    def to_edges(x, zc):
        return torch.cat([x, zc], 1).index_select(1, flat).view(-1, m, wr)

    l0 = llr0.to(device=dev, dtype=dtype).expand(B, n)
    v2c = torch.where(mask, to_edges(l0, zcol), 0.0).to(dtype)
    hard = torch.zeros(B, n, dtype=torch.uint8, device=dev)
    llr = l0.clone()
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.arange(B, device=dev)
    syn = synd.to(device=dev, dtype=torch.int32)
    for it in range(1, max_iter + 1):
        Ba = active.numel()
        if Ba == 0:
            break
        c2v = _check_update(v2c, mask, syn, alpha(scale, it))
        zc = zcol[:Ba]
        c2v_flat = torch.cat([c2v.reshape(Ba, E), zc], 1)
        lanes = []
        for idx in g.lanes:
            gl = c2v_flat.index_select(1, idx).view(Ba, n, -1)
            acc = gl[..., 0]
            for d in range(1, gl.shape[-1]):
                acc = acc + gl[..., d]
            lanes.append(acc)
        total = l0[:Ba] + ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
        v2c = torch.where(mask, to_edges(total, zc) - c2v, 0.0).to(dtype)
        h = (total <= 0).to(torch.uint8)
        parity = to_edges(h, zc.to(torch.uint8)).sum(-1, dtype=torch.int32) & 1
        ok = (parity == syn).all(-1)
        keep = _freeze((hard, llr, conv, iters, active), it, max_iter, ok, h, total)
        if keep is not None:
            active, v2c, syn = active[keep], v2c[keep], syn[keep]
    return hard, llr, conv, iters


def lifted_bp(g: LiftedGraph, synd: torch.Tensor, llr0: torch.Tensor, decoder: dict,
              dtype=torch.float32) -> BP:
    """Shift-routed min-sum BP of a protograph lift; the same contract as
    :func:`flood_bp`, a variable's messages added block row outer, slot
    inner, from zeros."""
    max_iter, scale = _bp_options(decoder, g.n)
    parts = []
    rows = max(1, _MSG_FLOATS // (g.m * g.wr))
    for lo in range(0, synd.shape[0], rows):
        parts.append(_lifted_rows(g, synd[lo : lo + rows], llr0, max_iter, scale, dtype))
    return BP(*(torch.cat(x) for x in zip(*parts)))


def _lifted_rows(g, synd, llr0, max_iter, scale, dtype):
    dev = g.device
    B, n, m, wr = synd.shape[0], g.n, g.m, g.wr
    E = m * wr
    mask = g.edge_mask
    zcol = torch.zeros(B, 1, dtype=dtype, device=dev)

    def to_edges(x, zc):
        return torch.cat([x, zc], 1).index_select(1, g.chk_var).view(-1, m, wr)

    l0 = llr0.to(device=dev, dtype=dtype).expand(B, n)
    v2c = torch.where(mask, to_edges(l0, zcol), 0.0).to(dtype)
    hard = torch.zeros(B, n, dtype=torch.uint8, device=dev)
    llr = l0.clone()
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    active = torch.arange(B, device=dev)
    syn = synd.to(device=dev, dtype=torch.int32)
    for it in range(1, max_iter + 1):
        Ba = active.numel()
        if Ba == 0:
            break
        c2v = _check_update(v2c, mask, syn, alpha(scale, it))
        zc = zcol[:Ba]
        inc = torch.cat([c2v.reshape(Ba, E), zc], 1).index_select(1, g.var_edge)
        inc = inc.view(Ba, n, g.depth)
        acc = torch.zeros(Ba, n, dtype=dtype, device=dev)
        for d in range(g.depth):
            acc = acc + inc[..., d]
        total = l0[:Ba] + acc
        v2c = torch.where(mask, to_edges(total, zc) - c2v, 0.0).to(dtype)
        h = (total <= 0).to(torch.uint8)
        parity = to_edges(h, zc.to(torch.uint8)).sum(-1, dtype=torch.int32) & 1
        ok = (parity == syn).all(-1)
        keep = _freeze((hard, llr, conv, iters, active), it, max_iter, ok, h, total)
        if keep is not None:
            active, v2c, syn = active[keep], v2c[keep], syn[keep]
    return hard, llr, conv, iters


# ---- GF(2) words ----------------------------------------------------------------

def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of each int32 word read as uint32, int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``[..., m]`` 0/1 -> ``[..., ceil(m/32)]`` int32, bit ``i % 32`` of word ``i // 32``."""
    m = bits.shape[-1]
    Wm = -(-m // 32)
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, Wm * 32 - m))
    b = b.view(*bits.shape[:-1], Wm, 32)
    return _wrap_i32((b << torch.arange(32, device=bits.device)).sum(-1))


def pack_columns(H: np.ndarray, device) -> torch.Tensor:
    """H's columns packed: ``[n, ceil(m/32)]`` int32."""
    return pack_bits(torch.from_numpy(np.ascontiguousarray(H.T)).to(device))


def _bit_at(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return (words.gather(1, pos >> 5) >> (pos & 31)) & 1


# ---- OSD ----------------------------------------------------------------------

class ElimCount(NamedTuple):
    """The elimination's work on each row: ``steps`` columns taken until the
    row's last pivot, ``pivot_tests`` the columns after each pivot column
    (syndrome included), ``xor_words`` the nonzero words of the pivot row's
    mask XORed into the columns after it that carry the pivot row."""

    steps: torch.Tensor
    pivot_tests: torch.Tensor
    xor_words: torch.Tensor

    def ops(self, Wm: int) -> torch.Tensor:
        """The integer operations the elimination needs: at every step the
        pivot search (an AND-NOT and a test of each of the column's ``Wm``
        words), at a pivot step the hit tests (2 each) and the XORs."""
        return 2 * Wm * self.steps + 2 * self.pivot_tests + self.xor_words


def eliminate(cols: torch.Tensor):
    """Gauss-Jordan over ``cols [B, n + 1, Wm]`` in column order, in place,
    through every column: once a row has rank(H) pivots, its unused rows are
    zero in every later column and it finds no more.  Returns ``prow [B, n]``
    (the pivot row of column t, or -1) and the :class:`ElimCount`."""
    B, n1, Wm = cols.shape
    n, dev = n1 - 1, cols.device
    used = torch.zeros(B, Wm, dtype=torch.int32, device=dev)
    ar = torch.arange(B, device=dev)
    word_ids = torch.arange(Wm, device=dev)
    xor_words = torch.zeros(B, dtype=torch.int64, device=dev)
    words, lows = [], []
    for t in range(n):
        ct = cols[:, t, :]
        nz = (ct & ~used) != 0
        w = nz.to(torch.int32).argmax(1)  # first word with an unused row
        word = ct[ar, w] & ~used[ar, w]
        low = word & -word  # the pivot row's bit; 0 when the column has none
        pmask = torch.where(word_ids[None, :] == w[:, None], low[:, None], 0)
        S = ct & ~pmask
        rest = cols[:, t:, :]
        sel = (rest.gather(2, w[:, None, None].expand(B, n1 - t, 1)).squeeze(2)
               & low[:, None]) != 0
        xor_words += sel[:, 1:].sum(1) * (S != 0).sum(1)
        rest ^= torch.where(sel[:, :, None], S[:, None, :], 0)
        used |= pmask
        words.append(w)
        lows.append(low)
    low = torch.stack(lows, 1)
    piv = low != 0
    bit = popcount32(low - 1)  # trailing zeros of a one-bit word
    prow = torch.where(piv, torch.stack(words, 1).to(torch.int64) * 32 + bit, -1)
    t = torch.arange(n, device=dev)
    steps = torch.where(piv, t + 1, 0).amax(1)
    tests = torch.where(piv, n - t, 0).sum(1)
    return prow, ElimCount(steps, tests, xor_words)


def pair_indices(lam: int) -> torch.Tensor:
    """The lexicographic pairs ``i < j`` of the first ``lam`` T positions."""
    idx = [(i, j) for i in range(lam) for j in range(i + 1, lam)]
    return torch.tensor(idx, dtype=torch.int64).reshape(-1, 2)


def _search_cs(s, tcols, pairs):
    """The winner of the zero, weight-1 and weight-2 candidates: two T slots,
    -1 where unused; the first minimum wins."""
    k = tcols.shape[1]
    w0 = popcount32(s).sum(-1)
    w1 = popcount32(s[:, None, :] ^ tcols).sum(-1) + 1
    parts = [w0[:, None], w1]
    if pairs is not None:
        pa, pb = pairs[:, 0], pairs[:, 1]
        parts.append(popcount32(s[:, None, :] ^ tcols[:, pa] ^ tcols[:, pb]).sum(-1) + 2)
    best = torch.cat(parts, 1).argmin(1)
    minus1 = torch.full_like(best, -1)
    slot1 = torch.where((best >= 1) & (best <= k), best - 1, minus1)
    slot2 = minus1
    if pairs is not None:
        q = (best - 1 - k).clamp(min=0)
        in_w2 = best > k
        slot1 = torch.where(in_w2, pa[q], slot1)
        slot2 = torch.where(in_w2, pb[q], slot2)
    return slot1, slot2


class OSD(NamedTuple):
    osd0: torch.Tensor  # [B, n] uint8
    osdw: torch.Tensor  # [B, n] uint8
    elim_ops: torch.Tensor  # [B] int64: the elimination's needed integer operations


def osd_cs(g: FloodGraph, synd: torch.Tensor, llr: torch.Tensor, decoder: dict) -> OSD:
    """osd_cs at ``decoder``'s ``osd_order`` of ``synd [B, m]`` with BP's
    posterior ``llr [B, n]``: columns ranked by ``argsort(llr, stable=True)``,
    osd0 read off at the pivots, then the best of the zero pattern, weight 1
    on every T column and weight 2 on the pairs of the first
    ``min(order, |T|)``."""
    order = int(decoder["osd_order"])
    n1, Wm = g.n + 1, g.Wm
    rows = max(1, _OSD_WORDS // (n1 * Wm))
    parts = [_osd_rows(g, synd[lo : lo + rows], llr[lo : lo + rows], order)
             for lo in range(0, synd.shape[0], rows)]
    if not parts:
        z = torch.zeros(0, g.n, dtype=torch.uint8, device=g.device)
        return OSD(z, z.clone(), torch.zeros(0, dtype=torch.int64, device=g.device))
    return OSD(*(torch.cat(x) for x in zip(*parts)))


def _osd_rows(g, synd, llr, order):
    dev = g.device
    n = g.n
    perm = torch.argsort(llr.to(dev), dim=1, stable=True)
    synd = synd.to(dev)
    cols = torch.cat([g.H_cols[perm], pack_bits(synd)[:, None, :]], 1)
    prow, work = eliminate(cols)
    s = cols[:, n, :]
    is_piv = prow >= 0
    if g._rank is None:
        g._rank = int(is_piv.sum(1).max())
    r = g._rank
    e0p = ewp = _bit_at(s, prow.clamp(min=0)) * is_piv
    k, lam = n - r, min(int(order), n - r)
    if lam > 0:
        tpos = torch.argsort(is_piv.to(torch.int32), dim=1, stable=True)[:, :k]
        tcols = cols.gather(1, tpos[:, :, None].expand(-1, -1, cols.shape[2]))
        chosen = torch.zeros_like(tpos)
        pairs = pair_indices(lam).to(dev) if lam >= 2 else None
        for sl in _search_cs(s, tcols, pairs):
            hit = sl >= 0
            chosen[hit, sl[hit]] = 1
        xor = torch.zeros_like(s)
        for j in torch.nonzero(chosen.any(0)).flatten().tolist():
            xor ^= tcols[:, j, :] & -chosen[:, j, None].to(torch.int32)
        piv_best = _bit_at(s ^ xor, prow.clamp(min=0)) * is_piv
        ewp = piv_best | torch.zeros_like(prow).scatter_(1, tpos, chosen)
    zero = torch.zeros(perm.shape, dtype=torch.uint8, device=dev)
    e0 = zero.scatter(1, perm, e0p.to(torch.uint8))
    ew = zero.scatter(1, perm, ewp.to(torch.uint8))
    return e0, ew, work.ops(g.Wm)


def syndromes_of(g: FloodGraph, x: torch.Tensor) -> torch.Tensor:
    """``H x mod 2 [B, m]`` uint8 of ``x [B, n]`` 0/1, on ``g``'s tables."""
    dev = g.device
    zc = torch.zeros(x.shape[0], 1, dtype=torch.int32, device=dev)
    bits = torch.cat([x.to(device=dev, dtype=torch.int32), zc], 1)
    bits = bits.index_select(1, g.chk_var.reshape(-1)).view(-1, g.m, g.wr)
    return (bits.sum(-1) & 1).to(torch.uint8)
