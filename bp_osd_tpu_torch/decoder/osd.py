"""Batched ordered-statistics decoding (OSD) post-processing.

Port of ``bp_osd_tpu/decoder/osd.py``.  Per sample:

1. Rank the columns by BP soft output, ascending (most likely in error
   first): ``perm = argsort(llr, stable=True)``.
2. GF(2) Gauss-Jordan elimination visiting columns in ``perm`` order; the
   pivot of a column is the first unused row that carries it.  The matrix is
   kept column-major and bit-packed along rows: column ``t`` is
   ``H[:, perm[t]]`` as ``ceil(m/32)`` int32 words, and the syndrome rides
   along as column ``n``.  A row operation "add the pivot row to every row in
   S" is then, for each column holding the pivot row's bit, one XOR of the
   packed mask S.
3. osd0 reads the solution off the reduced syndrome at the pivot columns.
4. The search runs over T, the non-pivot columns in reliability order:
   ``osd_cs`` tries the zero pattern, weight 1 on every T column, then weight
   2 on the lexicographic pairs of the first ``lam = min(order, |T|)`` T
   columns; ``osd_e`` tries all ``2^lam`` patterns on the first ``lam`` T
   columns in counting order.  A candidate's weight is its pattern weight
   plus the weight of the residual syndrome; the first minimum wins.

Weights here count every row, the JAX package counts pivot rows: after full
elimination the other rows of every column are zero, so the two differ by
the same constant for every candidate and pick the same winner.

:func:`osd_decode_plain` is the plain torch version of kernels K2 and K3
(``csrc/osd_cs.cu``) and K5 (``csrc/osd_large.cu``); :func:`eliminate_plain`
that of kernel K4 (``csrc/osd_cs.cu``'s warp kernel, ``csrc/gf2_elim.cu``
for larger codes), with the JAX package's five elimination outputs, and
:func:`osd_after_elimination` the torch steps that follow K4 (osd0
read-off, T-column extraction, exhaustive search).
:func:`_osd_decode` alone picks by the tensors' device: on the card
:func:`osd_route` picks the kernel, elsewhere the plain versions run.
``osd_decode`` checks its ``backend`` against that device once.  Skipped rows
come back as zeros.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling
from .bp import as_f32, as_syndromes
from .tanner import TannerGraph, resolve_backend

__all__ = [
    "OSD_METHODS",
    "Elimination",
    "OsdConsts",
    "OsdResult",
    "build_osd_consts",
    "eliminate_plain",
    "normalize_osd_method",
    "osd_after_elimination",
    "osd_decode",
    "osd_decode_plain",
    "osd_route",
]

OSD_METHODS = {
    "osd0": "osd0",
    "osd_0": "osd0",
    "zero": "osd0",
    "osd_e": "osd_e",
    "osde": "osd_e",
    "exhaustive": "osd_e",
    "osd_cs": "osd_cs",
    "osdcs": "osd_cs",
    "combination_sweep": "osd_cs",
}

_MAX_OSD_E_ORDER = 16
_OSD_E_CHUNK_WORDS = 1 << 24  # bound on the [B, 2^lam, Wm] residual table


class OsdConsts(NamedTuple):
    """Host-built candidate-search tables (numpy), as in the JAX package."""

    patterns: object = None  # osd_e: [C, lam] uint8 bit patterns
    pattern_weights: object = None  # osd_e: [C] int32 popcounts
    pairs: object = None  # osd_cs: [C2, 2] int32 (i < j) index pairs


class OsdResult(NamedTuple):
    osd0: torch.Tensor  # [B, n] uint8
    osdw: torch.Tensor  # [B, n] uint8


class Elimination(NamedTuple):
    """The outputs of the JAX package's ``_eliminate``, zero on skipped rows."""

    h_work: torch.Tensor  # [B, m, W] int32 (uint32 bits): reduced H, row-packed
    s_work: torch.Tensor  # [B, m] int32: reduced syndrome
    pivot_ids: torch.Tensor  # [B, r] int32: original column of pivot i
    pivot_rows: torch.Tensor  # [B, r] int32: row holding pivot i
    pivot_mask: torch.Tensor  # [B, n] bool: sorted positions that made a pivot


def normalize_osd_method(osd_method) -> str:
    key = str(osd_method).lower()
    if key not in OSD_METHODS:
        raise ValueError(
            f"unknown osd_method {osd_method!r}; choose osd0/osd_e/osd_cs"
        )
    return OSD_METHODS[key]


def build_osd_consts(graph: TannerGraph, osd_method, osd_order: int) -> OsdConsts:
    """Precompute the candidate tables for a (method, order, graph) config."""
    method = normalize_osd_method(osd_method)
    k = graph.n - graph.rank
    if method == "osd0" or osd_order == 0 or k == 0:
        return OsdConsts()
    lam = min(int(osd_order), k)
    if method == "osd_e":
        P, pw = _exhaustive_patterns(lam)
        return OsdConsts(patterns=P, pattern_weights=pw)
    if lam >= 2:
        return OsdConsts(pairs=_pair_indices(lam))
    return OsdConsts()


@lru_cache(maxsize=None)
def _exhaustive_patterns(order: int) -> tuple[np.ndarray, np.ndarray]:
    """All 2^order bit patterns [C, order] in counting order + their weights."""
    i = np.arange(1 << order, dtype=np.uint32)
    bits = ((i[:, None] >> np.arange(order, dtype=np.uint32)[None, :]) & 1)
    bits = bits.astype(np.uint8)
    return bits, bits.sum(axis=1).astype(np.int32)


@lru_cache(maxsize=None)
def _pair_indices(lam: int) -> np.ndarray:
    """Lexicographic (i < j) pairs over the first ``lam`` T-positions."""
    idx = [(i, j) for i in range(lam) for j in range(i + 1, lam)]
    return np.asarray(idx, dtype=np.int32).reshape(-1, 2)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words (as uint32), int64 result."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _pack_rows_bits(bits: torch.Tensor) -> torch.Tensor:
    """``[..., m]`` 0/1 -> ``[..., ceil(m/32)]`` int32 words, bit i%32 of word i//32."""
    m = bits.shape[-1]
    Wm = -(-m // 32)
    pad = Wm * 32 - m
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, pad))
    b = b.view(*bits.shape[:-1], Wm, 32)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return _wrap_i32((b << shifts).sum(-1))


def _unpack_bits(words: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of :func:`_pack_rows_bits`: ``[..., Wm]`` words -> ``[..., m]`` uint8."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.flatten(-2)[..., :m].to(torch.uint8)


def _bit_at(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos`` of packed ``words [B, Wm]`` for ``pos [B, K] >= 0``."""
    w = words.gather(1, pos >> 5)
    return (w >> (pos & 31)) & 1


def _eliminate(cols: torch.Tensor, r: int):
    """In-place Gauss-Jordan over ``cols [B, n+1, Wm]`` in column order.

    Returns ``prow [B, n]`` int64: the pivot row of column ``t``, or -1.
    """
    B, n1, Wm = cols.shape
    n = n1 - 1
    dev = cols.device
    used = torch.zeros(B, Wm, dtype=torch.int32, device=dev)
    rr = torch.zeros(B, dtype=torch.int64, device=dev)
    prow = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    ar = torch.arange(B, device=dev)
    word_ids = torch.arange(Wm, device=dev)
    for t in range(n):
        live = rr < r
        if not bool(live.any()):
            break
        ct = cols[:, t, :]
        elig = ct & ~used
        nz = elig != 0
        has = nz.any(1) & live
        w = nz.to(torch.int32).argmax(1)  # first word with an eligible row
        word = elig[ar, w]
        bit = _popcount32((word & -word) - 1)  # trailing zeros of `word`
        bit = torch.where(has, bit, 0)
        pmask = torch.where(word_ids[None, :] == w[:, None],
                            _wrap_i32(torch.ones_like(bit) << bit)[:, None], 0)
        pmask = torch.where(has[:, None], pmask, 0)
        S = ct & ~pmask & -has.to(torch.int32)[:, None]
        sel = (cols.gather(2, w[:, None, None].expand(B, n1, 1)).squeeze(2)
               >> bit[:, None].to(torch.int32)) & 1
        cols ^= (-sel)[:, :, None] & S[:, None, :]
        used |= pmask
        prow[:, t] = torch.where(has, w.to(torch.int64) * 32 + bit, -1)
        rr += has.to(torch.int64)
    return prow


def eliminate_plain(graph: TannerGraph, perm: torch.Tensor, synd: torch.Tensor,
                    skip=None) -> Elimination:
    """Gauss-Jordan elimination of H in column order ``perm [B, n]``; the plain
    torch version of kernel K4 (``ops/cuda_gf2.py``) and the port of the
    JAX package's ``_eliminate``, whose five outputs it returns (zeros on
    skipped rows).  Runs the column-major :func:`_eliminate` and transposes
    the reduced matrix back to row-packed original column order."""
    B, m, n, r, W = perm.shape[0], graph.m, graph.n, graph.rank, graph.num_words
    dev = perm.device
    out = Elimination(
        torch.zeros(B, m, W, dtype=torch.int32, device=dev),
        torch.zeros(B, m, dtype=torch.int32, device=dev),
        torch.zeros(B, r, dtype=torch.int32, device=dev),
        torch.zeros(B, r, dtype=torch.int32, device=dev),
        torch.zeros(B, n, dtype=torch.bool, device=dev),
    )
    rows = (torch.arange(B, device=dev) if skip is None
            else torch.nonzero(~skip.to(torch.bool)).flatten())
    if rows.numel() == 0:
        return out
    perm_a = perm[rows].long()
    cols = torch.cat([graph.H_cols[perm_a],
                      _pack_rows_bits(synd[rows])[:, None, :]], 1)
    prow = _eliminate(cols, r)
    bits = _unpack_bits(cols, m)  # [Ba, n + 1, m]
    h_bits = torch.zeros_like(bits[:, :n]).scatter_(
        1, perm_a[:, :, None].expand(-1, -1, m), bits[:, :n])
    out.h_work[rows] = _pack_rows_bits(h_bits.transpose(1, 2))
    out.s_work[rows] = bits[:, n].to(torch.int32)
    is_piv = prow >= 0
    found = torch.argsort((~is_piv).to(torch.int32), dim=1, stable=True)[:, :r]
    out.pivot_ids[rows] = perm_a.gather(1, found).to(torch.int32)
    out.pivot_rows[rows] = prow.gather(1, found).to(torch.int32)
    out.pivot_mask[rows] = is_piv
    return out


def osd_after_elimination(elim: Elimination, perm: torch.Tensor, *, method: str,
                          osd_order: int, skip=None):
    """osd0 and osdw from kernel K4's outputs, as the JAX package continues
    after its elimination (``bp_osd_tpu/decoder/osd.py:486-507``): osd0
    reads the reduced syndrome at the pivot rows; osd_e extracts the first
    ``lam`` T columns' bits at the pivot rows and searches all ``2^lam``
    patterns (:func:`_search_e`).  osd_cs at order > 0 runs in K2 or K5
    and is refused here.  Plain torch ops on the tensors' device; returns
    ``(osd0, osdw)`` uint8 ``[B, n]``, zero on skipped rows."""
    h_work, s_work, pivot_ids, pivot_rows, pivot_mask = elim
    B, n = pivot_mask.shape
    r = pivot_ids.shape[1]
    lam = min(int(osd_order), n - r)
    if method == "osd_cs" and lam > 0:
        raise ValueError("osd_cs at order > 0 runs in K2 or K5, not after K4")
    pid = pivot_ids.long()
    prow = pivot_rows.long()
    s_rows = s_work.gather(1, prow)  # [B, r]
    e0 = torch.zeros(B, n, dtype=torch.int32, device=perm.device).scatter_(1, pid, s_rows)
    ew = e0
    if method == "osd_e" and lam > 0:
        tpos = torch.argsort(pivot_mask.to(torch.int32), dim=1, stable=True)[:, :lam]
        t_cols = perm.long().gather(1, tpos)  # [B, lam] original ids
        W = h_work.shape[2]
        h_rows = h_work.gather(1, prow[:, :, None].expand(-1, -1, W))  # [B, r, W]
        words = h_rows.gather(2, (t_cols >> 5)[:, None, :].expand(-1, r, -1))
        t_bits = (words >> (t_cols & 31)[:, None, :].to(torch.int32)) & 1  # [B, r, lam]
        pat = _search_e(_pack_rows_bits(s_rows), _pack_rows_bits(t_bits.transpose(1, 2)), lam)
        chosen = ((pat[:, None] >> torch.arange(lam, device=pat.device)) & 1).to(torch.int32)
        e_piv = ((s_rows + (t_bits * chosen[:, None, :]).sum(-1)) & 1).to(torch.int32)
        ew = torch.zeros_like(e0).scatter_(1, pid, e_piv).scatter_(1, t_cols, chosen)
    e0, ew = e0.to(torch.uint8), ew.to(torch.uint8)
    if skip is not None:
        live = ~skip.to(torch.bool)[:, None]
        e0, ew = e0 * live, ew * live
    return e0, ew


def _search_cs(s, tcols, pairs):
    """Winner of zero / weight-1 / weight-2 candidates: ``(slot1, slot2)``
    T-slot indices, -1 where unused."""
    B, k, _ = tcols.shape
    w0 = _popcount32(s).sum(-1)
    w1 = _popcount32(s[:, None, :] ^ tcols).sum(-1) + 1
    parts = [w0[:, None], w1]
    if pairs is not None:
        pa, pb = pairs[:, 0], pairs[:, 1]
        w2 = _popcount32(s[:, None, :] ^ tcols[:, pa] ^ tcols[:, pb]).sum(-1) + 2
        parts.append(w2)
    best = torch.cat(parts, 1).argmin(1)  # first minimum wins
    minus1 = torch.full_like(best, -1)
    slot1 = torch.where((best >= 1) & (best <= k), best - 1, minus1)
    slot2 = minus1
    if pairs is not None:
        q = (best - 1 - k).clamp(min=0)
        in_w2 = best > k
        slot1 = torch.where(in_w2, pa[q], slot1)
        slot2 = torch.where(in_w2, pb[q], slot2)
    return slot1, slot2


def _search_e(s, tcols, lam: int):
    """Winning pattern (counting index) over all 2^lam patterns, per row."""
    B, Wm = s.shape
    C = 1 << lam
    pw = _popcount32(torch.arange(C, device=s.device, dtype=torch.int32))
    chunk = max(1, _OSD_E_CHUNK_WORDS // (C * Wm))
    best = []
    for lo in range(0, B, chunk):
        R = s[lo : lo + chunk, None, :]
        for j in range(lam):  # doubling: pattern i with bit j = R[i - 2^j] ^ col_j
            R = torch.cat([R, R ^ tcols[lo : lo + chunk, j : j + 1]], 1)
        best.append((_popcount32(R).sum(-1) + pw).argmin(1))
    return torch.cat(best)


def osd_decode_plain(graph: TannerGraph, perm: torch.Tensor, synd: torch.Tensor,
                     *, method: str, osd_order: int, pairs=None, skip=None):
    """Plain torch OSD on reliability order ``perm [B, n]``; the reference for
    kernels K2 (``csrc/osd_cs.cu``) and K5 (``csrc/osd_large.cu``).  Returns
    ``(osd0, osdw)`` uint8 ``[B, n]`` in original coordinates, zero on
    skipped rows."""
    B, n, r = perm.shape[0], graph.n, graph.rank
    dev = perm.device
    e0 = torch.zeros(B, n, dtype=torch.uint8, device=dev)
    ew = torch.zeros(B, n, dtype=torch.uint8, device=dev)
    rows = (torch.arange(B, device=dev) if skip is None
            else torch.nonzero(~skip.to(torch.bool)).flatten())
    if rows.numel() == 0:
        return e0, ew
    perm_a = perm[rows].long()
    cols = torch.cat([graph.H_cols[perm_a],
                      _pack_rows_bits(synd[rows])[:, None, :]], 1)
    prow = _eliminate(cols, r)
    s = cols[:, n, :]
    is_piv = prow >= 0
    piv_bit = _bit_at(s, prow.clamp(min=0)) * is_piv
    e0p = piv_bit
    ewp = piv_bit
    k, lam = n - r, min(int(osd_order), n - r)
    if method != "osd0" and lam > 0:
        tpos = torch.argsort(is_piv.to(torch.int32), dim=1, stable=True)[:, :k]
        tcols = cols.gather(1, tpos[:, :, None].expand(-1, -1, cols.shape[2]))
        chosen = torch.zeros_like(tpos)  # [Ba, k] winner pattern over T
        if method == "osd_cs":
            pt = (torch.as_tensor(pairs, device=dev).long()
                  if pairs is not None and lam >= 2 else None)
            slot1, slot2 = _search_cs(s, tcols, pt)
            for sl in (slot1, slot2):
                hit = sl >= 0
                chosen[hit, sl[hit]] = 1
        else:
            pat = _search_e(s, tcols, lam)
            j = torch.arange(lam, device=dev)
            chosen[:, :lam] = (pat[:, None] >> j) & 1
        s_best = s ^ _xor_reduce(tcols, chosen)
        piv_best = _bit_at(s_best, prow.clamp(min=0)) * is_piv
        t_bit = torch.zeros_like(prow).scatter_(1, tpos, chosen)
        ewp = piv_best | t_bit
    e0[rows] = torch.zeros_like(e0[rows]).scatter_(1, perm_a, e0p.to(torch.uint8))
    ew[rows] = torch.zeros_like(ew[rows]).scatter_(1, perm_a, ewp.to(torch.uint8))
    return e0, ew


def _xor_reduce(tcols: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """XOR over the T columns with ``chosen == 1``: ``[B, Wm]``."""
    acc = torch.zeros_like(tcols[:, 0, :])
    for j in torch.nonzero(chosen.any(0)).flatten().tolist():
        acc ^= tcols[:, j, :] & -chosen[:, j, None].to(torch.int32)
    return acc


def osd_decode(
    graph: TannerGraph,
    syndromes,
    llr,
    *,
    osd_method: str = "osd0",
    osd_order: int = 0,
    consts: OsdConsts | None = None,
    skip=None,
    backend: str = "auto",
) -> OsdResult:
    """Run OSD on a batch given BP soft outputs ``llr [B, n]``.

    ``skip [B]`` marks rows that need no OSD (BP converged); they come back
    as zeros.  On the card the kernel is :func:`osd_route`'s: osd_cs in K2,
    or K5 when K2's shared memory cannot hold the matrix; osd_e in K3, or
    else K4 and the torch search of :func:`osd_after_elimination`; osd0 and
    order-0 decodes in K4, or K5 on codes K2 cannot hold.  On the CPU every
    method runs :func:`osd_decode_plain`.
    """
    device = syndromes.device if torch.is_tensor(syndromes) else graph.device
    synd = as_syndromes(syndromes, graph.m, device)
    resolve_backend(backend, device)
    return _osd_decode(graph, synd, llr, osd_method=osd_method, osd_order=osd_order,
                       consts=consts, skip=skip)


def _osd_decode(graph: TannerGraph, synd: torch.Tensor, llr, *, osd_method: str,
                osd_order: int, consts: OsdConsts | None = None, skip=None) -> OsdResult:
    """:func:`osd_decode` of ``synd``, syndromes that
    :func:`~bp_osd_tpu_torch.decoder.bp.as_syndromes` has checked (a
    ``[B, m]`` uint8 tensor); the port's own callers use it, so a public
    call checks its input once."""
    method = normalize_osd_method(osd_method)
    if method == "osd_e" and osd_order > _MAX_OSD_E_ORDER:
        raise ValueError(
            f"osd_e order {osd_order} would enumerate 2^{osd_order} patterns; "
            f"max supported is {_MAX_OSD_E_ORDER} (use osd_cs for deep search)"
        )
    if consts is None:
        consts = build_osd_consts(graph, method, osd_order)
    device = synd.device
    graph = graph.to(device)
    llr = as_f32(llr, device)
    if llr.dim() == 1:
        llr = llr[None, :]
    if llr.shape != (synd.shape[0], graph.n):
        raise ValueError(f"llr must have shape [{synd.shape[0]}, {graph.n}]")
    if skip is not None:
        skip = torch.as_tensor(skip).to(device=device, dtype=torch.bool)
    B = synd.shape[0]
    with profiling.span("osd.argsort", rows=B):
        perm = torch.argsort(llr, dim=1, stable=True).to(torch.int32)
    order = 0 if method == "osd0" else int(osd_order)
    if device.type == "cuda":
        from ..ops.cuda_gf2 import eliminate
        from ..ops.cuda_osd import osd_cs, osd_e
        from ..ops.cuda_osd_large import osd_large

        route = osd_route(graph, method, order)
        with profiling.span("osd.kernel", route=route, rows=B):
            if route == "k3":
                e0, ew = osd_e(graph, perm, synd, osd_order=order, skip=skip)
            elif route == "k4":
                e0, ew = osd_after_elimination(eliminate(graph, perm, synd, skip=skip),
                                               perm, method=method, osd_order=order,
                                               skip=skip)
            else:
                kernel = osd_cs if route == "k2" else osd_large
                e0, ew = kernel(graph, perm, synd, osd_order=order,
                                pairs=consts.pairs, skip=skip)
    else:
        with profiling.span("osd.kernel", route="torch", rows=B):
            e0, ew = osd_decode_plain(graph, perm, synd, method=method,
                                      osd_order=order, pairs=consts.pairs, skip=skip)
    return OsdResult(osd0=e0, osdw=ew)


def osd_route(graph, method: str, osd_order: int) -> str:
    """The kernel that decodes ``method`` at ``osd_order`` on the card, as the
    JAX package routes its Pallas backend (``bp_osd_tpu/decoder/osd.py:420-485``)
    with K2's shared-memory fit in the place of ``fused_osd_fits``:
    ``"k2"`` osd_cs, ``"k3"`` osd_e (``csrc/osd_cs.cu``), ``"k4"`` the
    elimination (``ops/cuda_gf2.py:eliminate``) then torch, ``"k5"`` the
    large-code osd_cs (``csrc/osd_large.cu``).  ``graph`` needs ``m n rank``."""
    from ..ops.cuda_osd import k2_fits, k3_fits

    method = normalize_osd_method(method)
    lam = 0 if method == "osd0" else max(0, min(int(osd_order), graph.n - graph.rank))
    if method == "osd_cs" and lam > 0:
        return "k2" if k2_fits(graph, lam) else "k5"
    if method == "osd_e" and lam > 0:
        return "k3" if k3_fits(graph, lam) else "k4"
    return "k4" if k2_fits(graph, 0) else "k5"
