"""Batched belief-propagation syndrome decoding over a Tanner graph.

Port of ``bp_osd_tpu/decoder/bp.py`` plus the resume/emit surface of the TPU
kernel ``bp_osd_tpu/ops/pallas_bp.py:bp_decode_pallas``.  Flooding schedule:

- ``minimum_sum`` with a fixed scaling factor, or the adaptive factor
  ``alpha_t = 1 - 2**-t`` (global iteration ``t``) when ``ms_scaling_factor``
  is 0; exclusive minimum capped at 1e30.
- ``product_sum`` (tanh rule) with exclusive forward/backward products.

Per sample: freeze at first convergence; a non-converged sample runs exactly
``max_iter`` iterations in total.  ``skip`` rows are born converged (hard 0,
llr the prior, iterations ``it0``).  ``v2c_init``/``it0`` resume a message
state at iteration ``it0 + 1``; ``emit_state`` returns the state after each
row's last iteration.

Summation order.  The JAX XLA path sums a variable's incoming check messages
through a one-hot einsum, which XLA:CPU evaluates in four lanes: a message on
flat edge ``e = check * wr + slot`` goes to lane ``e % 4``, each lane adds in
ascending ``e``, and the lanes combine as ``(p0 + p1) + (p2 + p3)``.  Both the
plain version here and the CUDA kernel add in exactly that order, so min-sum
output is bit-identical to JAX at the shapes where XLA:CPU uses that order
(the [[400,16,6]] flagship, small surface and Hamming codes), and the kernel
is bit-identical to the plain version at every shape.

:func:`_bp_decode` alone picks by the tensors' device: CUDA tensors go to the
kernel in :mod:`bp_osd_tpu_torch.ops.cuda_bp`, others to :func:`bp_decode_plain`.
``bp_decode`` checks its ``backend`` against that device once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling
from .tanner import TannerGraph, resolve_backend

__all__ = [
    "BPResult",
    "MIN_SUM_METHODS",
    "PROD_SUM_METHODS",
    "as_f32",
    "as_syndromes",
    "bp_decode",
    "bp_decode_plain",
    "llr_from_channel",
    "normalize_bp_method",
]

MIN_SUM_METHODS = frozenset({"minimum_sum", "min_sum", "ms", "minimum_sum_log", "1"})
PROD_SUM_METHODS = frozenset({"product_sum", "prod_sum", "ps", "product_sum_log", "0"})

_P_CLIP = 1e-30  # channel probabilities clamped away from {0, 1}
_TANH_CLIP = 1.0 - 1e-7  # product-sum atanh domain guard (f32)
_BIG = 1e30  # min-sum magnitude cap; pad value of an exclusive minimum


def normalize_bp_method(bp_method) -> str:
    key = str(bp_method).lower()
    if key in MIN_SUM_METHODS:
        return "minimum_sum"
    if key in PROD_SUM_METHODS:
        return "product_sum"
    raise ValueError(
        f"unknown bp_method {bp_method!r}; choose minimum_sum/ms or product_sum/ps"
    )


def llr_from_channel(probs) -> torch.Tensor:
    """Channel error probabilities -> prior log-likelihood ratios (CPU f32).

    ``llr = log1p(-p) - log(p)`` in float32 with ``p`` clamped to
    ``[1e-30, 1 - 1e-7]``.  Always computed on the CPU, where it equals the
    JAX ``llr_from_channel`` at the flagship's p = 0.05; callers move the
    result to their device, so the prior does not depend on the card's
    ``log`` implementation.
    """
    p = torch.as_tensor(np.asarray(probs, np.float32))
    p = torch.clamp(p, _P_CLIP, 1.0 - 1e-7)
    return torch.log1p(-p) - torch.log(p)


class BPResult(NamedTuple):
    hard: torch.Tensor  # [B, n] uint8 hard decision at freeze point
    llr: torch.Tensor  # [B, n] f32 posterior log-prob ratios at freeze point
    converged: torch.Tensor  # [B] bool
    iterations: torch.Tensor  # [B] int32 iteration of first convergence (or last)


def as_syndromes(syndromes, m: int, device, what: str = "syndromes") -> torch.Tensor:
    """Validate and convert ``syndromes`` to a ``[B, m]`` uint8 tensor on
    ``device``.

    Entries must be 0 or 1 whatever the dtype: a float syndrome such as 0.9,
    or a uint8 one holding 2 or 255, is rejected with ``ValueError``, never
    truncated or reduced mod 2.  A numpy array is checked on the host before
    it is copied; a card tensor costs one reduction and one host read.  Each
    public entry point calls this once on its input and hands the result to
    private functions that do not check again.  The check and the copy are
    the span ``sync.input``: on a card, one wait either way.
    """
    s = torch.as_tensor(syndromes)
    if s.dim() == 1:
        s = s[None, :]
    if s.dim() != 2 or s.shape[1] != m:
        raise ValueError(f"{what} must have shape [B, {m}], got {tuple(s.shape)}")
    with profiling.sync("input"):
        _check_binary(s, what)
        return s.to(device=device, dtype=torch.uint8)


def _check_binary(s: torch.Tensor, what: str) -> None:
    """Raise ``ValueError`` unless every entry of ``s`` is 0 or 1."""
    if s.dtype == torch.bool:
        return
    bad = s > 1 if s.dtype == torch.uint8 else (s != 0) & (s != 1)
    if bool(bad.any()):
        raise ValueError(f"{what} entries must be 0 or 1")


def as_f32(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` (numpy input is copied)."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.array(x, np.float32))
    return t.to(device=device, dtype=torch.float32)


def _alpha(scale: float, it: int) -> float:
    """The f32 min-sum scaling factor of global iteration ``it``."""
    if scale == 0.0:
        return float(np.float32(1.0 - 2.0 ** -it))  # exact: 1 - 2^-t
    return float(np.float32(scale))


def _check_update_min_sum(v2c, chk_mask, syn, alpha: float):
    """Scaled min-sum c2v of ``v2c [B, m, wr]``; zero on pad slots."""
    scale, excl = _min_sum_factors(v2c, chk_mask, syn, alpha)
    return scale * excl


def _min_sum_factors(v2c, chk_mask, syn, alpha: float):
    """The two factors of the scaled min-sum c2v of ``v2c [B, m, wr]``: the
    signed scale (``+-alpha``, 0 on pad slots) and the exclusive minimum.

    The exclusive minimum over a check's other slots is a prefix/suffix min
    scan seeded with the 1e30 cap (so a row of weight 1 gets the cap).
    """
    neg = (v2c < 0.0) & chk_mask  # -0.0 counts as non-negative
    parity = (neg.sum(-1, dtype=torch.int32) + syn) & 1  # [B, m]
    mags = v2c.abs().masked_fill(~chk_mask, _BIG).unbind(-1)
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
    return torch.where(chk_mask, torch.where(out_neg, -alpha, alpha), 0.0), excl


_GRAIN = 32768  # ATen's intra-op grain size (at::internal::GRAIN_SIZE)
_BLOCK = 64  # a multiple of every CPU vector loop's step (2 x 16 f32 lanes)


def _aligned_length(numel: int, threads: int) -> int:
    """The least length ``L >= numel`` that ATen cuts into whole
    ``_BLOCK``-element pieces with ``threads`` intra-op threads.

    ATen's rule (``at::parallel_for`` over OpenMP): a tensor of at most
    ``_GRAIN`` elements runs in one piece; a longer one runs on
    ``T = min(threads, ceil(L / _GRAIN))`` threads, thread ``i`` taking
    elements ``[i * c, (i + 1) * c)`` with ``c = ceil(L / T)``.  So ``L``
    qualifies when it is a multiple of ``_BLOCK * T`` for the ``T`` that
    applies at ``L`` itself; this walks ``T`` up from the one at ``numel``,
    taking in each range of lengths that run on ``T`` threads the least
    multiple of ``_BLOCK * T``."""
    t = 1 if numel <= _GRAIN else min(threads, -(-numel // _GRAIN))
    while True:
        lo = numel if t == 1 else max(numel, (t - 1) * _GRAIN + 1)
        size = -(-lo // (_BLOCK * t)) * _BLOCK * t
        if t >= threads or size <= t * _GRAIN:
            return size
        t += 1


def _elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``, each element's value depending on
    that element alone: not on the tensor's length, the element's position
    or the thread count.  On the CPU, ATen evaluates a unary op in vector
    registers (SLEEF) and the last ``numel % (2 * lanes)`` elements of each
    thread's piece with the scalar libm function, which for ``atanh`` can
    differ in the last ulp.  Zero-padding to :func:`_aligned_length` leaves
    no thread a scalar tail, so every element takes the vector path (at one
    thread that is a multiple of 64).  A card evaluates every element
    alike."""
    if x.device.type != "cpu":
        return fn(x)
    flat = x.reshape(-1)
    pad = _aligned_length(flat.numel(), torch.get_num_threads()) - flat.numel()
    return fn(torch.cat([flat, flat.new_zeros(pad)]))[: flat.numel()].view(x.shape)


def _check_update_product_sum(v2c, chk_mask, syn):
    """Tanh-rule c2v of ``v2c [B, m, wr]``; zero on pad slots.  A check's
    messages do not depend on the other checks in the tensor, also on the
    CPU (:func:`_elementwise`), so a row block of checks gives the rows of
    the whole."""
    t = torch.where(chk_mask, _elementwise(torch.tanh, 0.5 * v2c), 1.0)
    wr = t.shape[-1]
    fwd = [torch.ones_like(t[..., 0])]
    for s in range(wr - 1):
        fwd.append(fwd[-1] * t[..., s])
    bwd = [torch.ones_like(t[..., 0])]
    for s in range(wr - 1, 0, -1):
        bwd.append(bwd[-1] * t[..., s])
    bwd.reverse()
    sign = (1.0 - 2.0 * syn.float())
    excl = torch.stack([sign * fwd[s] * bwd[s] for s in range(wr)], -1)
    excl = torch.clamp(excl, -_TANH_CLIP, _TANH_CLIP)
    return torch.where(chk_mask, 2.0 * _elementwise(torch.atanh, excl), 0.0)


def _lane_tables(graph: TannerGraph):
    """Flat gather indices ``[n * D_k]`` of each lane's edges, per variable in
    ascending edge order, padded with the zero column ``m * wr``."""
    ve = graph.var_edge.cpu().numpy()
    pad = graph.m * graph.wr
    tables = []
    for k in range(4):
        sel = [[e for e in row if e != pad and e % 4 == k] for row in ve]
        depth = max(1, max(len(r) for r in sel))
        idx = np.full((graph.n, depth), pad, np.int64)
        for v, r in enumerate(sel):
            idx[v, : len(r)] = r
        tables.append(torch.from_numpy(idx.reshape(-1)).to(graph.device))
    return tables


def _variable_sum(c2v_flat, lanes, n: int):
    """Per-variable sum of ``c2v_flat [B, E+1]`` (last column 0) in the
    four-lane order of the module docstring."""
    B = c2v_flat.shape[0]
    p = []
    for idx in lanes:
        g = c2v_flat.index_select(1, idx).view(B, n, -1)
        acc = g[..., 0]
        for d in range(1, g.shape[-1]):
            acc = acc + g[..., d]
        p.append(acc)
    return (p[0] + p[1]) + (p[2] + p[3])


def bp_decode_plain(
    graph: TannerGraph,
    synd: torch.Tensor,
    llr0: torch.Tensor,
    *,
    method: str,
    max_iter: int,
    ms_scaling_factor: float,
    skip: torch.Tensor | None = None,
    v2c_init: torch.Tensor | None = None,
    it0: int = 0,
    emit_state: bool = False,
    row_iters: torch.Tensor | None = None,
):
    """Plain torch flooding BP; the reference for kernel K1 (``bp_flood.cu``).

    ``synd [B, m]`` uint8, ``llr0 [B, n]`` f32, on ``graph.device``.  Rows
    leave the working set as they converge (their outputs are frozen), so a
    batch costs what its live rows cost.  Returns ``(hard [B, n] uint8,
    llr [B, n] f32, converged [B] bool, iterations [B] int32, v2c [B, m*wr]
    f32 or None)``; emitted pad slots are 0.  ``row_iters``, a one-slot
    int64 counter, gets the rows' iterations past ``it0`` added.
    """
    if max_iter <= it0:
        raise ValueError(f"max_iter={max_iter} must exceed it0={it0}")
    dev = synd.device
    B, n, m, wr = synd.shape[0], graph.n, graph.m, graph.wr
    E = m * wr
    chk_flat = graph.chk_var.reshape(-1).long()
    chk_mask = graph.chk_mask
    lanes = _lane_tables(graph)
    zcol = torch.zeros(B, 1, dtype=torch.float32, device=dev)

    def to_edges(x_pad):  # [Ba, n+1] -> [Ba, m, wr]
        return x_pad.index_select(1, chk_flat).view(-1, m, wr)

    llr0 = llr0.expand(B, n)
    if v2c_init is None:
        v2c = to_edges(torch.cat([llr0, zcol], 1))
    else:
        v2c = v2c_init.reshape(B, m, wr).to(torch.float32)
    v2c = torch.where(chk_mask, v2c, 0.0)

    hard = torch.zeros(B, n, dtype=torch.uint8, device=dev)
    llr = llr0.clone()
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), it0, dtype=torch.int32, device=dev)
    v2c_out = v2c.reshape(B, E).clone() if emit_state else None
    if skip is not None:
        conv |= skip
        active = torch.nonzero(~skip).flatten()
    else:
        active = torch.arange(B, device=dev)
    v2c = v2c[active]
    syn = synd[active].to(torch.int32)
    l0 = llr0[active]

    for it in range(it0 + 1, max_iter + 1):
        Ba = active.numel()
        if Ba == 0:
            break
        if method == "minimum_sum":
            c2v = _check_update_min_sum(
                v2c, chk_mask, syn, _alpha(ms_scaling_factor, it))
        else:
            c2v = _check_update_product_sum(v2c, chk_mask, syn)
        zc = zcol[:Ba]
        total = l0 + _variable_sum(torch.cat([c2v.reshape(Ba, E), zc], 1), lanes, n)
        v2c = torch.where(chk_mask, to_edges(torch.cat([total, zc], 1)) - c2v, 0.0)
        h = (total <= 0).to(torch.uint8)
        bits = to_edges(torch.cat([h, zc.to(torch.uint8)], 1))
        parity = bits.sum(-1, dtype=torch.int32) & 1
        ok = (parity == syn).all(-1)
        done = ok if it < max_iter else torch.ones_like(ok)
        if bool(done.any()):
            idx = active[done]
            hard[idx] = h[done]
            llr[idx] = total[done]
            conv[idx] = ok[done]
            iters[idx] = it
            if emit_state:
                v2c_out[idx] = v2c[done].reshape(-1, E)
            keep = ~done
            active, v2c, syn, l0 = active[keep], v2c[keep], syn[keep], l0[keep]
    if row_iters is not None:
        row_iters += (iters.to(torch.int64) - it0).sum().to(row_iters.device)
    return hard, llr, conv, iters, v2c_out


def bp_decode(
    graph: TannerGraph,
    syndromes,
    llr0,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    skip=None,
    v2c_init=None,
    it0: int = 0,
    emit_state: bool = False,
    backend: str = "auto",
):
    """Decode a batch of syndromes on ``graph``.

    ``max_iter == 0`` means the block length ``n``.  Tensor inputs decide the
    device (numpy inputs go to ``graph.device``).  Returns a
    :class:`BPResult`, and with ``emit_state=True`` the pair
    ``(BPResult, v2c [B, m*wr])``.
    """
    device = syndromes.device if torch.is_tensor(syndromes) else graph.device
    synd = as_syndromes(syndromes, graph.m, device)
    resolve_backend(backend, device)
    return _bp_decode(graph, synd, llr0, bp_method=bp_method, max_iter=max_iter,
                      ms_scaling_factor=ms_scaling_factor, skip=skip, v2c_init=v2c_init,
                      it0=it0, emit_state=emit_state)


def _bp_decode(graph: TannerGraph, synd: torch.Tensor, llr0, *, bp_method: str,
               max_iter: int, ms_scaling_factor: float, skip=None, v2c_init=None,
               it0: int = 0, emit_state: bool = False,
               row_iters: torch.Tensor | None = None):
    """:func:`bp_decode` of ``synd``, syndromes that :func:`as_syndromes`
    has checked (a ``[B, m]`` uint8 tensor); the port's own callers use it,
    so a public call checks its input once.  ``row_iters`` (a one-slot int64
    counter on the device, or None) gets the rows' iterations past ``it0``."""
    method = normalize_bp_method(bp_method)
    if max_iter == 0:
        max_iter = graph.n
    device = synd.device
    graph = graph.to(device)
    B = synd.shape[0]
    llr0 = as_f32(llr0, device).expand(B, graph.n)
    if skip is not None:
        skip = torch.as_tensor(skip).to(device=device, dtype=torch.bool)
        if skip.shape != (B,):
            raise ValueError(f"skip must have shape [{B}], got {tuple(skip.shape)}")
    if v2c_init is not None:
        v2c_init = as_f32(v2c_init, device)
    kw = dict(method=method, max_iter=int(max_iter),
              ms_scaling_factor=float(ms_scaling_factor), skip=skip,
              v2c_init=v2c_init, it0=int(it0), emit_state=emit_state, row_iters=row_iters)
    if device.type == "cuda":
        from ..ops.cuda_bp import bp_flood

        hard, llr, conv, iters, v2c = bp_flood(graph, synd, llr0, **kw)
    else:
        hard, llr, conv, iters, v2c = bp_decode_plain(graph, synd, llr0, **kw)
    res = BPResult(hard=hard, llr=llr, converged=conv, iterations=iters)
    return (res, v2c) if emit_state else res
