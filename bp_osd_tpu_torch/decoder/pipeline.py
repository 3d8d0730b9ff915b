"""Batched BP+OSD decode pipeline with staged long-iteration BP.

Port of ``bp_osd_tpu/decoder/pipeline.py``.  BP runs to ``max_iter`` in
stages ``(s_1, s_2, ...) -> max_iter`` (:func:`stage_caps`, from the
``stage1_iters`` argument): stage 1 decodes the whole batch and
emits its message state; each later stage resumes only the failures of the
stage before it, at iteration ``s_prev + 1``, from that state.  BP is
deterministic and the adaptive min-sum factor depends only on the global
iteration, so the staged result equals one straight ``max_iter`` run bit for
bit.  OSD then runs on the rows BP left unconverged, and the results are
merged back in original batch order.

The JAX package pads each stage to a static prefix tier (``_prefix_cond``)
because XLA needs static shapes; here each stage takes exactly its failures.

With a :class:`~bp_osd_tpu_torch.decoder.lifted_bp.LiftedGraph`, BP is the
shift-routed lifted BP run straight to ``max_iter`` with no stages, as the
JAX package's decoder runs lifted codes; with a
:class:`~bp_osd_tpu_torch.decoder.layered.LayeredTannerGraph`, it is layered
BP, also straight, as the JAX decoder runs ``schedule="layered"``.  The OSD
tail is the same, on the unpermuted ``graph``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling
from .bp import _bp_decode, as_f32, as_syndromes, normalize_bp_method
from .layered import LayeredTannerGraph, _bp_decode_layered
from .lifted_bp import LiftedGraph, _bp_decode_lifted
from .osd import OsdConsts, _osd_decode
from .tanner import TannerGraph, resolve_backend

__all__ = ["BpOsdBatch", "auto_stage_schedule", "decode_pipeline", "stage_caps"]


def _partition_order(conv: torch.Tensor, site: str = "bp_partition"):
    """Failure-clustered order and the failure count: non-converged rows
    first, each group in original index order (= a stable argsort of
    ``conv``).  Reading the count is the host sync ``sync.<site>``."""
    B = conv.shape[0]
    c = conv.to(torch.int64)
    with profiling.sync(site):
        nfail = B - int(c.sum())
    pos = torch.where(conv, nfail + torch.cumsum(c, 0) - 1, torch.cumsum(1 - c, 0) - 1)
    order = torch.empty_like(pos)
    order[pos] = torch.arange(B, device=conv.device)
    return order, nfail


class BpOsdBatch(NamedTuple):
    osdw: torch.Tensor  # [B, n] uint8 final decoding (BP if converged)
    osd0: torch.Tensor  # [B, n] uint8 OSD-0 decoding (BP if converged)
    bp_hard: torch.Tensor  # [B, n] uint8 BP hard decision at freeze point
    converged: torch.Tensor  # [B] bool BP convergence
    iterations: torch.Tensor  # [B] int32
    llr: torch.Tensor  # [B, n] float32 BP soft output (posterior LLRs)


def auto_stage_schedule(max_iter: int) -> tuple[int, ...]:
    """Stage caps ``max_iter/16`` and ``max_iter/4``, floored to multiples of
    8 (``(24, 96)`` at ``max_iter = 400``); caps ``>= max_iter`` are dropped."""
    mi = int(max_iter)
    caps = sorted({max(8, mi // 16 // 8 * 8), max(16, mi // 4 // 8 * 8)})
    return tuple(c for c in caps if c < mi) or (mi,)


def stage_caps(max_iter: int, stage1_iters=None) -> list[int]:
    """The iteration caps of the staged BP's launches, ``max_iter`` last.

    ``stage1_iters`` follows the JAX package's rule
    (``bp_osd_tpu/decoder/pipeline.py:170-174``): an int ``s`` gives the
    caps ``[min(s, max_iter)]``, a sequence its entries below ``max_iter``;
    they are sorted without repeats, or ``[max_iter]`` if none is left.
    ``None`` is :func:`auto_stage_schedule`.  A cap below 1 raises
    ``ValueError``.  ``[max_iter]`` alone is one straight run."""
    mi = int(max_iter)
    if stage1_iters is None:
        stage1_iters = auto_stage_schedule(mi)
    if isinstance(stage1_iters, (tuple, list)):
        given = [int(s) for s in stage1_iters]
        caps = [s for s in given if s < mi]
    else:
        given = [int(stage1_iters)]
        caps = [min(given[0], mi)]
    if any(s < 1 for s in given):
        raise ValueError(f"stage1_iters caps must be at least 1, got {stage1_iters!r}")
    caps = sorted(set(caps)) or [mi]
    return caps if caps[-1] == mi else caps + [mi]


def decode_pipeline(
    graph: TannerGraph,
    syndromes,
    llr0,
    *,
    bp_method: str = "minimum_sum",
    max_iter: int = 0,
    ms_scaling_factor: float = 0.625,
    osd_method: str = "osd_cs",
    osd_order: int = 0,
    consts: OsdConsts | None = None,
    backend: str = "auto",
    lifted: LiftedGraph | None = None,
    layered: LayeredTannerGraph | None = None,
    stage1_iters=None,
) -> BpOsdBatch:
    """Full batched BP+OSD decode, BP staged by :func:`stage_caps` of
    ``stage1_iters`` (an int, a sequence of ints, or ``None`` for
    :func:`auto_stage_schedule`), or straight lifted BP when ``lifted`` (the
    protograph lift of ``graph.H``) is given, or straight layered BP when
    ``layered`` (the layered graph of ``graph.H``) is; those two take no
    ``stage1_iters``."""
    device = syndromes.device if torch.is_tensor(syndromes) else graph.device
    synd = as_syndromes(syndromes, graph.m, device)
    resolve_backend(backend, device)
    return _decode_pipeline(graph, synd, llr0, bp_method=bp_method, max_iter=max_iter,
                            ms_scaling_factor=ms_scaling_factor, osd_method=osd_method,
                            osd_order=osd_order, consts=consts, lifted=lifted,
                            layered=layered, stage1_iters=stage1_iters)


def _decode_pipeline(graph: TannerGraph, synd: torch.Tensor, llr0, *, bp_method: str,
                     max_iter: int, ms_scaling_factor: float, osd_method: str, osd_order: int,
                     consts: OsdConsts | None = None,
                     lifted: LiftedGraph | None = None,
                     layered: LayeredTannerGraph | None = None,
                     stage1_iters=None) -> BpOsdBatch:
    """:func:`decode_pipeline` of ``synd``, syndromes that
    :func:`~bp_osd_tpu_torch.decoder.bp.as_syndromes` has checked (a
    ``[B, m]`` uint8 tensor); the decoder classes and the harness call it,
    so a public call checks its input once, whatever the stages."""
    if stage1_iters is not None and (lifted is not None or layered is not None):
        raise ValueError("stage1_iters stages flooding BP; lifted and layered BP run "
                         "straight to max_iter")
    method = normalize_bp_method(bp_method)
    if max_iter == 0:
        max_iter = graph.n
    max_iter = int(max_iter)
    device = synd.device
    graph = graph.to(device)
    B, n = synd.shape[0], graph.n
    llr0 = as_f32(llr0, device).expand(B, n)
    bp_kw = dict(bp_method=method, max_iter=max_iter, ms_scaling_factor=ms_scaling_factor)
    with profiling.span("bp"):
        if lifted is not None:
            hard, llr, conv, iters = _bp_decode_lifted(lifted, synd, llr0, **bp_kw)
        elif layered is not None:
            hard, llr, conv, iters = _bp_decode_layered(layered, synd, llr0, **bp_kw)
        else:
            hard, llr, conv, iters = _staged_bp(graph, synd, llr0, method, max_iter,
                                                ms_scaling_factor, stage1_iters)

    with profiling.span("osd"):
        osdw = hard.clone()
        osd0 = hard.clone()
        with profiling.span("osd.partition"):
            order, nfail = _partition_order(conv, "osd_partition")
        if nfail:
            profiling.count("osd.rows", nfail)
            sel = order[:nfail]
            o = _osd_decode(graph, synd[sel], llr[sel], osd_method=osd_method,
                            osd_order=osd_order, consts=consts)
            with profiling.span("osd.scatter"):
                osdw[sel] = o.osdw
                osd0[sel] = o.osd0
    return BpOsdBatch(osdw=osdw, osd0=osd0, bp_hard=hard, converged=conv,
                      iterations=iters, llr=llr)


def _staged_bp(graph, synd, llr0, method, max_iter, ms_scaling_factor, stage1_iters=None):
    """BP in the stages of :func:`stage_caps`, each resuming the failures of
    the one before; returns ``(hard, llr, converged, iterations)``.  Stage
    ``i`` (from 1) is the span ``bp.stage`` and adds its rows to the counter
    ``bp.stage_rows.<i>``; while the recorder is on, the BP itself adds the
    iterations its rows ran in the stage to the device counter
    ``bp.row_iters.<i>``: no host wait, and no launch a batch."""
    caps = stage_caps(max_iter, stage1_iters)
    bp_kw = dict(bp_method=method, ms_scaling_factor=ms_scaling_factor)
    row_iters = profiling.device_counter(
        tuple(f"bp.row_iters.{i}" for i in range(1, len(caps) + 1)), synd.device)

    def slot(stage):  # the stage's one-slot view of the counter, or None
        return None if row_iters is None else row_iters[stage - 1 : stage]

    emit = caps[0] < max_iter
    B = synd.shape[0]
    profiling.count("bp.stage_rows.1", B)
    with profiling.span("bp.stage", stage=1, rows=B):
        out = _bp_decode(graph, synd, llr0, max_iter=caps[0], emit_state=emit,
                         row_iters=slot(1), **bp_kw)
    bp, v2c = out if emit else (out, None)
    hard, llr = bp.hard, bp.llr
    conv, iters = bp.converged, bp.iterations
    for stage, (s_prev, s_next) in enumerate(zip(caps, caps[1:]), 2):
        with profiling.span("bp.partition"):
            order, nfail = _partition_order(conv, "bp_partition")
        if nfail == 0:
            break
        profiling.count(f"bp.stage_rows.{stage}", nfail)
        with profiling.span("bp.gather"):
            sel = order[:nfail]
            synd_sel, llr0_sel, v2c_init = synd[sel], llr0[sel], v2c[sel]
        emit = s_next < max_iter
        with profiling.span("bp.stage", stage=stage, rows=nfail):
            out = _bp_decode(graph, synd_sel, llr0_sel, max_iter=s_next,
                             v2c_init=v2c_init, it0=s_prev, emit_state=emit,
                             row_iters=slot(stage), **bp_kw)
        res, v2c_sel = out if emit else (out, None)
        with profiling.span("bp.scatter"):
            hard[sel] = res.hard
            llr[sel] = res.llr
            conv[sel] = res.converged
            iters[sel] = res.iterations
            if emit:
                v2c[sel] = v2c_sel
    return hard, llr, conv, iters
