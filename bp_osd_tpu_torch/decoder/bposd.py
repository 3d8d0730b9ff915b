"""User-facing decoder classes: ``BpOsdDecoder`` / ``bposd_decoder``.

Port of ``bp_osd_tpu/decoder/bposd.py``: drop-in replacements for the native
classes the reference imports from ``ldpc`` (v2 name ``BpOsdDecoder``, v1
spelling ``bposd_decoder``).  Constructor surface, attribute protocol
(``bp_decoding``, ``osd0_decoding``, ``osdw_decoding``, ``converge``,
``log_prob_ratios``, ``update_channel_probs``) and decode semantics follow the
JAX package; ``decode()`` is ``decode_batch`` with a batch of one.

``proto=``/``lift=`` name the protograph whose lift is H (e.g.
``lifted_hgp(...).hx_proto``): BP then runs the shift-routed lifted BP of
:mod:`~bp_osd_tpu_torch.decoder.lifted_bp`, straight to ``max_iter``, the
only BP that holds an n ~ 10^4 code; on the card OSD goes to kernel K5 when
K2's shared memory cannot hold the matrix.  ``schedule="serial"`` (or
``"layered"``) runs the layered BP of :mod:`~bp_osd_tpu_torch.decoder.layered`
(plain torch on both devices) straight to ``max_iter``; OSD then runs on its
failures on the unpermuted graph, as in the JAX package.

A decoder lives on one ``device`` (default: the card when
``torch.cuda.is_available()``, else the CPU).  ``backend`` in
``{"auto", "cuda", "torch"}`` is checked against that device once, here: on
the card every decode goes through the CUDA kernels, on the CPU through their
plain torch versions, and ``"cuda"`` without a card raises.

Syndromes (and received vectors) must hold 0/1 entries: a float syndrome
such as 0.9 raises ``ValueError`` instead of being truncated to 0 as the JAX
package's ``astype(uint8)`` does, and so does a uint8 entry above 1.  A
decode checks its input once, in :meth:`BpDecoder._resolve_input`.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..utils import profiling
from .bp import BPResult, _bp_decode, as_syndromes, llr_from_channel, normalize_bp_method
from .layered import LayeredTannerGraph, _bp_decode_layered
from .lifted_bp import LiftedGraph, _bp_decode_lifted
from .osd import build_osd_consts, normalize_osd_method
from .pipeline import _decode_pipeline
from .tanner import TannerGraph, resolve_backend, resolve_device

__all__ = ["BpDecoder", "BpOsdDecoder", "bp_decoder", "bposd_decoder"]

_CHUNK_CARD = 16384  # decode_batch dispatch size on the card
_CHUNK_CPU = 4096  # and on the CPU


def _as_channel_probs(n, error_rate, channel_probs, error_channel):
    """Resolve the per-qubit error channel from ctor args.

    v1 ``channel_probs=[None]`` means "unset, use scalar error_rate"; v2
    spells it ``error_channel``.
    """
    for vec in (channel_probs, error_channel):
        if vec is None:
            continue
        arr = np.asarray(vec).ravel()
        if arr.dtype == object and all(v is None for v in arr):
            continue  # v1 sentinel [None] = unset
        arr = arr.astype(np.float64)
        if arr.size == n:
            return arr
        raise ValueError(
            f"channel probability vector has length {arr.size}, expected {n}"
        )
    if error_rate is None:
        raise ValueError("provide either error_rate or channel_probs/error_channel")
    return np.full(n, float(error_rate))


def _one_row(vector):
    if torch.is_tensor(vector):
        return vector.reshape(1, -1)
    return np.asarray(vector).reshape(1, -1)


class BpDecoder:
    """Belief-propagation syndrome decoder (no post-processing)."""

    def __init__(
        self,
        parity_check_matrix,
        error_rate: float | None = None,
        max_iter: int = 0,
        bp_method: str = "minimum_sum",
        ms_scaling_factor: float = 1.0,
        channel_probs=None,
        error_channel=None,
        input_vector_type: str = "syndrome",
        schedule: str = "parallel",
        proto=None,
        lift: int | None = None,
        backend: str = "auto",
        device=None,
        **unused,
    ):
        H = (parity_check_matrix.toarray() if sp.issparse(parity_check_matrix)
             else np.asarray(parity_check_matrix))
        if proto is not None:
            if lift is None:
                raise ValueError("proto requires lift")
            if schedule != "parallel":
                raise ValueError("lifted decoding supports only the parallel schedule")
        if schedule not in ("parallel", "serial", "layered"):
            raise ValueError(
                f"schedule must be parallel/serial/layered, got {schedule!r}")
        if input_vector_type not in ("syndrome", "received_vector"):
            raise NotImplementedError(
                f"input_vector_type={input_vector_type!r} is not supported; "
                "choose 'syndrome' or 'received_vector'"
            )
        self.device = resolve_device(device, backend)
        self.backend = resolve_backend(backend, self.device)
        self._lifted = None
        if proto is not None:
            lg = LiftedGraph(proto, int(lift), self.device)
            if (lg.m, lg.n) != H.shape:
                raise ValueError(f"protograph lift is {lg.m}x{lg.n} but H is "
                                 f"{H.shape[0]}x{H.shape[1]}")
            self._lifted = lg
        self.schedule = "parallel" if schedule == "parallel" else "layered"
        # OSD and the syndromes of received vectors work on the unpermuted graph
        self.graph = TannerGraph(H, self.device)
        self._layered = (LayeredTannerGraph(H, self.device)
                         if self.schedule == "layered" else None)
        self.input_vector_type = input_vector_type
        self._H_f32 = (torch.as_tensor(self.graph.H, dtype=torch.float32, device=self.device)
                       if input_vector_type == "received_vector" else None)
        self.m, self.n = self.graph.m, self.graph.n
        self.bp_method = normalize_bp_method(bp_method)
        self.max_iter = int(max_iter) if max_iter else self.graph.n
        self.ms_scaling_factor = float(ms_scaling_factor)
        self.channel_probs = _as_channel_probs(
            self.n, error_rate, channel_probs, error_channel
        )
        self.error_rate = error_rate

        # per-decode outputs (single-syndrome attribute protocol)
        self.bp_decoding = np.zeros(self.n, dtype=np.uint8)
        self.log_prob_ratios = np.zeros(self.n, dtype=np.float32)
        self.converge = 0
        self.iter = 0

    def update_channel_probs(self, probs) -> None:
        """Swap the prior channel for later decodes."""
        probs = np.asarray(probs, dtype=np.float64).ravel()
        if probs.size != self.n:
            raise ValueError(f"expected {self.n} probabilities, got {probs.size}")
        self.channel_probs = probs

    def _llr0(self, channel_probs=None) -> torch.Tensor:
        probs = self.channel_probs if channel_probs is None else channel_probs
        with profiling.span("prior"):
            llr = llr_from_channel(probs)
            with profiling.sync("prior"):
                return llr.to(self.device)

    def _resolve_input(self, vectors):
        """Map decode() input to ``(syndromes [B, m] uint8, received [B, n]
        uint8 or None)`` on the decoder's device; in received-vector mode
        decodings are ``received XOR e_hat``.  The one check of a decode's
        input: what it returns goes to the private BP and pipeline
        functions, which do not check again."""
        if torch.is_tensor(vectors) and vectors.device != self.device:
            raise ValueError(
                f"input is on {vectors.device}, the decoder on {self.device}")
        with profiling.span("input"):
            if self.input_vector_type == "syndrome":
                return as_syndromes(vectors, self.m, self.device), None
            rec = as_syndromes(vectors, self.n, self.device, what="received vectors")
            # f32 counts are exact far beyond any row weight
            synd = torch.remainder(rec.to(torch.float32) @ self._H_f32.T, 2)
            return synd.to(torch.uint8), rec

    @staticmethod
    def _out(x: torch.Tensor, outputs: str):
        if outputs != "host":
            return x
        with profiling.sync("outputs"):
            return x.cpu().numpy()

    def decode_batch(self, syndromes, channel_probs=None, outputs: str = "host"):
        if outputs not in ("host", "device"):
            raise ValueError(f"outputs must be host/device, got {outputs!r}")
        with profiling.span("decode_batch") as top:
            synd, received = self._resolve_input(syndromes)
            top.set(rows=synd.shape[0])
            llr0 = self._llr0(channel_probs)
            kw = dict(bp_method=self.bp_method, max_iter=self.max_iter,
                      ms_scaling_factor=self.ms_scaling_factor)
            with profiling.span("bp"):
                if self._lifted is not None:
                    res: BPResult = _bp_decode_lifted(self._lifted, synd, llr0, **kw)
                elif self._layered is not None:
                    res = _bp_decode_layered(self._layered, synd, llr0, **kw)
                else:
                    res = _bp_decode(self.graph, synd, llr0, **kw)
            with profiling.span("outputs"):
                hard = res.hard if received is None else res.hard ^ received
                self.bp_decoding_batch = self._out(hard, outputs)
                self.log_prob_ratios_batch = self._out(res.llr, outputs)
                self.converge_batch = self._out(res.converged, outputs)
                self.iter_batch = self._out(res.iterations, outputs)
        return self.bp_decoding_batch

    def decode(self, syndrome) -> np.ndarray:
        out = self.decode_batch(_one_row(syndrome))
        self.bp_decoding = out[0]
        self.log_prob_ratios = self.log_prob_ratios_batch[0]
        self.converge = int(self.converge_batch[0])
        self.iter = int(self.iter_batch[0])
        return self.bp_decoding


class BpOsdDecoder(BpDecoder):
    """BP decoding with OSD post-processing (the reference's workhorse).

    ``decode`` returns the OSD-w decoding and populates ``bp_decoding``,
    ``osd0_decoding``, ``osdw_decoding``, ``converge`` — when BP converges,
    OSD is bypassed and all three decodings coincide.  Decoding runs the
    staged pipeline (:func:`~bp_osd_tpu_torch.decoder.pipeline.decode_pipeline`),
    or with ``proto``/``lift`` straight lifted BP and OSD on its failures.
    """

    def __init__(
        self,
        parity_check_matrix,
        error_rate: float | None = None,
        max_iter: int = 0,
        bp_method: str = "minimum_sum",
        ms_scaling_factor: float = 1.0,
        channel_probs=None,
        error_channel=None,
        osd_method: str = "osd_0",
        osd_order: int = 0,
        backend: str = "auto",
        input_vector_type: str = "syndrome",
        proto=None,
        lift: int | None = None,
        device=None,
        **unused,
    ):
        super().__init__(
            parity_check_matrix,
            error_rate=error_rate,
            max_iter=max_iter,
            bp_method=bp_method,
            ms_scaling_factor=ms_scaling_factor,
            channel_probs=channel_probs,
            error_channel=error_channel,
            input_vector_type=input_vector_type,
            proto=proto,
            lift=lift,
            backend=backend,
            device=device,
            **unused,
        )
        self.osd_method = normalize_osd_method(osd_method)
        self.osd_order = int(osd_order)
        self._osd_consts = build_osd_consts(self.graph, self.osd_method,
                                            self.osd_order)
        self.osd0_decoding = np.zeros(self.n, dtype=np.uint8)
        self.osdw_decoding = np.zeros(self.n, dtype=np.uint8)

    def decode_batch(self, syndromes, channel_probs=None,
                     chunk_size: int | None = None, compact_osd: bool = False,
                     outputs: str = "host"):
        """Decode a syndrome batch; returns the osdw decodings ``[B, n]``.

        ``chunk_size=None`` dispatches 16384 rows at a time on the card and
        4096 on the CPU.  ``outputs="device"`` leaves every ``*_batch``
        attribute as a tensor on the decoder's device instead of numpy.
        ``compact_osd=True`` is the JAX package's two-phase decode (OSD only
        on the BP failures) with host numpy outputs; every decode here runs
        OSD on the failures only, so it gives the same results as the
        default, and with ``outputs="device"`` it raises ``ValueError``.
        """
        if outputs not in ("host", "device"):
            raise ValueError(f"outputs must be host/device, got {outputs!r}")
        if compact_osd and outputs == "device":
            raise ValueError(
                "compact_osd=True assembles host numpy outputs; "
                "outputs='device' is not supported on that path"
            )
        if chunk_size is None:
            chunk_size = _CHUNK_CARD if self.device.type == "cuda" else _CHUNK_CPU
        with profiling.span("decode_batch") as top:
            synd, received = self._resolve_input(syndromes)
            top.set(rows=synd.shape[0])
            llr0 = self._llr0(channel_probs)
            outs = []
            for lo in range(0, synd.shape[0], chunk_size):
                outs.append(_decode_pipeline(
                    self.graph, synd[lo : lo + chunk_size], llr0,
                    bp_method=self.bp_method, max_iter=self.max_iter,
                    ms_scaling_factor=self.ms_scaling_factor,
                    osd_method=self.osd_method, osd_order=self.osd_order,
                    consts=self._osd_consts, lifted=self._lifted, layered=self._layered,
                ))
            with profiling.span("outputs"):
                cat = [torch.cat(xs) if len(xs) > 1 else xs[0] for xs in zip(*outs)]
                osdw, osd0, hard, conv, iters, llr = cat
                if received is not None:
                    hard, osd0, osdw = hard ^ received, osd0 ^ received, osdw ^ received
                self.bp_decoding_batch = self._out(hard, outputs)
                self.log_prob_ratios_batch = self._out(llr, outputs)
                self.converge_batch = self._out(conv, outputs)
                self.iter_batch = self._out(iters, outputs)
                self.osd0_decoding_batch = self._out(osd0, outputs)
                self.osdw_decoding_batch = self._out(osdw, outputs)
        return self.osdw_decoding_batch

    def decode(self, syndrome) -> np.ndarray:
        out = self.decode_batch(_one_row(syndrome))
        self.bp_decoding = self.bp_decoding_batch[0]
        self.log_prob_ratios = self.log_prob_ratios_batch[0]
        self.converge = int(self.converge_batch[0])
        self.iter = int(self.iter_batch[0])
        self.osd0_decoding = self.osd0_decoding_batch[0]
        self.osdw_decoding = self.osdw_decoding_batch[0]
        return self.osdw_decoding


# v1 spellings (reference ``__init__.py:1`` re-export and README usage)
bposd_decoder = BpOsdDecoder
bp_decoder = BpDecoder
