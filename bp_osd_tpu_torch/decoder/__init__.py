"""Batched BP+OSD decoding on torch tensors: plain torch on the CPU, the
hand-written CUDA kernels on the card."""

from .bp import BPResult, bp_decode, llr_from_channel
from .bposd import BpDecoder, BpOsdDecoder, bp_decoder, bposd_decoder
from .layered import LayeredTannerGraph, bp_decode_layered
from .osd import OsdResult, osd_decode
from .pipeline import BpOsdBatch, decode_pipeline
from .tanner import TannerGraph

__all__ = [
    "TannerGraph",
    "BPResult",
    "bp_decode",
    "llr_from_channel",
    "OsdResult",
    "osd_decode",
    "BpOsdBatch",
    "decode_pipeline",
    "BpDecoder",
    "BpOsdDecoder",
    "bp_decoder",
    "bposd_decoder",
    "LayeredTannerGraph",
    "bp_decode_layered",
]
