"""bp_osd_tpu_torch — the BP+OSD quantum LDPC decoder in PyTorch and CUDA.

A port of ``bp_osd_tpu`` (JAX/Pallas, written for a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA H100.  It imports torch and never
jax.  Same import surface as ``bp_osd_tpu``:

    from bp_osd_tpu_torch import bposd_decoder, BpOsdDecoder
    from bp_osd_tpu_torch.codes import css_code, stab_code, hgp
"""

import os as _os

from . import gf2
from .codes import css_code, gf2_to_gf4, hgp, hgp_single, stab_code
from .decoder import BpDecoder, BpOsdDecoder, bp_decoder, bposd_decoder

__version__ = "0.1.0"


def get_include() -> str:
    """Path of the installed package."""
    return _os.path.dirname(__file__)


__all__ = [
    "gf2",
    "css_code",
    "stab_code",
    "gf2_to_gf4",
    "hgp",
    "hgp_single",
    "BpOsdDecoder",
    "bposd_decoder",
    "BpDecoder",
    "bp_decoder",
    "get_include",
    "__version__",
]
