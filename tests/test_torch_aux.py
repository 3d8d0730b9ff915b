"""The flagship aux corpora of ``tests/data/aux_corpora.npz`` (made by the JAX
package: ``tests/make_aux_corpora.py``) decoded through bp_osd_tpu_torch's
``BpOsdDecoder`` on the CPU."""

import os

import numpy as np
import pytest
import torch

from bp_osd_tpu_torch import BpOsdDecoder
from bp_osd_tpu_torch.codes import hgp, mkmn_16_4_6

torch.set_num_threads(1)

AUX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "aux_corpora.npz")
# tests/make_aux_corpora.py:29-41, all at p = 0.05 on the [[400,16,6]] flagship
CONFIGS = {
    "flagship_ps": dict(bp_method="product_sum", ms_scaling_factor=1.0, max_iter=400,
                        osd_method="osd_cs", osd_order=42),
    "flagship_ms_fixed": dict(bp_method="minimum_sum", ms_scaling_factor=0.625, max_iter=400,
                              osd_method="osd_cs", osd_order=42),
    "flagship_osd_e": dict(bp_method="minimum_sum", ms_scaling_factor=0.0, max_iter=100,
                           osd_method="osd_e", osd_order=12),
}


def _decode(name):
    data = np.load(AUX)
    _, m, n = (int(x) for x in data[f"{name}_shape"])
    synd = np.unpackbits(data[f"{name}_synd"], axis=1)[:, :m]
    H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
    dec = BpOsdDecoder(H, error_rate=0.05, **CONFIGS[name])
    osdw = dec.decode_batch(synd)
    ref = np.unpackbits(data[f"{name}_osdw"], axis=1)[:, :n]
    return dec, H, synd, osdw, ref, data


@pytest.mark.parametrize("name", ["flagship_osd_e", "flagship_ms_fixed"])
def test_min_sum_aux_corpus_reproduced(name):
    """osdw, converged and iterations equal the corpus bit for bit."""
    dec, _, _, osdw, ref, data = _decode(name)
    assert np.array_equal(osdw, ref)
    assert np.array_equal(dec.converge_batch, data[f"{name}_conv"])
    assert np.array_equal(dec.iter_batch, data[f"{name}_iters"])
    assert (~dec.converge_batch).any()  # the OSD tail carries part of the pin


def test_product_sum_aux_corpus_agreement():
    """Product-sum llr agrees with JAX only to ~1e-4 (torch and XLA round
    tanh/atanh differently, ``tests/test_torch_bp.py``), which can move a
    deep trajectory: every osdw satisfies its syndrome and at least 95% of
    the rows equal the corpus's osdw."""
    dec, H, synd, osdw, ref, _ = _decode("flagship_ps")
    assert np.array_equal(osdw @ H.T % 2, synd)
    assert (osdw == ref).all(1).mean() >= 0.95
