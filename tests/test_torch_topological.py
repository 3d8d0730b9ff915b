"""bp_osd_tpu_torch surface and toric codes against the JAX package."""

import numpy as np
import pytest

from bp_osd_tpu.codes import surface_code as jsurface_code
from bp_osd_tpu.codes import toric_code as jtoric_code

from bp_osd_tpu_torch.codes import surface_code, toric_code


@pytest.mark.parametrize("family", ["surface", "toric"])
@pytest.mark.parametrize("d", [2, 3, 4, 5])
def test_matrices_and_parameters_equal_jax(family, d):
    mine = (surface_code if family == "surface" else toric_code)(d)
    ref = (jsurface_code if family == "surface" else jtoric_code)(d)
    for attr in ("hx", "hz", "lx", "lz"):
        assert np.array_equal(getattr(mine, attr).toarray(), getattr(ref, attr).toarray()), attr
    assert (mine.N, mine.K) == (ref.N, ref.K)
    assert (mine.N, mine.K) == ((d * d + (d - 1) ** 2, 1) if family == "surface"
                                else (2 * d * d, 2))


@pytest.mark.parametrize("family", ["surface", "toric"])
def test_distance_three(family):
    code = (surface_code if family == "surface" else toric_code)(3, compute_distance=True)
    assert code.D == 3 and code.test(show_tests=False)
