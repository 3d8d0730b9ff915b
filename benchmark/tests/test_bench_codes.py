"""The benchmark's frozen code constructions give the program's matrices."""

import numpy as np
import pytest

from benchmark import codes

PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]


def test_hgp400_is_the_ports():
    from bp_osd_tpu_torch.codes import hgp, mkmn_16_4_6

    H, proto, lift = codes.build({"family": "hgp", "seed": "mkmn_16_4_6"})
    assert proto is None and lift is None
    assert H.shape == (192, 400) and int(H.sum()) == 1344
    assert np.array_equal(H, hgp(mkmn_16_4_6()).hx.toarray())


@pytest.mark.parametrize("lift", [7, 13, 60])
def test_lifted_product_is_the_ports(lift):
    from bp_osd_tpu_torch.codes import lifted_hgp

    H, proto, L = codes.build({"family": "lifted_hgp", "lift": lift,
                               "proto": [[list(e) for e in row] for row in PROTO]})
    q = lifted_hgp(PROTO, lift=lift)
    assert L == lift and proto == q.hx_proto
    assert np.array_equal(H, q.hx.toarray())
    assert H.shape == (12 * lift, 25 * lift)


def test_config_files_state_their_codes():
    import json
    import os

    from benchmark.spec import HERE

    for name in ("hgp400", "lifted10000"):
        with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
            conf = json.load(f)
        H, _, _ = codes.build(conf["code"])
        par = conf["parameters"]
        assert H.shape == (par["m"], par["n"])
        assert int(H.sum()) == par["edges"]
        assert int(H.sum(1).max()) == par["row_weight"]
        assert int(H.sum(0).max()) == par["column_weight"]
