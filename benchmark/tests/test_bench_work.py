"""The needed-work counts: the operations of ``utils/measure.py``, and a
bound that no stage schedule or kernel route moves."""

import numpy as np
import pytest
import torch

from benchmark import codes, reference, work

PROTO = [[[0], [0], [0], [0]], [[0], [1], [2], [3]], [[0], [2], [4], [6]]]


def _hgp():
    H, _, _ = codes.build({"family": "hgp", "seed": "mkmn_16_4_6"})
    return H


def _syndromes(H, p, rows, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((rows, H.shape[1])) < p).astype(np.int64)
    return torch.from_numpy((err @ H.T.astype(np.int64) % 2).astype(np.uint8))


def test_peaks_are_the_ports():
    from bp_osd_tpu_torch.utils import measure

    assert (work.HBM_BYTES_S, work.F32_OPS_S, work.INT_OPS_S) == (
        measure.HBM_BYTES_S, measure.F32_OPS_S, measure.INT_OPS_S)
    w = work.Work(1e9, 2e12, 3e12)
    assert w.seconds() == pytest.approx(measure.bound_ms(1e9, 2e12, 3e12).ms / 1e3)


@pytest.mark.parametrize("rows,its", [(1, 1), (37, 911), (16384, 123456)])
def test_bp_operations_are_k1s(rows, its):
    from bp_osd_tpu_torch.decoder import TannerGraph
    from bp_osd_tpu_torch.utils import measure

    H = _hgp()
    g = TannerGraph(H, device="cpu")
    b = measure.k1_bound(g, rows, its, prior_rows=1, v2c_in=False, emit=False)
    w = work.bp_work(g.m, g.n, int(H.sum()), 1, rows, its)
    assert (w.float_ops, w.int_ops) == (b.float_ops, b.int_ops)
    assert w.nbytes <= b.nbytes  # the graph's edges once, not K1's tables


def test_bp_operations_are_k6s():
    from bp_osd_tpu_torch.codes import lifted_hgp
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph
    from bp_osd_tpu_torch.utils import measure

    q = lifted_hgp([[tuple(e) for e in row] for row in PROTO], lift=20)
    g = LiftedGraph(q.hx_proto, 20, "cpu")
    its = torch.tensor([1, 5, 100, 100, 37], dtype=torch.int32)
    for route in (False, True):
        b = measure.k6_bound(g, its, prior_rows=1, device_route=route)
        w = work.bp_work(g.m, g.n, int(q.hx.sum()), 1, 5, int(its.sum()))
        assert (w.float_ops, w.int_ops) == (b.float_ops, b.int_ops)


def test_osd_operations_are_osd_cs_bounds():
    from bp_osd_tpu_torch.decoder import TannerGraph
    from bp_osd_tpu_torch.decoder.osd import build_osd_consts
    from bp_osd_tpu_torch.utils import measure

    H = _hgp()
    synd = _syndromes(H, 0.06, 64, 11)
    fg = reference.FloodGraph(H, "cpu")
    dec = {"bp_method": "minimum_sum", "ms_scaling_factor": 0.0, "max_iter": 400,
           "osd_method": "osd_cs", "osd_order": 42}
    bp = reference.flood_bp(fg, synd, reference.prior(0.06, 400), dec)
    f = ~bp.converged
    o = reference.osd_cs(fg, synd[f], bp.llr[f], dec)
    g = TannerGraph(H, device="cpu")
    perm = torch.argsort(bp.llr[f], dim=1, stable=True).to(torch.int32)
    b, _ = measure.osd_cs_bound(g, perm, synd[f], build_osd_consts(g, "osd_cs", 42).pairs)
    w = work.osd_cs_work(g.m, g.n, g.rank, 42, 1, int(f.sum()), float(o.elim_ops.sum()))
    assert w.int_ops == b.int_ops and w.nbytes == b.nbytes


def test_bound_does_not_move_with_the_stage_schedule():
    """The same rows decoded in other stages run the same iterations, so the
    needed work is one number, while the port's staged bound (which counts
    the resumed state) moves with the schedule."""
    from bp_osd_tpu_torch.decoder import TannerGraph, decode_pipeline
    from bp_osd_tpu_torch.utils import measure

    H = _hgp()
    g = TannerGraph(H, device="cpu")
    synd = _syndromes(H, 0.05, 128, 13)
    llr0 = reference.prior(0.05, 400)
    needed, staged = set(), set()
    for stage1 in (None, 32, (8, 32, 128), 400):
        out = decode_pipeline(g, synd, llr0, bp_method="minimum_sum", max_iter=400,
                              ms_scaling_factor=0.0, osd_method="osd_cs", osd_order=42,
                              stage1_iters=stage1)
        its = out.iterations
        w = work.bp_work(g.m, g.n, int(H.sum()), 1, 128, int(its.long().sum()))
        needed.add(w)
        staged.add(measure.staged_k1_bound(g, its, 400, stage1).nbytes)
    assert len(needed) == 1
    assert len(staged) > 1
