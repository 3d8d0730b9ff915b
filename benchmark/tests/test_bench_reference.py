"""The reference reproduces the committed corpora bit for bit, agrees with
the program's plain versions, and its control does not."""

import os

import numpy as np
import pytest
import torch

from benchmark import codes, reference

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "tests", "data")
PROTO = [[[0], [0], [0], [0]], [[0], [1], [2], [3]], [[0], [2], [4], [6]]]


def _decoder(max_iter, scale, order):
    return {"bp_method": "minimum_sum", "ms_scaling_factor": scale, "max_iter": max_iter,
            "osd_method": "osd_cs", "osd_order": order}


def _decode(bp_fn, fg, synd, order):
    bp = bp_fn(synd)
    f = ~bp.converged
    o = reference.osd_cs(fg, synd[f], bp.llr[f], _decoder(0, 0.0, order))
    osdw = bp.hard.clone()
    osdw[f] = o.osdw
    return bp, osdw, int(f.sum())


def test_flagship_corpus_reproduced():
    d = np.load(os.path.join(DATA, "flagship_corpus.npz"))
    B, m, n, max_iter, order, _ = (int(x) for x in d["meta"])
    H, _, _ = codes.build({"family": "hgp", "seed": "mkmn_16_4_6"})
    synd = torch.from_numpy(np.unpackbits(d["synd_packed"], axis=1)[:, :m].copy())
    fg = reference.FloodGraph(H, "cpu")
    bp, osdw, fails = _decode(lambda s: reference.flood_bp(
        fg, s, reference.prior(0.05, n), _decoder(max_iter, 0.0, order)), fg, synd, order)
    assert fails > 0
    assert np.array_equal(bp.converged.numpy(), d["converged"])
    assert np.array_equal(bp.iterations.numpy(), d["iterations"])
    assert np.array_equal(osdw.numpy(), np.unpackbits(d["osdw_packed"], axis=1)[:, :n])
    assert np.array_equal(osdw.sum(1).numpy(), d["weights"])


def test_lifted_streamed_corpus_reproduced():
    a = np.load(os.path.join(DATA, "aux_corpora.npz"))
    B, m, n = (int(x) for x in a["lifted_streamed_shape"])
    H, proto, L = codes.build({"family": "lifted_hgp", "proto": PROTO, "lift": 60})
    synd = torch.from_numpy(np.unpackbits(a["lifted_streamed_synd"], axis=1)[:, :m].copy())
    lg, fg = reference.LiftedGraph(proto, L, "cpu"), reference.FloodGraph(H, "cpu")
    bp, osdw, fails = _decode(lambda s: reference.lifted_bp(
        lg, s, reference.prior(0.05, n), _decoder(12, 0.625, 15)), fg, synd, 15)
    assert fails > B // 2
    assert np.array_equal(bp.converged.numpy(), a["lifted_streamed_conv"])
    assert np.array_equal(bp.iterations.numpy(), a["lifted_streamed_iters"])
    assert np.array_equal(np.packbits(osdw.numpy(), axis=1), a["lifted_streamed_osdw"])


def _syndromes(H, p, rows, seed):
    rng = np.random.default_rng(seed)
    err = (rng.random((rows, H.shape[1])) < p).astype(np.int64)
    return torch.from_numpy((err @ H.T.astype(np.int64) % 2).astype(np.uint8))


@pytest.mark.parametrize("scale", [0.0, 0.625])
def test_flood_bp_and_osd_equal_the_plain_versions(scale):
    from bp_osd_tpu_torch.decoder import TannerGraph
    from bp_osd_tpu_torch.decoder.bp import bp_decode_plain
    from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode_plain
    from bp_osd_tpu_torch.utils.measure import elim_work

    H, _, _ = codes.build({"family": "hgp", "seed": "mkmn_16_4_6"})
    synd = _syndromes(H, 0.06, 96, 5)
    llr0 = reference.prior(0.06, 400)
    g, fg = TannerGraph(H, device="cpu"), reference.FloodGraph(H, "cpu")
    want = bp_decode_plain(g, synd, llr0.expand(96, 400), method="minimum_sum", max_iter=60,
                           ms_scaling_factor=scale)
    got = reference.flood_bp(fg, synd, llr0, _decoder(60, scale, 42))
    for a, b in zip(want[:4], got):
        assert torch.equal(a, b)
    f = ~got.converged
    assert int(f.sum()) > 0 and fg.rank == g.rank
    perm = torch.argsort(got.llr[f], dim=1, stable=True).to(torch.int32)
    c = build_osd_consts(g, "osd_cs", 42)
    w0, ww = osd_decode_plain(g, perm, synd[f], method="osd_cs", osd_order=42, pairs=c.pairs)
    o = reference.osd_cs(fg, synd[f], got.llr[f], _decoder(60, scale, 42))
    assert torch.equal(w0, o.osd0) and torch.equal(ww, o.osdw)
    w = elim_work(g, perm, synd[f])
    assert np.array_equal(2 * w.Wm * w.steps + 2 * w.pivot_tests + w.xor_words,
                          o.elim_ops.numpy())


@pytest.mark.parametrize("scale", [0.0, 0.625])
def test_lifted_bp_and_osd_equal_the_plain_versions(scale):
    from bp_osd_tpu_torch.decoder import TannerGraph
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, _bp_rows
    from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode_plain

    H, proto, L = codes.build({"family": "lifted_hgp", "proto": PROTO, "lift": 13})
    m, n = H.shape
    synd = _syndromes(H, 0.07, 24, 7)
    llr0 = reference.prior(0.07, n)
    want = _bp_rows(LiftedGraph(proto, L, "cpu"), synd, llr0.expand(24, n), "minimum_sum",
                    20, scale)
    got = reference.lifted_bp(reference.LiftedGraph(proto, L, "cpu"), synd, llr0,
                              _decoder(20, scale, 15))
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    f = ~got.converged
    g, fg = TannerGraph(H, device="cpu"), reference.FloodGraph(H, "cpu")
    assert int(f.sum()) > 0 and fg.rank == g.rank
    perm = torch.argsort(got.llr[f], dim=1, stable=True).to(torch.int32)
    c = build_osd_consts(g, "osd_cs", 15)
    w0, ww = osd_decode_plain(g, perm, synd[f], method="osd_cs", osd_order=15, pairs=c.pairs)
    o = reference.osd_cs(fg, synd[f], got.llr[f], _decoder(20, scale, 15))
    assert torch.equal(w0, o.osd0) and torch.equal(ww, o.osdw)


def test_syndromes_of_is_H_times_x():
    H, _, _ = codes.build({"family": "hgp", "seed": "mkmn_16_4_6"})
    x = torch.from_numpy((np.random.default_rng(3).random((9, 400)) < 0.1).astype(np.uint8))
    want = (x.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    got = reference.syndromes_of(reference.FloodGraph(H, "cpu"), x)
    assert np.array_equal(got.numpy(), want)
