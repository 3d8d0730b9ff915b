"""A run at a small size on the CPU, skipping only the look for a card: a
sound program comes out correct, and each fault the cells can have, planted
in the timed path, comes out not correct.  The control (the reference with
bfloat16 messages in the program's place) comes out not correct too."""

import json

import pytest
import torch

from benchmark import cell, control, spec

SMALL = {"hgp400.p05.b16384": {}, "lifted10000.p028.b512": {"lift": 13}}


def small(name):
    c = spec.cell(name)
    conf = json.loads(json.dumps(c.config))
    if "lift" in SMALL[name]:
        conf["code"]["lift"] = SMALL[name]["lift"]
    tr = dict(c.traffic, batch=48, pool=3, check_batches=2, check_osd_rows=12)
    if name.startswith("lifted"):
        tr["p"] = 0.06
    return c._replace(config=conf, traffic=tr)


def run_small(name, seed=2**31 + 7):
    import time

    return cell.run(name, seed, 0.2, False, t_start=time.perf_counter(), device="cpu",
                    cell=small(name))


def _answer(dec):
    osdw = dec.osdw_decoding_batch.clone()
    osdw[0, 0] ^= 1
    dec.osdw_decoding_batch = osdw


def _iterations(dec):
    it = dec.iter_batch.clone()
    it[-1] += 1
    dec.iter_batch = it


def _half(dec):
    h = dec.bp_decoding_batch.shape[0] // 2
    for attr in ("bp_decoding_batch", "osd0_decoding_batch", "osdw_decoding_batch",
                 "converge_batch", "iter_batch"):
        x = getattr(dec, attr).clone()
        x[h:] = 0
        setattr(dec, attr, x)


def _no_osd(dec):
    dec.osd0_decoding_batch = dec.bp_decoding_batch.clone()
    dec.osdw_decoding_batch = dec.bp_decoding_batch.clone()


FAULTS = {"answer_altered": _answer, "iterations_altered": _iterations,
          "half_the_batch_left_out": _half, "osd_skipped": _no_osd}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    out = run_small(name)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["osd_rows_checked"]["value"] >= 1
    assert set(out["metrics"]) == {"syndromes_per_s", "batch_ms_p95", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_fault_is_not_correct(name, fault, monkeypatch):
    from bp_osd_tpu_torch.decoder.bposd import BpOsdDecoder

    orig = BpOsdDecoder.decode_batch

    def decode_batch(self, *args, **kw):
        orig(self, *args, **kw)
        FAULTS[fault](self)
        return self.osdw_decoding_batch

    monkeypatch.setattr(BpOsdDecoder, "decode_batch", decode_batch)
    out = run_small(name)
    assert out["correct"] is False


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name):
    for seed in (1, 2, 3):
        out = control.control(name, seed, device="cpu", cell=small(name))
        assert out["correct"] is False
        assert out["checks"]["bp_rows_differ"] > 0


def test_no_card_no_result(capsys):
    from benchmark import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "hgp400.p05.b16384", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card(card, capsys):
    from benchmark import run

    assert run.main(["--workload", "hgp400.p05.b16384", "--seed", "5", "--seconds", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
