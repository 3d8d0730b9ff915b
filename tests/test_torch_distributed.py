"""Two gloo processes on the CPU (tests/torch_distributed_worker.py) against
one process: bp_osd_tpu_torch.parallel.distributed and the harness's
``use_mesh=1`` across ranks.  The port's counterpart of
tests/test_distributed.py."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from bp_osd_tpu_torch.codes import hgp, rep_code
from bp_osd_tpu_torch.parallel import distributed, host_batch_slice, initialize, is_multi_host
from bp_osd_tpu_torch.sim import css_decode_sim

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_distributed_worker.py")
_ROOT = os.path.dirname(os.path.dirname(_WORKER))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _single_process_counters(target: int) -> dict:
    """The worker's harness run in one process without a mesh."""
    code = hgp(rep_code(3), rep_code(3))
    sim = css_decode_sim(hx=code.hx, hz=code.hz, error_rate=0.08, target_runs=target,
                         batch_size=32, xyz_error_bias=[1, 1, 1], bp_method="ms",
                         ms_scaling_factor=0.625, osd_method="osd_cs", osd_order=3,
                         max_iter=10, seed=5, use_mesh=0, backend="torch", tqdm_disable=1)
    return {k: getattr(sim, k) for k in ("run_count", "bp_converge_count_x",
                                         "bp_converge_count_z", "bp_success_count",
                                         "osd0_success_count", "osdw_success_count",
                                         "min_logical_weight")}


def test_two_process_sharded_decode_and_harness(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE")}
    env["PYTHONPATH"] = _ROOT
    procs = [subprocess.Popen([sys.executable, _WORKER, str(pid), "2", str(port), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"distributed workers timed out; partial output: {outs}")
    finally:
        for p in procs:  # no worker outlives the test
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER_OK pid={pid}" in out, out
        assert f"WORKER_OK2 pid={pid}" in out, out
        lines.append(next(ln for ln in out.splitlines() if ln.startswith("WORKER_OK3")))
    got = [json.loads(ln.split(" ", 2)[2]) for ln in lines]
    assert got[0] == got[1]  # both ranks hold the reduced totals
    # 64 runs are two whole batches; 70 runs three, the last one not trimmed
    assert got[0]["64"] == _single_process_counters(64)
    assert got[0]["70"]["run_count"] == 96
    assert got[0]["70"] == _single_process_counters(96)
    assert sorted(os.listdir(tmp_path)) == ["sim_64_rank0.json", "sim_70_rank0.json"]
    with open(tmp_path / "sim_70_rank0.json") as f:
        assert json.load(f)["run_count"] == 96


def test_initialize_single_process_and_bad_arguments(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not torch.distributed.is_initialized()
    assert initialize() is False
    assert not is_multi_host() and host_batch_slice(32) == (0, 32)
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    with pytest.raises(ValueError, match="together"):
        initialize(coordinator_address="127.0.0.1:1234")
    with pytest.raises(ValueError, match="host:port"):
        initialize("127.0.0.1", 2, 0)
    with pytest.raises(ValueError, match="outside"):
        initialize(f"127.0.0.1:{_free_port()}", 2, 2)
    assert not torch.distributed.is_initialized()
