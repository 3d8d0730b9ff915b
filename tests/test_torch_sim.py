"""bp_osd_tpu_torch Monte-Carlo harness against the JAX harness.

Both harnesses are fed the same uniforms: the JAX chain ``PRNGKey(seed)`` ->
``split`` -> ``split(sub, B)`` -> ``vmap(uniform)``, computed here and handed
to the port's ``_batch_stats`` (or its ``_draw``).  Per-sample outcomes and
whole-run counters are compared exactly.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from bp_osd_tpu.codes import hgp as jhgp
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6
from bp_osd_tpu.codes import rep_code as jrep_code
from bp_osd_tpu.sim import css_decode_sim as jcss_decode_sim

from bp_osd_tpu_torch.codes import hgp, rep_code
from bp_osd_tpu_torch.parallel import Mesh, cpu_mesh
from bp_osd_tpu_torch.sim import css_decode_sim
from bp_osd_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX harness's own test configuration (tests/test_sim.py), at p = 0.1
SURFACE_OPTS = dict(error_rate=0.1, bp_method="ms", ms_scaling_factor=0.625,
                    osd_method="osd_cs", osd_order=4, max_iter=10, seed=42,
                    tqdm_disable=1, run_sim=0)
# examples/qldpc_decode_example.py
FLAGSHIP_OPTS = dict(error_rate=0.05, bp_method="ms", ms_scaling_factor=0,
                     osd_method="osd_cs", osd_order=42, max_iter=0, seed=42,
                     tqdm_disable=1, run_sim=0, check_code=0)


@pytest.fixture(scope="module")
def surface():
    return jhgp(jrep_code(3), jrep_code(3))


@pytest.fixture(scope="module")
def flagship():
    return jhgp(jmkmn_16_4_6())


def _jax_uniforms(seed: int, B: int, N: int, batches: int):
    """The JAX harness's per-batch ``(sub key, uniforms [B, N])``."""
    key = jax.random.PRNGKey(seed)
    draw = jax.vmap(lambda k: jax.random.uniform(k, (N,)))
    out = []
    for _ in range(batches):
        key, sub = jax.random.split(key)
        out.append((sub, np.array(draw(jax.random.split(sub, B)))))
    return out


def _pair(code, **opts):
    """The JAX harness (XLA on the CPU, no mesh) and the port's (plain torch)."""
    j = jcss_decode_sim(hx=code.hx, hz=code.hz, use_mesh=0, backend="xla", **opts)
    t = css_decode_sim(hx=code.hx, hz=code.hz, backend="torch", **opts)
    return j, t


def _stats_equal(j, t, B: int):
    """Per-sample outcomes of one batch on identical uniforms."""
    (sub, rand), = _jax_uniforms(j.seed, B, j.N, 1)
    want = {k: np.asarray(v) for k, v in j._batch_fn(sub).items()}
    got = {k: v.numpy() for k, v in t._batch_stats(torch.from_numpy(rand)).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (B,), k
        assert np.array_equal(got[k], want[k]), k
    return got


@pytest.mark.parametrize("channel_update,bias", [
    (None, [1, 1, 1]),
    ("x->z", [1, 1, 1]),
    ("z->x", [1, 1, 1]),
    (None, [0, 0, 1]),
    ("x->z", [1, 1, 0.5]),
    ("z->x", [1, 1, 0.5]),
    ("x->z", [np.inf, 1, 1]),
    ("z->x", [1, np.inf, 1]),
    (None, [1, 1, np.inf]),
])
def test_batch_outcomes_equal_jax_surface(surface, channel_update, bias):
    j, t = _pair(surface, channel_update=channel_update, xyz_error_bias=bias,
                 batch_size=200, **SURFACE_OPTS)
    got = _stats_equal(j, t, 200)
    assert 0 < got["osdw_success"].sum() < 200  # the batch holds failures


def test_batch_above_the_chunk_equal_jax(surface):
    """A batch of 4100 decodes in chunks of 4096 on the CPU, the per-sample
    Bayes prior sliced with its rows."""
    j, t = _pair(surface, channel_update="x->z", xyz_error_bias=[1, 1, 1], batch_size=4100,
                 **SURFACE_OPTS)
    assert t._chunk == 4096
    _stats_equal(j, t, 4100)


def test_batch_outcomes_equal_jax_hadamard_rotate(surface):
    j, t = _pair(surface, channel_update="x->z", xyz_error_bias=[1, 0, 3],
                 hadamard_rotate=1, hadamard_rotate_sector1_length=9, batch_size=200,
                 **SURFACE_OPTS)
    assert np.array_equal(t.channel_probs_x, j.channel_probs_x)
    assert np.array_equal(t.channel_probs_z, j.channel_probs_z)
    _stats_equal(j, t, 200)


@pytest.mark.parametrize("channel_update,bias", [(None, [0, 0, 1]), ("x->z", [1, 1, 1])])
def test_batch_outcomes_equal_jax_flagship(flagship, channel_update, bias):
    """The [[400,16,6]] flagship at B = 64: the example's configuration (pure
    Z, no update) and the harness's default update on the full channel, which
    decodes hz too; both sides equal JAX per sample."""
    j, t = _pair(flagship, channel_update=channel_update, xyz_error_bias=bias,
                 batch_size=64, **FLAGSHIP_OPTS)
    got = _stats_equal(j, t, 64)
    if bias == [0, 0, 1]:
        assert got["bp_converge_x"].all()
    assert not got["bp_converge_z"].all()


@pytest.mark.parametrize("batch_size", [100, 128])
def test_whole_run_counters_equal_jax(surface, batch_size, tmp_path):
    """300 runs in batches of 100, and of 128 (a partial last batch of 44):
    the port driven with JAX's uniforms counts what JAX counts."""
    opts = dict(SURFACE_OPTS, error_rate=0.08, target_runs=300, batch_size=batch_size,
                channel_update="x->z")
    j, t = _pair(surface, **opts)
    batches = -(-300 // batch_size)
    feed = iter([torch.from_numpy(r) for _, r in _jax_uniforms(t.seed, batch_size, t.N,
                                                               batches)])
    t._draw = lambda: next(feed)
    t.output_file = str(tmp_path / "out.json")
    want = json.loads(j.run_decode_sim())
    got = json.loads(t.run_decode_sim())
    assert got["run_count"] == 300
    for key in ("run_count", "bp_converge_count_x", "bp_converge_count_z", "bp_success_count",
                "osd0_success_count", "osdw_success_count", "min_logical_weight",
                "osdw_logical_error_rate", "osdw_logical_error_rate_eb",
                "osd0_logical_error_rate", "bp_logical_error_rate", "osdw_word_error_rate"):
        assert got[key] == want[key], key
    assert got["osdw_success_count"] < 300
    with open(t.output_file) as f:
        assert json.load(f)["run_count"] == 300


@pytest.mark.parametrize("shards", [2, 4])
def test_whole_run_counters_equal_jax_on_a_mesh(surface, shards, tmp_path):
    """use_mesh=1 on both sides: JAX over its 8 virtual devices, the port over
    a CPU mesh of 2 and 4 shards, each rounding a batch of 103 up to 104; fed
    JAX's uniforms, the port counts what JAX counts, and what its own
    unsharded run counts."""
    opts = dict(SURFACE_OPTS, error_rate=0.08, target_runs=300, batch_size=103,
                channel_update="x->z")
    j = jcss_decode_sim(hx=surface.hx, hz=surface.hz, use_mesh=1, backend="xla", **opts)
    t = css_decode_sim(hx=surface.hx, hz=surface.hz, backend="torch", use_mesh=1,
                       mesh=cpu_mesh(shards), **opts)
    plain = css_decode_sim(hx=surface.hx, hz=surface.hz, backend="torch", use_mesh=0,
                           **dict(opts, batch_size=104))
    assert (j.use_mesh, t.use_mesh, j.batch_size, t.batch_size) == (1, 1, 104, 104)
    rand = [torch.from_numpy(r) for _, r in _jax_uniforms(t.seed, 104, t.N, 3)]
    t._draw, plain._draw = iter(rand).__next__, iter(rand).__next__
    t.output_file = str(tmp_path / "out.json")
    want = json.loads(j.run_decode_sim())
    got = json.loads(t.run_decode_sim())
    unsharded = json.loads(plain.run_decode_sim())
    assert got["run_count"] == 300
    for key in ("run_count", "bp_converge_count_x", "bp_converge_count_z", "bp_success_count",
                "osd0_success_count", "osdw_success_count", "min_logical_weight",
                "osdw_logical_error_rate", "osdw_logical_error_rate_eb",
                "osd0_logical_error_rate", "bp_logical_error_rate", "osdw_word_error_rate"):
        assert got[key] == want[key] == unsharded[key], key
    assert got["osdw_success_count"] < 300
    with open(t.output_file) as f:
        assert json.load(f)["run_count"] == 300


def test_output_dict_keys_equal_jax(surface):
    j, t = _pair(surface, target_runs=50, batch_size=50, **SURFACE_OPTS)
    want = json.loads(j.run_decode_sim())
    got = json.loads(t.run_decode_sim())
    assert set(got) == set(want)
    assert (got["N"], got["K"], got["use_mesh"], got["backend"]) == (13, 1, 0, "torch")
    assert got["osdw_logical_error_rate"] == 1 - got["osdw_success_count"] / 50


def test_sim_resume_from_output_dict():
    """tests/test_sim.py:122-132 on the port: counters restored, seed
    re-randomized, the run continued to the new target."""
    code = hgp(rep_code(3), rep_code(3))
    opts = dict(SURFACE_OPTS, target_runs=100, batch_size=50, channel_update=None)
    sim = css_decode_sim(hx=code.hx, hz=code.hz, **opts)
    sim.run_decode_sim()
    saved = json.loads(sim.output_dict())
    saved["target_runs"] = 150
    saved["run_sim"] = 0
    resumed = css_decode_sim(hx=code.hx, hz=code.hz, **saved)
    assert resumed.run_count == 100
    assert resumed.osdw_success_count == saved["osdw_success_count"]
    assert resumed.seed != saved["seed"] or saved["seed"] == 0
    resumed.run_decode_sim()
    assert resumed.run_count == 150
    assert resumed.osdw_success_count >= saved["osdw_success_count"]


def test_sim_invalid_code_raises():
    h = rep_code(7)
    with pytest.raises(Exception, match="invalid CSS code"):
        css_decode_sim(hx=h, hz=h, error_rate=0.05, run_sim=0)


def test_sim_options():
    code = hgp(rep_code(3), rep_code(3))
    kw = dict(hx=code.hx, hz=code.hz, error_rate=0.05, run_sim=0, tqdm_disable=1)
    sim = css_decode_sim(target_runs=5000, **kw)
    assert (sim.batch_size, sim.use_mesh, sim.backend) == (1024, 0, "torch")
    assert css_decode_sim(target_runs=7, **kw).batch_size == 7
    # use_mesh: one CPU shard by default, the batch rounded up to the shards
    one = css_decode_sim(use_mesh=1, target_runs=7, **kw)
    assert (one.use_mesh, one.batch_size) == (1, 7)
    four = css_decode_sim(use_mesh=1, mesh=cpu_mesh(4), target_runs=7, **kw)
    assert (four.use_mesh, four.batch_size) == (1, 8)
    assert "mesh" not in json.loads(four.output_dict())
    # -1 takes the mesh only with several processes, whatever the mesh
    for mesh in (None, cpu_mesh(1), cpu_mesh(4)):
        auto = css_decode_sim(use_mesh=-1, mesh=mesh, target_runs=7, **kw)
        assert (auto.use_mesh, auto.batch_size) == (0, 7)
    with pytest.raises(ValueError, match="mesh"):
        css_decode_sim(use_mesh=1, mesh=Mesh((torch.device("cuda", 0),)), **kw)
    for bad in ("xla", "pallas"):
        with pytest.raises(ValueError, match="backend"):
            css_decode_sim(backend=bad, **kw)
    with pytest.raises(ValueError, match="channel_update"):
        css_decode_sim(channel_update="x->y", **kw)


def test_sim_early_stop_at_precision_cutoff(surface):
    """A loose cutoff stops the run at the first checkpoint (every batch
    checkpoints with a negative save interval)."""
    sim = css_decode_sim(hx=surface.hx, hz=surface.hz, backend="torch", target_runs=1000,
                         batch_size=100, error_bar_precision_cutoff=10.0, save_interval=-1,
                         **SURFACE_OPTS)
    out = json.loads(sim.run_decode_sim())
    assert out["run_count"] == 100


def test_profiling_helpers(tmp_path):
    x = torch.arange(6.0)
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        with profiling.Timer() as t:
            tree = profiling.block({"a": [x * 2, (x + 1,)], "b": None})
    assert t.elapsed >= 0 and tree["a"][0][1].item() == 2.0
    files = os.listdir(log_dir)
    assert any(f.endswith(".json") for f in files)


def test_example_writes_only_where_told(tmp_path, monkeypatch):
    """The flagship example at a tiny size, run from tmp_path: it writes its
    default output there, and neither a file of that name nor a change to
    the committed artifacts appears at the repo root or under examples/."""
    from bp_osd_tpu_torch.examples import qldpc_decode_example

    committed = [os.path.join(ROOT, d, "qldpc_decode_results.json") for d in ("", "examples")]

    def contents():
        return [open(p, "rb").read() for p in committed]

    before = contents()
    monkeypatch.chdir(tmp_path)
    out = qldpc_decode_example.main(["--runs", "32", "--batch-size", "32"])
    assert os.listdir(tmp_path) == ["qldpc_decode_results_torch.json"]
    with open(tmp_path / "qldpc_decode_results_torch.json") as f:
        saved = json.load(f)
    assert saved["run_count"] == 32 == json.loads(out)["run_count"]
    assert saved["bp_converge_count_x"] == 32  # pure Z: the X side never errs
    for d in ("", "examples"):
        assert not os.path.exists(os.path.join(ROOT, d, "qldpc_decode_results_torch.json"))
    assert contents() == before
