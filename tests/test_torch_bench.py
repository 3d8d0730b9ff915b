"""``bench_torch.py`` and ``bp_osd_tpu_torch/utils/measure.py`` on the CPU.

The modes' batches (seeded, run-unique, each mode its own), the
never-converging syndromes of ``lifted_shard`` against JAX's lifted BP and
the port's, ``spread``, the launch and harness gates, each gate against a
perturbed output, K1's bound from a decode's iterations against its
launches, a traced step without a card, every mode end to end at a tiny
size with ``device="cpu"`` (the test hook: the wrappers run their plain
versions, nothing is counted and no time is a device time), the script
without a card, and its imports.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bp_osd_tpu.decoder import llr_from_channel as jllr_from_channel
from bp_osd_tpu.decoder.lifted_bp import LiftedGraph as JLiftedGraph
from bp_osd_tpu.decoder.lifted_bp import bp_decode_lifted as jbp_decode_lifted

import bench_torch as bench
from bp_osd_tpu_torch.decoder.bp import llr_from_channel
from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
from bp_osd_tpu_torch.decoder.osd import build_osd_consts
from bp_osd_tpu_torch.decoder.tanner import TannerGraph
from bp_osd_tpu_torch.utils import measure
from bp_osd_tpu_torch.utils.measure import GateFailed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIFT = 16  # the CPU-sized lift of bench_large.py's protograph: [[400,36]], m = 192


@pytest.fixture(scope="module")
def flagship():
    qcode = bench.flagship_code("400")
    H = bench.dense(qcode.hx)
    return H, torch.as_tensor(H, dtype=torch.float32)


@pytest.fixture(scope="module")
def lifted():
    qcode = bench.lifted_code(LIFT)
    return qcode, bench.dense(qcode.hx)


def _batch_fn(mode, flagship, lifted):
    """The timed batch of ``(seed, step)`` in ``mode``, at small sizes."""
    H, H_f = flagship
    if mode in ("flagship", "api"):
        return lambda seed, s: bench.error_syndromes(bench.batch_rng(seed, mode, s), H_f, 0.05, 64)
    if mode == "large":
        Hl = torch.as_tensor(lifted[1], dtype=torch.float32)
        return lambda seed, s: bench.error_syndromes(bench.batch_rng(seed, mode, s), Hl, 0.03, 32)
    if mode == "lifted_shard":
        m = lifted[1].shape[0]
        return lambda seed, s: bench.random_syndromes(bench.batch_rng(seed, mode, s), m, 32, "cpu")
    return lambda seed, s: torch.tensor(bench.harness_seed(bench.batch_rng(seed, mode, s)))


@pytest.mark.parametrize("mode", bench.MODES)
def test_batches_are_seeded_and_run_unique(mode, flagship, lifted):
    """The same seed gives the same batches, another seed others, and no two
    steps of a run (the warm-up and traced batches included) are equal."""
    make = _batch_fn(mode, flagship, lifted)
    steps = list(range(6)) + [bench.EXTRA + k for k in range(bench.WARMUP + 1)]
    run = [make(3, s) for s in steps]
    again = [make(3, s) for s in steps]
    other = [make(4, s) for s in steps]
    assert all(torch.equal(a, b) for a, b in zip(run, again))
    assert not any(torch.equal(a, b) for a, b in zip(run, other))
    for i in range(len(run)):
        for j in range(i):
            assert not torch.equal(run[i], run[j]), (i, j)
    if mode != "harness":
        assert all(x.dtype == torch.uint8 and set(x.unique().tolist()) <= {0, 1} for x in run)


def test_modes_draw_their_own_batches(flagship):
    """A step's batch depends on the mode: flagship and api share the
    workload, not the batches."""
    _, H_f = flagship
    a, b = (bench.error_syndromes(bench.batch_rng(5, mode, 0), H_f, 0.05, 64)
            for mode in ("flagship", "api"))
    assert not torch.equal(a, b)


def test_error_syndromes_are_h_times_e():
    """``error_syndromes`` is ``H e mod 2`` of the errors the generator draws
    (``bench.py:135-138``, computed in numpy there)."""
    H = (np.random.default_rng(0).random((12, 30)) < 0.2).astype(np.uint8)
    got = bench.error_syndromes(np.random.default_rng(9), torch.as_tensor(H, dtype=torch.float32),
                                0.1, 50)
    errors = (np.random.default_rng(9).random((50, 30)) < 0.1).astype(np.uint8)
    assert np.array_equal(got.numpy(), errors @ H.T % 2)


def test_never_converging_syndromes(lifted):
    """``lifted_shard``'s uniform random syndromes at lift 16: no row
    converges within max_iter in JAX's lifted BP (XLA on the CPU) nor in the
    port's, on the same numpy inputs; every row runs all iterations."""
    qcode, H = lifted
    m, n = H.shape
    synd = bench.random_syndromes(bench.batch_rng(0, "lifted_shard", 0), m, 64, "cpu").numpy()
    kw = dict(bp_method="minimum_sum", max_iter=bench.LIFT_ITERS,
              ms_scaling_factor=bench.LIFT_MSF)
    j = jbp_decode_lifted(JLiftedGraph(qcode.hx_proto, LIFT), synd,
                          np.broadcast_to(np.asarray(jllr_from_channel(np.full(n, 0.005))),
                                          (64, n)), **kw)
    assert not np.asarray(j.converged).any()
    t = bp_decode_lifted(LiftedGraph(qcode.hx_proto, LIFT, "cpu"), synd,
                         llr_from_channel(np.full(n, 0.005)), **kw)
    assert not bool(t.converged.any())
    assert bool((t.iterations == bench.LIFT_ITERS).all())


def test_spread_on_known_samples():
    s = measure.spread([5.0, 1.0, 4.0, 2.0, 3.0])
    assert s == {"median": 3.0, "p25": 2.0, "p75": 4.0, "min": 1.0, "max": 5.0, "n": 5}
    s = measure.spread(np.arange(1, 41))  # 40 steps: p75 has 10 samples beyond it
    assert (s["median"], s["p25"], s["p75"], s["n"]) == (20.5, 10.75, 30.25, 40)
    assert measure.spread([7]) == {"median": 7.0, "p25": 7.0, "p75": 7.0, "min": 7.0,
                                   "max": 7.0, "n": 1}
    with pytest.raises(ValueError):
        measure.spread([])


@pytest.mark.parametrize("code", sorted(bench.ARTIFACTS))
def test_harness_gate(code):
    """The harness gate accepts each artifact's own point and refuses one 5
    combined standard errors away (on either side); 3.9 passes."""
    art = measure.artifact(bench.ARTIFACTS[code])
    ler, eb = art["osdw_logical_error_rate"], art["osdw_logical_error_rate_eb"]
    assert bench.held_to_artifact(dict(art), art, code) == 0.0
    for z, ok in ((3.9, True), (5.0, False), (-5.0, False)):
        out = {"osdw_logical_error_rate": ler + z * np.hypot(eb, eb),
               "osdw_logical_error_rate_eb": eb}
        if ok:
            assert bench.held_to_artifact(out, art, code) == pytest.approx(abs(z))
        else:
            with pytest.raises(GateFailed, match="void"):
                bench.held_to_artifact(out, art, code)


def test_launch_gate():
    """On the card each expected kernel launches on every step (or, for
    ``some``, on one step), and no other kernel launches; on the CPU nothing
    is counted and nothing is asked."""
    zero = {k: 0 for k in measure.KERNELS}
    good = [dict(zero, bp_flood=3, osd_cs=1), dict(zero, bp_flood=3, osd_cs=1)]
    total = bench.check_launches(good, every=("bp_flood", "osd_cs"), on_card=True, what="t")
    assert total["bp_flood"] == 6 and total["osd_cs"] == 2
    with pytest.raises(GateFailed, match="step 1 did not launch osd_cs"):
        bench.check_launches([good[0], dict(zero, bp_flood=3)], every=("bp_flood", "osd_cs"),
                             on_card=True, what="t")
    with pytest.raises(GateFailed, match="launched eliminate"):
        bench.check_launches([dict(good[0], eliminate=1)], every=("bp_flood", "osd_cs"),
                             on_card=True, what="t")
    with pytest.raises(GateFailed, match="no step launched osd_large"):
        bench.check_launches([zero, zero], some=("osd_large",), on_card=True, what="t")
    assert bench.check_launches([zero, dict(zero, osd_large=1)], some=("osd_large",),
                                on_card=True, what="t")["osd_large"] == 1
    assert bench.check_launches([zero], every=("bp_flood",), on_card=False,
                                what="t")["bp_flood"] == 0


def test_lifted_launch_gates_name_k6():
    """``large`` launches K6 on every step and K5 on some; in
    ``lifted_shard`` the unsharded BP and the 1 x 1 mesh launch K6 on every
    step, the 1 x 2 mesh nothing; each refuses K1 on the lifted path."""
    zero = {k: 0 for k in measure.KERNELS}
    assert measure.KERNELS["bp_lifted"] == ("K6", "bp_lifted.cu", ("bp_lifted_kernel",))
    large = [dict(zero, bp_lifted=1), dict(zero, bp_lifted=1, osd_large=1)]
    total = bench.check_launches(large, every=("bp_lifted",), some=("osd_large",),
                                 on_card=True, what="large")
    assert total["bp_lifted"] == 2 and total["osd_large"] == 1
    with pytest.raises(GateFailed, match="step 0 did not launch bp_lifted"):
        bench.check_launches([dict(zero, osd_large=1)], every=("bp_lifted",),
                             some=("osd_large",), on_card=True, what="large")
    with pytest.raises(GateFailed, match="launched bp_flood"):
        bench.check_launches([dict(large[1], bp_flood=1)], every=("bp_lifted",),
                             some=("osd_large",), on_card=True, what="large")
    bench.check_launches([zero, zero], on_card=True, what="lifted_shard sharded_1x2")
    with pytest.raises(GateFailed, match="launched bp_lifted"):
        bench.check_launches([dict(zero, bp_lifted=1)], on_card=True,
                             what="lifted_shard sharded_1x2")


def test_k6_bound_counts_the_rows_iterations(lifted):
    """K6's bound from the iterations each row ran: 2E + n + m float and
    7E + n integer operations a sample-iteration, the inputs and outputs
    once, the row state twice a sample-iteration on the device-memory
    route."""
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph

    g = LiftedGraph(lifted[0].hx_proto, LIFT, device="cpu")
    m, n, E = g.m, g.n, g.m * g.wr
    its = torch.tensor([3, 100, 1, 7], dtype=torch.int32)
    b = measure.k6_bound(g, its, prior_rows=1, device_route=False)
    assert b.float_ops == 111 * (2 * E + n + m) and b.int_ops == 111 * (7 * E + n)
    io = 4 * m + 4 * n + 4 * (2 * g.mp * g.wr + 3 * g.np_ * g.depth) + 4 * (5 * n + 5)
    assert b.nbytes == io
    d = measure.k6_bound(g, its, prior_rows=1, device_route=True)
    assert d.nbytes == io + 8 * (E + n) * 111
    assert d.float_ops == b.float_ops and d.int_ops == b.int_ops
    assert b.ms == max(b.nbytes / measure.HBM_BYTES_S, b.float_ops / measure.F32_OPS_S,
                       b.int_ops / measure.INT_OPS_S) * 1e3


def _corpus():
    data = np.load(bench.CORPUS)
    _, m, n = (int(x) for x in data["meta"][:3])
    return (data, torch.as_tensor(np.unpackbits(data["synd_packed"], axis=1)[:, :m]),
            torch.as_tensor(np.unpackbits(data["osdw_packed"], axis=1)[:, :n]))


def test_gates_refuse_a_flipped_osdw_bit(flagship):
    """The syndrome gate, the corpus gate and the OSD-against-plain gate each
    refuse an osdw with one bit flipped."""
    H, H_f = flagship
    data, synd, osdw = _corpus()
    bench.satisfied_all([osdw], [synd], H_f, "t")
    measure.corpus_check(osdw, torch.as_tensor(data["converged"]),
                         torch.as_tensor(data["iterations"]), data, "t")
    bad = osdw.clone()
    bad[3, 17] ^= 1
    with pytest.raises(GateFailed, match="violates its syndrome"):
        bench.satisfied_all([osdw, bad], [synd, synd], H_f, "t")
    with pytest.raises(GateFailed, match="osdw != corpus"):
        measure.corpus_check(bad, torch.as_tensor(data["converged"]),
                             torch.as_tensor(data["iterations"]), data, "t")
    graph = TannerGraph(H, "cpu")
    consts = build_osd_consts(graph, "osd_cs", 42)
    llr = torch.as_tensor(np.random.default_rng(1).normal(3.0, 2.0, (8, graph.n)),
                          dtype=torch.float32)
    got = bench.osd_equal_plain(graph, synd[:8], llr, "osd_cs", 42, consts, "t")
    bench.osd_equal_plain(graph, synd[:8], llr, "osd_cs", 42, consts, "t", decoded=got)
    got[0, 5] ^= 1
    with pytest.raises(GateFailed, match="differ from the plain"):
        bench.osd_equal_plain(graph, synd[:8], llr, "osd_cs", 42, consts, "t", decoded=got)


def test_gates_refuse_a_changed_llr(flagship, lifted):
    """K1's stage gate and the sharded-BP gate each refuse one changed llr."""
    H, _ = flagship
    graph = TannerGraph(H, "cpu")
    _, synd, _ = _corpus()
    llr0 = llr_from_channel(np.full(graph.n, 0.05)).expand(48, graph.n)
    stages = measure.k1_stages(graph, synd[:48], llr0, 400, method="minimum_sum",
                               ms_scaling_factor=0.0)
    assert [st.kw["max_iter"] for st in stages] == [24, 96, 400]
    measure.k1_stages_equal_plain(stages, "t")
    llr = stages[1].out[1].clone()
    llr[0, 0] = torch.nextafter(llr[0, 0], torch.tensor(np.inf))
    bad = stages[1]._replace(out=(stages[1].out[0], llr, *stages[1].out[2:]))
    with pytest.raises(GateFailed, match="stage 2 .* llr differs"):
        measure.k1_stages_equal_plain([stages[0], bad], "t")

    qcode, Hl = lifted
    lg = LiftedGraph(qcode.hx_proto, LIFT, "cpu")
    s = bench.random_syndromes(bench.batch_rng(0, "lifted_shard", 1), Hl.shape[0], 8, "cpu")
    out = bp_decode_lifted(lg, s, llr_from_channel(np.full(Hl.shape[1], 0.005)), max_iter=20)
    bench.bp_bits_equal(out, out, "t")
    changed = out.llr.clone()
    changed[2, 3] = -changed[2, 3] if changed[2, 3] != 0 else 1.0
    with pytest.raises(GateFailed, match="llr differs"):
        bench.bp_bits_equal(out._replace(llr=changed), out, "t")
    pos, neg = out.llr.clone(), out.llr.clone()
    pos[0, 0], neg[0, 0] = 0.0, -0.0  # equal as floats, not as bits
    with pytest.raises(GateFailed, match="llr differs"):
        bench.bp_bits_equal(out._replace(llr=neg), out._replace(llr=pos), "t")


def test_k1_bound_from_the_decode_equals_its_launches(flagship):
    """K1's bound counted from a staged decode's final iterations (what the
    bench does on its traced step) equals the sum over the stage launches,
    each counted from its own rows and iterations."""
    H, _ = flagship
    graph = TannerGraph(H, "cpu")
    _, synd, _ = _corpus()
    for max_iter, stage1 in ((400, None), (100, None), (400, 32), (400, (8, 32, 128)),
                             (400, 400), (100, (4, 60, 60))):
        llr0 = llr_from_channel(np.full(graph.n, 0.05)).expand(96, graph.n)
        stages = measure.k1_stages(graph, synd[:96], llr0, max_iter, stage1,
                                   method="minimum_sum", ms_scaling_factor=0.0)
        caps = measure.stage_caps(max_iter, stage1)
        assert [st.kw["max_iter"] for st in stages] == caps  # the corpus rows reach every cap
        want = measure.bound_sum(
            measure.k1_bound(graph, st.args[1].shape[0], st.sample_its,
                             prior_rows=1 if i == 0 else st.args[1].shape[0], v2c_in=i > 0,
                             emit=st.kw["emit_state"])
            for i, st in enumerate(stages))
        iters = measure.k1_merged(stages)[3]
        assert measure.staged_k1_bound(graph, iters, max_iter, stage1) == want
        if stage1 is not None:  # the default schedule's count is another count
            assert measure.staged_k1_bound(graph, iters, max_iter) != want


def test_trace_step_without_a_card():
    """Without a card the trace has no device event: the device fields read
    "not measured", never a CPU time."""
    out, tr = measure.trace_step(lambda: torch.ones(64, 64) @ torch.ones(64, 64))
    assert out.shape == (64, 64) and tr["wall_ms"] > 0
    assert tr["device_idle_share"] == tr["device_busy_ms"] == tr["kernel_ms"] == "not measured"


KEYS = {"metric", "value", "unit", "spread", "first_call_ms", "kernels", "device_idle_share",
        "glue_ms", "gates", "device"}


@pytest.mark.parametrize("mode, options", [
    ("flagship", dict(batch=24)),
    ("flagship", dict(batch=24, code="625", decoder="osd0")),
    ("flagship", dict(batch=24, decoder="osd_e12")),
    ("api", dict(batch=24)),
    ("large", dict(batch=16, lift=LIFT, p=0.03)),
    ("lifted_shard", dict(batch=8, lift=LIFT)),
    ("harness", dict(runs=100, batch=50)),
    ("flagship", dict(batch=24, stage1=32)),
])
def test_mode_end_to_end_on_the_cpu(mode, options):
    """Each mode, gates included, at a tiny size on the CPU: one line with
    the named fields, the step spread, the kernels' bounds counted and no
    device number."""
    line = bench.run(mode, 11, steps=2, device="cpu", **options)
    json.dumps(line)
    assert KEYS <= set(line)
    assert line["spread"]["n"] == 2 and line["value"] > 0
    assert line["device"]["name"] == "cpu"
    assert line["device_idle_share"] == "not measured"
    for k in line["kernels"].values():
        assert k["launches"] == 0 and k["ms"] == "not measured" and k["share"] == "not measured"
        assert {"bound_ms", "bound_by"} <= set(k)
    assert line["gates"]
    if mode == "large":  # K6 and the OSD kernel beside their bounds
        assert list(line["kernels"])[0] == "bp_lifted" and len(line["kernels"]) == 2
        assert line["kernels"]["bp_lifted"]["id"] == "K6"
    if mode == "flagship":  # the caps that ran: the default schedule, or --stage1's
        n = int(options.get("code", "400"))
        max_iter = bench.DECODERS[options.get("decoder", "osd_cs42")]["max_iter"] or n
        assert line["stage_caps"] == measure.stage_caps(max_iter, options.get("stage1"))
        if options == dict(batch=24):
            assert line["stage_caps"] == [24, 96, 400]
        if options == dict(batch=24, stage1=32):
            assert line["stage_caps"] == [32, 400]


@pytest.mark.parametrize("text, want", [("24,96", (24, 96)), ("32", 32), ("8,32,128", (8, 32, 128)),
                                        ("400", 400)])
def test_stage1_parses(text, want):
    """``--stage1`` takes one int (``stage1_iters=32``) or a comma list (a
    tuple of caps), as ``bench.py:61-63`` reads ``BENCH_STAGE1``."""
    assert bench.parse_stage1(text) == want


@pytest.mark.parametrize("argv, message", [
    (["--mode", "api", "--stage1", "32"], "--stage1 applies to --mode flagship"),
    (["--mode", "harness", "--stage1", "24,96"], "--stage1 applies to --mode flagship"),
    (["--mode", "large", "--stage1", "32"], "--stage1 applies to --mode flagship"),
    (["--mode", "flagship", "--stage1", "0"], "at least 1"),
    (["--mode", "flagship", "--stage1", "24,x"], "ints separated by commas"),
])
def test_stage1_is_refused_outside_flagship(argv, message, capsys):
    """Outside ``--mode flagship``, or with a cap that is not a positive
    int, the command line is refused before anything is built."""
    with pytest.raises(SystemExit) as exc:
        bench.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_script_without_a_card_prints_no_line():
    """``python bench_torch.py --mode flagship`` on a machine without a card
    exits non-zero and prints no metric line."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"), "--mode",
                           "flagship"], capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "metric" not in proc.stdout and not proc.stdout.strip()
    assert "needs a CUDA card" in proc.stderr


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", ["bench_torch.py", "chip_smoke.py",
                                  "bp_osd_tpu_torch/utils/measure.py"])
def test_no_jax_and_no_reference_package(path):
    names = list(_imports(os.path.join(ROOT, path)))
    assert names
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "bp_osd_tpu")]
    assert not bad, bad
