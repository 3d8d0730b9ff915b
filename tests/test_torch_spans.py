"""The span and counter recorder of ``bp_osd_tpu_torch.utils.profiling`` on
the decode path.

The CPU tests hold the recorder's tree, counters and clock to what a decode
did.  The tests marked ``gpu`` skip without a CUDA card; on a card they
check that every synchronisation torch reports in a decode is a counted
``sync.*`` site, and that the spans' clock agrees with the device trace's:

    python -m pytest --noconftest -q -m gpu tests/test_torch_spans.py -s
"""

import json
import statistics
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from bp_osd_tpu_torch import BpDecoder, BpOsdDecoder
from bp_osd_tpu_torch.codes import hgp, lifted_hgp, mkmn_16_4_6
from bp_osd_tpu_torch.decoder.pipeline import stage_caps
from bp_osd_tpu_torch.ops import count_launch, launch_counter
from bp_osd_tpu_torch.utils import profiling

torch.set_num_threads(1)

PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]
MAX_ITER = 64  # stages 8, 16, 64
OSD_KW = dict(error_rate=0.05, max_iter=MAX_ITER, bp_method="ms", ms_scaling_factor=0.0,
              osd_method="osd_cs", osd_order=12)


@pytest.fixture(autouse=True)
def _clean_recorder():
    profiling.disable()
    profiling.collect()
    yield
    profiling.disable()
    profiling.collect()


def _syndromes(H, B, p, seed, dev="cpu"):
    rng = np.random.default_rng(seed)
    err = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    return torch.as_tensor(err @ H.T % 2, dtype=torch.uint8, device=dev)


@pytest.fixture(scope="module")
def flagship():
    return np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)


def _recorded(fn):
    profiling.collect()
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, profiling.collect()


def _path(s, by_id):
    return s.name if s.parent is None else _path(by_id[s.parent], by_id) + "/" + s.name


@pytest.fixture(scope="module")
def decoded(flagship):
    """Two recorded decodes on the CPU: a batch with failing rows at every
    stage, and an all-zero batch that converges in stage 1."""
    dec = BpOsdDecoder(flagship, device="cpu", **OSD_KW)
    synd = _syndromes(flagship, 48, 0.05, 3)
    zero = torch.zeros(8, flagship.shape[0], dtype=torch.uint8)
    runs = []
    for s in (synd, zero):
        profiling.collect()
        profiling.enable()
        try:
            dec.decode_batch(s, outputs="device")
        finally:
            profiling.disable()
        runs.append((profiling.collect(), dec.converge_batch.clone(), dec.iter_batch.clone()))
    return runs


def test_off_records_nothing(flagship):
    dec = BpOsdDecoder(flagship, device="cpu", **OSD_KW)
    dec.decode_batch(_syndromes(flagship, 8, 0.05, 1), outputs="device")
    profiling.count("x")
    rec = profiling.collect()
    assert rec.spans == [] and rec.counters == {}
    assert profiling.span("a") is profiling.span("b", rows=1) is profiling.sync("c")


def test_one_root_per_call_and_children_inside_parents(decoded):
    for rec, _, _ in decoded:
        by_id = {s.id: s for s in rec.spans}
        roots = [s for s in rec.spans if s.parent is None]
        assert [s.name for s in roots] == ["decode_batch"]
        assert {s.batch for s in rec.spans} == {roots[0].batch}
        for s in rec.spans:
            assert s.start_ns <= s.end_ns
            if s.parent is not None:
                up = by_id[s.parent]
                assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, _path(s, by_id)
    assert decoded[0][0].spans[0].batch != decoded[1][0].spans[0].batch
    paths = {_path(s, {x.id: x for x in decoded[0][0].spans}) for s in decoded[0][0].spans}
    assert {"decode_batch/input/sync.input", "decode_batch/prior/sync.prior",
            "decode_batch/bp/bp.partition/sync.bp_partition", "decode_batch/bp/bp.gather",
            "decode_batch/bp/bp.scatter", "decode_batch/osd/osd.partition/sync.osd_partition",
            "decode_batch/osd/osd.argsort", "decode_batch/osd/osd.kernel",
            "decode_batch/osd/osd.scatter", "decode_batch/outputs"} <= paths


def test_stages_and_osd_follow_the_outputs(decoded):
    caps = [0] + stage_caps(MAX_ITER)
    for rec, conv, iters in decoded:
        stages = sorted((s.attrs["stage"], s.attrs["rows"]) for s in rec.spans
                        if s.name == "bp.stage")
        passed = [int((iters > c).sum()) for c in caps[:-1]]
        ran = [(i + 1, r) for i, r in enumerate(passed) if r]
        assert stages == ran
        for i, r in ran:
            assert rec.counters[f"bp.stage_rows.{i}"] == r
        fails = int((~conv).sum())
        kernels = [s for s in rec.spans if s.name == "osd.kernel"]
        assert len(kernels) == int(fails > 0)
        assert rec.counters.get("osd.rows", 0) == fails
        if fails:
            assert kernels[0].attrs == {"route": "torch", "rows": fails}
    assert len(decoded[0][0].counters) > len(decoded[1][0].counters)
    assert [s.attrs["stage"] for s in decoded[0][0].spans if s.name == "bp.stage"] == [1, 2, 3]


def test_host_syncs_sum_their_sites(decoded):
    for rec, _, _ in decoded:
        sites = {k: v for k, v in rec.counters.items() if k.startswith("host_syncs.")}
        assert rec.counters["host_syncs"] == sum(sites.values())
        names = sorted(s.name for s in rec.spans if s.name.startswith("sync."))
        assert names == sorted(f"sync.{k[len('host_syncs.'):]}" for k, v in sites.items()
                               for _ in range(v))
    # input, prior, two stage partitions, the OSD partition
    assert decoded[0][0].counters["host_syncs"] == 5
    assert decoded[1][0].counters["host_syncs"] == 4


def test_host_outputs_are_syncs(flagship):
    dec = BpDecoder(flagship, device="cpu", error_rate=0.05, max_iter=8)
    _, rec = _recorded(lambda: dec.decode_batch(_syndromes(flagship, 4, 0.05, 2)))
    assert rec.counters["host_syncs.outputs"] == 4  # hard, llr, converged, iterations
    by_id = {s.id: s for s in rec.spans}
    assert {_path(s, by_id) for s in rec.spans} == {
        "decode_batch", "decode_batch/input", "decode_batch/input/sync.input",
        "decode_batch/prior", "decode_batch/prior/sync.prior", "decode_batch/bp",
        "decode_batch/outputs", "decode_batch/outputs/sync.outputs"}


def test_trace_exports_the_spans(flagship, tmp_path):
    dec = BpOsdDecoder(flagship, device="cpu", **OSD_KW)
    synd = _syndromes(flagship, 16, 0.05, 5)
    with profiling.trace(str(tmp_path / "t")):
        dec.decode_batch(synd, outputs="device")
    assert profiling.span("a") is profiling.span("b")  # off again
    with open(tmp_path / "t" / "trace.json") as f:
        doc = json.load(f)
    prog = [e for e in doc["traceEvents"] if e.get("cat") == "program"]
    assert [e["name"] for e in prog].count("decode_batch") == 1
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in prog)
    assert {"bp.stage", "osd.partition", "sync.input"} <= {e["name"] for e in prog}
    assert doc["programCounters"]["host_syncs"] >= 4
    assert profiling.collect().spans == []


def test_argsorts_lie_in_their_spans_on_the_trace_clock(flagship, tmp_path):
    """Under a CPU profile (the recorder follows it), each ``aten::argsort``
    lies inside an ``osd.argsort`` span (the reliability order) or an
    ``osd.kernel`` span (the plain OSD's own sort) after conversion by
    ``baseTimeNanoseconds``, within 20 us."""
    from torch.profiler import ProfilerActivity, profile

    dec = BpOsdDecoder(flagship, device="cpu", **OSD_KW)
    synd = _syndromes(flagship, 32, 0.05, 6)
    profiling.collect()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.span("a") is not profiling.span("b")
        dec.decode_batch(synd, outputs="device")
    rec = profiling.collect()
    path = str(tmp_path / "cpu.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    sorts = [e for e in doc["traceEvents"]
             if e.get("name") == "aten::argsort" and e.get("cat") == "cpu_op"]
    spans = [s for s in rec.spans if s.name in ("osd.argsort", "osd.kernel")]
    assert sorts and len([s for s in spans if s.name == "osd.argsort"]) == 1
    slack = 20_000  # ns
    held = {s.id: 0 for s in spans}
    for e in sorts:
        a = e["ts"] * 1e3 + base
        b = a + e["dur"] * 1e3
        home = [s for s in spans if s.start_ns - slack <= a and b <= s.end_ns + slack]
        assert len(home) == 1, (e, spans)
        held[home[0].id] += 1
    assert all(held[s.id] == 1 for s in spans if s.name == "osd.argsort")


def test_lifted_tree():
    L = 8
    q = lifted_hgp(PROTO, lift=L)
    H = np.asarray(q.hx.toarray(), np.uint8)
    dec = BpOsdDecoder(H, proto=q.hx_proto, lift=L, device="cpu", error_rate=0.05,
                       max_iter=20, bp_method="ms", ms_scaling_factor=0.625,
                       osd_method="osd_cs", osd_order=6)
    synd = _syndromes(H, 24, 0.05, 41)
    _, rec = _recorded(lambda: dec.decode_batch(synd, outputs="device"))
    by_id = {s.id: s for s in rec.spans}
    paths = sorted(_path(s, by_id) for s in rec.spans)
    fails = int((~dec.converge_batch).sum())
    assert 0 < fails < 24
    assert paths == sorted([
        "decode_batch", "decode_batch/input", "decode_batch/input/sync.input",
        "decode_batch/prior", "decode_batch/prior/sync.prior", "decode_batch/bp",
        "decode_batch/bp/bp.lifted", "decode_batch/osd", "decode_batch/osd/osd.partition",
        "decode_batch/osd/osd.partition/sync.osd_partition", "decode_batch/osd/osd.argsort",
        "decode_batch/osd/osd.kernel", "decode_batch/osd/osd.scatter", "decode_batch/outputs"])
    for s in rec.spans:
        if s.parent is not None:
            assert by_id[s.parent].start_ns <= s.start_ns <= s.end_ns <= by_id[s.parent].end_ns
    assert [s.attrs for s in rec.spans if s.name == "bp.lifted"] == [{"rows": 24}]
    assert rec.counters["osd.rows"] == fails and rec.counters["host_syncs"] == 3
    assert "bp.stage_rows.1" not in rec.counters


def test_an_open_span_waits_for_its_root():
    profiling.enable()
    with profiling.span("root"):
        with profiling.span("a"):
            pass
        assert profiling.collect().spans == []
    rec = profiling.collect()
    a, root = rec.spans
    assert (a.name, root.name) == ("a", "root") and a.parent == root.id
    assert a.batch == root.batch


def test_launch_counts_reach_the_recorder():
    def fake_kernel():
        pass

    launch_counter(fake_kernel)
    count_launch(fake_kernel, torch.device("cpu"))  # off: the wrapper's count alone
    _, rec = _recorded(lambda: [count_launch(fake_kernel, torch.device("cpu"))
                                for _ in range(3)])
    assert fake_kernel.launches == 4
    assert rec.counters == {"launches.fake_kernel": 3}


def test_device_counters_reach_the_recorder_once():
    """A device counter exists only while the recorder is on, is the same
    tensor until :func:`collect` reads it, and lands in the counters once,
    its zero slots left out; the next call after that gets a fresh one."""
    names = ("k.pivots", "k.passes", "k.unused")
    assert profiling.device_counter(names, "cpu") is None  # off: the kernel gets null
    profiling.collect()
    profiling.enable()
    try:
        buf = profiling.device_counter(names, "cpu")
        assert buf.dtype == torch.int64 and buf.tolist() == [0, 0, 0]
        buf += torch.tensor([7, 2, 0])
        again = profiling.device_counter(names, torch.device("cpu"))
        assert again is buf
        again += torch.tensor([5, 1, 0])
        profiling.count("other")
        rec = profiling.collect()
        assert rec.counters == {"k.pivots": 12, "k.passes": 3, "other": 1}
        fresh = profiling.device_counter(names, "cpu")
        assert fresh is not buf and fresh.tolist() == [0, 0, 0]
    finally:
        profiling.disable()
    assert profiling.collect().counters == {}


def test_threads_keep_their_own_trees_and_exact_counts():
    """More threads than cores, a short switch interval: every count lands
    and each thread's spans nest under its own roots."""
    threads, rounds = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.enable()
    try:
        def work():
            for _ in range(rounds):
                with profiling.span("outer"):
                    with profiling.sync("site"):
                        profiling.count("n")

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        profiling.disable()
    rec = profiling.collect()
    total = threads * rounds
    assert rec.counters == {"n": total, "host_syncs": total, "host_syncs.site": total}
    assert len(rec.spans) == 2 * total
    assert all(t.is_alive() for t, _ in profiling._buffers)  # finished threads let go
    by_id = {s.id: s for s in rec.spans}
    outers = [s for s in rec.spans if s.name == "outer"]
    assert all(s.parent is None for s in outers) and len({s.batch for s in outers}) == total
    for s in rec.spans:
        if s.name == "sync.site":
            up = by_id[s.parent]
            assert up.name == "outer" and up.tid == s.tid and up.batch == s.batch


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode's host syncs and device trace are the "
                    "card's")
    return torch.device("cuda")


def _card_case(code, dev):
    """The decoder and a batch of the benchmark's two main paths on the card:
    [[400,16,6]] at p = 0.05 (three K1 stages, K2) and [[10000,420]] at
    p = 0.028 (K6, K5)."""
    if code == "hgp400":
        H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
        dec = BpOsdDecoder(H, error_rate=0.05, max_iter=0, bp_method="ms",
                           ms_scaling_factor=0.0, osd_method="osd_cs", osd_order=42,
                           device=dev)
        B, p = 4096, 0.05
    else:
        q = lifted_hgp(PROTO, lift=400)
        H = np.asarray(q.hx.toarray(), np.uint8)
        dec = BpOsdDecoder(H, proto=q.hx_proto, lift=400, error_rate=0.028, max_iter=100,
                           bp_method="ms", ms_scaling_factor=0.625, osd_method="osd_cs",
                           osd_order=15, device=dev)
        B, p = 512, 0.028
    g = torch.Generator(device=dev).manual_seed(11)
    err = (torch.rand(B, H.shape[1], generator=g, device=dev) < p).float()
    synd = ((err @ torch.as_tensor(H, dtype=torch.float32, device=dev).T) % 2).to(torch.uint8)
    dec.decode_batch(synd, outputs="device")  # loads the kernels
    torch.cuda.synchronize()
    return dec, synd


@pytest.mark.gpu
@pytest.mark.parametrize("code", ["hgp400", "lifted10000"])
def test_every_sync_is_counted(dev, code):
    dec, synd = _card_case(code, dev)
    profiling.collect()
    profiling.enable()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            dec.decode_batch(synd, outputs="device")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.disable()
    torch.cuda.synchronize()
    rec = profiling.collect()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = {k: v for k, v in rec.counters.items() if k.startswith("host_syncs.")}
    print(f"\n{code}: torch reports {len(syncs)} synchronising calls; host_syncs "
          f"{rec.counters['host_syncs']} {sites}")
    assert len(syncs) == rec.counters["host_syncs"]


FAMILIES = {"bp_flood": "bp.stage", "osd_cs_warp": "osd.kernel", "bp_lifted": "bp.lifted",
            "osd_large": "osd.kernel"}


@pytest.mark.gpu
@pytest.mark.parametrize("code", ["hgp400", "lifted10000"])
def test_spans_hold_their_launches(dev, code, tmp_path):
    """Under a CUDA-only profile, as the benchmark's traced window records,
    each kernel's launch call (a runtime event, on the trace's host clock)
    lies inside the span that launched it, once ``baseTimeNanoseconds``
    converts the trace.  The kernels' own starts (the device's clock) are
    printed against their spans: that clock strays from the host's."""
    from torch.profiler import ProfilerActivity, profile

    dec, synd = _card_case(code, dev)
    profiling.collect()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dec.decode_batch(synd, outputs="device")
        torch.cuda.synchronize()
    rec = profiling.collect()
    path = str(tmp_path / "cuda.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc["traceEvents"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")
                and "correlation" in e.get("args", {})}
    into, lead = [], []
    for fam, name in FAMILIES.items():
        kernels = sorted((e for e in events if e.get("cat") == "kernel" and fam in e["name"]),
                         key=lambda e: e["ts"])
        spans = sorted((s for s in rec.spans if s.name == name), key=lambda s: s.start_ns)
        if not kernels:
            continue
        assert spans, fam
        pairs = (list(zip(spans, kernels)) if len(spans) == len(kernels)
                 else [(spans[0], k) for k in kernels] if len(spans) == 1 else None)
        assert pairs is not None, (fam, len(spans), len(kernels))
        for s, k in pairs:
            lead.append((k["ts"] * 1e3 + base - s.start_ns) / 1e3)
            launch = launches.get(k.get("args", {}).get("correlation"))
            assert launch is not None, (fam, "no launch call for the kernel")
            a = launch["ts"] * 1e3 + base
            into.append((a - s.start_ns) / 1e3)
            assert s.start_ns - 10_000 <= a <= s.end_ns + 10_000, (fam, a - s.start_ns)
    assert into
    print(f"\n{code}: {len(into)} launch calls in their spans, median {statistics.median(into)} "
          f"us after the span opened; kernel starts {min(lead)} to {max(lead)} us after it "
          f"on the device's clock")
