"""Benchmark entry points of ``bp_osd_tpu_torch`` on one CUDA card.

One mode for each root bench script of the JAX package, and one for the
Monte-Carlo harness.  Each mode prints one JSON line of named metrics,
after its gates pass:

    python3 bench_torch.py --mode flagship [--code 400|625|900] [--decoder osd_cs42|osd0|osd_e12]
                                           [--stage1 24,96|32|...]
    python3 bench_torch.py --mode api
    python3 bench_torch.py --mode large [--p 0.005|0.028]
    python3 bench_torch.py --mode lifted_shard
    python3 bench_torch.py --mode harness [--code 400|625|900]

with ``--seed S`` (default 0) and ``--steps N`` (default 40) on every mode.

- ``flagship`` (``bench.py``): ``decode_pipeline(TannerGraph(hx), ...)`` on
  ``hgp(mkmn_16_4_6()).hx`` ([[400,16,6]]; ``--code 625``/``900`` take
  ``mkmn_20_5_8``/``mkmn_24_6_10``) at p = 0.05, B = 16384: adaptive
  min-sum to max_iter = n in the pipeline's stages, then osd_cs 42 (K1 +
  K2); ``--decoder osd0`` is the decoder class's defaults (min-sum 1.0,
  osd0: K1 + K4), ``osd_e12`` osd_e 12 at max_iter 100 (K1 + K3).
  ``--stage1`` sets the pipeline's ``stage1_iters`` (``bench.py:61-63``'s
  ``BENCH_STAGE1``): one int or a comma list of stage caps; by default
  ``auto_stage_schedule`` (24, 96 at max_iter 400).  The line's
  ``stage_caps`` are the caps that ran; K1's bound, its launch check and
  gate (b) follow them.
- ``api`` (``bench_api.py``): the same workload through ``BpOsdDecoder``
  built with no backend, device or chunk size, ``decode_batch(...,
  outputs="device")``, timed in turns with the flagship path.
- ``large`` (``bench_large.py``): ``BpOsdDecoder(hx, proto=hx_proto,
  lift=400, ...)`` on the [[10000,420]] lifted product, B = 512: lifted BP
  (K6, one launch a batch) and K5 on the rows it leaves unconverged.
- ``lifted_shard`` (``bench_lifted_shard.py``): lifted BP on uniform random
  syndromes, which never converge, unsharded and block-row-sharded on
  ``Mesh2D`` 1 x 1 and 1 x 2, every shard on the card (the unsharded BP and
  the 1 x 1 mesh run K6; the 1 x 2 mesh's block-row-sharded BP is plain
  torch and launches no kernel).
- ``harness``: ``css_decode_sim`` at the options of
  ``examples/qldpc_decode_example.py`` (pure Z, osd_cs 42, batch 2000),
  100000 runs a step, its LER held to the committed artifact.

Every mode: every random input comes from ``--seed``; timed step ``s``
decodes a batch drawn from ``np.random.default_rng((seed, mode_index,
s))`` (``mode_index`` a mode's place in :data:`MODES`), made on the card
before timing, outputs left there.  Two warm-up batches are decoded first
(``first_call_ms``: the decoder's set-up and the first decode); then the
steps, each timed by the host clock between ``torch.cuda.synchronize()``
calls, with every kernel's launches counted (a kernel the mode expects that
never launches, or one it does not expect that launches, fails the run);
then one more batch under ``torch.profiler`` (each kernel's device ms, the
rest of the wall as glue, the device's idle share), each kernel's bound
counted from that batch's data (``utils/measure.py``).  Gates run before
the line is printed; a gate that fails exits non-zero with ``FAILED: ...``
and prints no line.  Without a CUDA card the script exits non-zero before
it builds anything.  The mode functions take ``device="cpu"`` and smaller
sizes for the CPU tests.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from bp_osd_tpu_torch.utils.measure import (KERNELS, artifact, artifact_sigmas, bound_sum,
                                            card, check, corpus_check, elim_bound, k1_merged,
                                            k1_stages, k1_stages_equal_plain, k6_bound, launches,
                                            osd_cs_bound, osd_e_bound, reset_launches, same,
                                            satisfies, spread, stage_caps, staged_k1_bound,
                                            sync, trace_step, wrappers)

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "tests", "data", "flagship_corpus.npz")

MODES = ("flagship", "api", "large", "lifted_shard", "harness")
STEPS = 40
WARMUP = 2
EXTRA = 1 << 20  # batch index of the warm-up and traced batches: never a timed step's
GATE_ROWS = 512  # rows of the first timed batch held to the plain versions
PLAIN_OSD_ROWS = 8  # failing lifted rows held to the plain OSD (about 7 s on the card)
TRACE_TRIES = 8  # extra lifted batches tried for a traced step that runs the OSD kernel
P_FLAGSHIP, B_FLAGSHIP = 0.05, 16384
SEED_CODES = {"400": "mkmn_16_4_6", "625": "mkmn_20_5_8", "900": "mkmn_24_6_10"}
ARTIFACTS = {"400": "qldpc_decode_results.json", "625": "hgp_625_decode_results.json",
             "900": "hgp_900_decode_results.json"}
DECODERS = {  # decode_pipeline's options of each --decoder
    "osd_cs42": dict(bp_method="minimum_sum", max_iter=0, ms_scaling_factor=0.0,
                     osd_method="osd_cs", osd_order=42),
    "osd0": dict(bp_method="minimum_sum", max_iter=0, ms_scaling_factor=1.0,
                 osd_method="osd0", osd_order=0),
    "osd_e12": dict(bp_method="minimum_sum", max_iter=100, ms_scaling_factor=0.0,
                    osd_method="osd_e", osd_order=12),
}
# the [[10000,420]] lifted product of bench_large.py:40-45 (lift 400)
PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]
LIFT, LIFT_ITERS, LIFT_MSF, LIFT_ORDER = 400, 100, 0.625, 15
B_LARGE, B_SHARD, P_SHARD_OSD = 512, 128, 0.028
HARNESS_RUNS, HARNESS_SIGMAS = 100000, 4.0
# the wrapper of the kernel osd_route names
ROUTE_KERNEL = {"k2": "osd_cs", "k3": "osd_e", "k4": "eliminate", "k5": "osd_large"}


# ---- inputs -------------------------------------------------------------------

def batch_rng(seed: int, mode: str, step: int) -> np.random.Generator:
    """The generator of step ``step``'s batch in ``mode`` (warm-up and traced
    batches take ``EXTRA + k``)."""
    return np.random.default_rng((int(seed), MODES.index(mode), int(step)))


def error_syndromes(rng: np.random.Generator, H_f: torch.Tensor, p: float,
                    rows: int) -> torch.Tensor:
    """Syndromes ``H e mod 2 [rows, m]`` uint8 of errors drawn i.i.d. at rate
    ``p`` on the n bits (``bench.py:135-138``), on ``H_f``'s device."""
    err = torch.as_tensor(rng.random((rows, H_f.shape[1])) < p, dtype=torch.float32,
                          device=H_f.device)
    return torch.remainder(err @ H_f.T, 2).to(torch.uint8)


def random_syndromes(rng: np.random.Generator, m: int, rows: int, device) -> torch.Tensor:
    """Uniform random syndromes ``[rows, m]`` (``bench_lifted_shard.py:62-65``):
    almost none lies in H's image, so BP runs every row to max_iter."""
    return torch.as_tensor(rng.integers(0, 2, (rows, m), dtype=np.uint8), device=device)


def parse_stage1(text: str):
    """``--stage1``: one int (``"32"``) or a comma list of ints
    (``"24,96"``, a tuple), as ``decode_pipeline``'s ``stage1_iters``."""
    try:
        caps = tuple(int(c) for c in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(f"--stage1 takes ints separated by commas, "
                                         f"got {text!r}") from None
    if any(c < 1 for c in caps):
        raise argparse.ArgumentTypeError(f"--stage1 caps must be at least 1, got {text!r}")
    return caps[0] if len(caps) == 1 else caps


def harness_seed(rng: np.random.Generator) -> int:
    """A harness run's seed (non-zero: the harness draws its own for 0)."""
    return int(rng.integers(1, 2**31 - 1))


def flagship_code(code: str):
    from bp_osd_tpu_torch import codes

    if code not in SEED_CODES:
        raise ValueError(f"--code must be one of {tuple(SEED_CODES)}, got {code!r}")
    return codes.hgp(getattr(codes, SEED_CODES[code])())


def lifted_code(lift: int = LIFT):
    """The (3,4)-regular lifted product of ``bench_large.py`` at ``lift``."""
    from bp_osd_tpu_torch.codes import lifted_hgp

    return lifted_hgp(PROTO, lift=lift)


def dense(M) -> np.ndarray:
    return np.asarray(M.toarray(), np.uint8)


# ---- timing -------------------------------------------------------------------

def _device(device) -> torch.device:
    return torch.device("cuda") if device is None else torch.device(device)


def _timed(fn):
    """``fn()`` and its host milliseconds between synchronisations."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def timed_steps(paths: dict, steps: int) -> tuple[dict, dict, dict]:
    """Run every path ``fn(s)`` on steps ``0 .. steps - 1``, the paths in
    turns (their order reversed on odd steps).  Each path is ``(fn, keep)``:
    ``keep(out)``, called after the step's clock has stopped, gives what the
    step leaves for the gates.  Returns each path's step milliseconds, its
    launches on each step and what it kept."""
    walls = {k: [] for k in paths}
    counts = {k: [] for k in paths}
    kept = {k: [] for k in paths}
    names = list(paths)
    for s in range(steps):
        for name in (names if s % 2 == 0 else names[::-1]):
            fn, keep = paths[name]
            reset_launches()
            out, ms = _timed(lambda: fn(s))
            counts[name].append(launches())
            walls[name].append(ms)
            kept[name].append(keep(out))
    return walls, counts, kept


def check_launches(per_step: list, every=(), some=(), *, on_card: bool, what: str) -> dict:
    """On the card, each kernel in ``every`` launched on every step, each in
    ``some`` on one step at least, and no other kernel on any step (nothing
    takes a route the mode does not expect).  On the CPU the wrappers run
    their plain versions and count nothing.  Returns the launches summed
    over the steps."""
    total = {k: sum(c[k] for c in per_step) for k in per_step[0]} if per_step else {}
    if not on_card:
        return total
    for s, got in enumerate(per_step):
        for k in KERNELS:
            if k in every:
                check(got[k] > 0, f"{what}: step {s} did not launch {k}: {got}")
            elif k not in some:
                check(got[k] == 0, f"{what}: step {s} launched {k}, which its path "
                                   f"does not run: {got}")
    for k in some:
        check(total[k] > 0, f"{what}: no step launched {k}: {total}")
    return total


def kernel_lines(used, total: dict, traced: dict, trace: dict, bounds: dict) -> dict:
    """Each used kernel's launches over the timed steps and in the traced
    step, its device ms in the traced step, the bound of that step's work
    and the bound's share of the ms."""
    out = {}
    for k in used:
        kid, source, _ = KERNELS[k]
        ms = trace["kernel_ms"][k] if isinstance(trace["kernel_ms"], dict) else "not measured"
        b = bounds.get(k)
        line = {"id": kid, "source": f"bp_osd_tpu_torch/csrc/{source}", "launches": total[k],
                "launches_traced": traced[k], "ms": ms}
        if b is None:  # the traced step gave it no rows
            line.update(bound_ms="not counted: no rows in the traced step", bound_by=None,
                        share="not measured")
        else:
            line.update(bound_ms=b.ms, bound_by=b.by,
                        share=b.ms / ms if isinstance(ms, float) and ms > 0 else "not measured")
        out[k] = line
    return out


def traced_fields(trace: dict, kernels: dict) -> dict:
    """The traced step's wall, the device's busy time and idle share, and the
    glue (the wall less the hand-written kernels' device time)."""
    kms = [v["ms"] for v in kernels.values() if isinstance(v["ms"], float)]
    measured = isinstance(trace["kernel_ms"], dict)
    return {"traced_wall_ms": trace["wall_ms"], "device_busy_ms": trace["device_busy_ms"],
            "device_idle_share": trace["device_idle_share"],
            "glue_ms": trace["wall_ms"] - sum(kms) if measured else "not measured"}


def pipeline_bounds(graph, synd, llr, converged, iterations, opts: dict, consts,
                    stage1_iters=None) -> dict:
    """The bounds of one staged decode's kernels from its own data: K1 from
    the iterations its rows ran in the stages of ``stage1_iters``, the OSD
    kernel from the elimination its failing rows need."""
    from bp_osd_tpu_torch.decoder.osd import normalize_osd_method

    method = normalize_osd_method(opts["osd_method"])
    order = 0 if method == "osd0" else int(opts["osd_order"])
    bounds = {"bp_flood": staged_k1_bound(graph, iterations, opts["max_iter"] or graph.n,
                                          stage1_iters)}
    bounds.update(osd_bounds(graph, synd[~converged], llr[~converged], method, order, consts))
    return bounds


def osd_bounds(graph, synd, llr, method: str, order: int, consts) -> dict:
    """The OSD kernel's bound on these rows, by its wrapper's name."""
    from bp_osd_tpu_torch.decoder.osd import osd_route

    if synd.shape[0] == 0:
        return {}
    perm = torch.argsort(llr, dim=1, stable=True).to(torch.int32)
    kernel = ROUTE_KERNEL[osd_route(graph, method, order)]
    if kernel in ("osd_cs", "osd_large"):
        b = osd_cs_bound(graph, perm, synd, consts.pairs)
    elif kernel == "osd_e":
        b = osd_e_bound(graph, perm, synd, order)
    else:
        b = elim_bound(graph, perm, synd)
    return {kernel: b[0]}


def device_info(dev: torch.device) -> dict:
    return card() if dev.type == "cuda" else {"name": "cpu", "power_limit": None, "count": 0}


def result_line(mode: str, metric: str, value: float, unit: str, step_ms, *, seed, steps,
                first_call_ms, kernels, trace, gates, dev, **extra) -> dict:
    return {"mode": mode, "metric": metric, "value": value, "unit": unit,
            "spread": spread(step_ms), "step_ms_unit": "ms a step", "first_call_ms": first_call_ms,
            "seed": seed, "steps": steps, "kernels": kernels,
            **traced_fields(trace, kernels), "gates": gates, **extra,
            "device": device_info(dev)}


# ---- gates --------------------------------------------------------------------

def staged_decode_equal_plain(graph, synd, llr0, opts: dict, consts, what: str,
                              stage1_iters=None):
    """Gate (b): each K1 launch of the staged decode of these rows (in the
    stages of ``stage1_iters``) against ``bp_decode_plain`` on the same
    inputs, then the OSD kernel on the rows BP left unconverged against
    ``osd_decode_plain``, bit for bit.  Returns the decode's ``(osdw,
    converged, iterations)``."""
    from bp_osd_tpu_torch.decoder.bp import normalize_bp_method
    from bp_osd_tpu_torch.decoder.osd import normalize_osd_method

    B, n = synd.shape[0], graph.n
    max_iter = opts["max_iter"] or n
    stages = k1_stages(graph, synd, llr0.expand(B, n), max_iter, stage1_iters,
                       method=normalize_bp_method(opts["bp_method"]),
                       ms_scaling_factor=opts["ms_scaling_factor"])
    k1_stages_equal_plain(stages, what)
    hard, llr, conv, iters = k1_merged(stages)
    fail = ~conv
    method = normalize_osd_method(opts["osd_method"])
    order = 0 if method == "osd0" else int(opts["osd_order"])
    osdw = hard.clone()
    osdw[fail] = osd_equal_plain(graph, synd[fail], llr[fail], method, order, consts, what)
    return osdw, conv, iters


def osd_equal_plain(graph, synd, llr, method: str, order: int, consts, what: str,
                    decoded=None) -> torch.Tensor:
    """The OSD kernel ``osd_decode`` routes these rows to (the plain version
    on the CPU) against ``osd_decode_plain`` on the same reliability order,
    osd0 and osdw bit for bit, and against ``decoded`` (a decode's osdw of
    these rows) where given.  Returns the kernel's osdw."""
    from bp_osd_tpu_torch.decoder.osd import osd_decode, osd_decode_plain

    got = osd_decode(graph, synd, llr, osd_method=method, osd_order=order, consts=consts)
    perm = torch.argsort(llr, dim=1, stable=True).to(torch.int32)
    want0, wantw = osd_decode_plain(graph, perm, synd, method=method, osd_order=order,
                                    pairs=consts.pairs)
    check(same(got.osd0, want0) and same(got.osdw, wantw)
          and (decoded is None or same(got.osdw, decoded)),
          f"{what}: the OSD kernel's osd0/osdw differ from the plain version (or from the "
          f"decode) on {synd.shape[0]} failing rows")
    return got.osdw


def bp_bits_equal(got, want, what: str) -> None:
    """Two BP results equal bit for bit: hard, llr as int32 bits (so -0.0 is
    not 0.0), converged and iterations."""
    for field, a, b in zip(("hard", "llr", "converged", "iterations"), got, want):
        if field == "llr":
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(same(a, b), f"{what}: {field} differs")


def satisfied_all(outs, batches, H_f, what: str) -> None:
    """Gate (c): every decoding of every step satisfies its syndrome."""
    for s, (osdw, synd) in enumerate(zip(outs, batches)):
        check(satisfies(osdw, H_f, synd), f"{what}: an osdw of step {s} violates its syndrome")


def held_to_artifact(out: dict, art: dict, what: str) -> float:
    """A harness run's OSDW LER within :data:`HARNESS_SIGMAS` combined
    standard errors of the artifact's; returns the distance."""
    z = artifact_sigmas(out, art)
    check(z <= HARNESS_SIGMAS,
          f"{what}: OSDW LER {out['osdw_logical_error_rate']} is {z:.2f} sigma from the "
          f"artifact's {art['osdw_logical_error_rate']}: the rate is void")
    return z


def baseline() -> dict:
    """``BASELINE_MEASURED.json``: the serial C++ BP+OSD on a CPU at the
    flagship workload."""
    with open(os.path.join(ROOT, "BASELINE_MEASURED.json")) as f:
        b = json.load(f)
    return {"syndromes_per_s": float(b["syndromes_per_sec"]),
            "source": f"BASELINE_MEASURED.json: serial C++ BP+OSD, one syndrome a decode, on "
                      f"a CPU ({b.get('cpu', 'unnamed')}), not a card"}


# ---- the modes -----------------------------------------------------------------

def _flagship_setup(code: str, dev):
    qcode = flagship_code(code)
    H = dense(qcode.hx)
    return qcode, H, torch.as_tensor(H, dtype=torch.float32, device=dev)


def run_flagship(seed: int = 0, *, code: str = "400", decoder: str = "osd_cs42",
                 stage1=None, steps: int = STEPS, batch: int = B_FLAGSHIP,
                 device=None) -> dict:
    """``decode_pipeline`` on the flagship workload (``bench.py``), BP in the
    stages of ``stage1`` (``stage1_iters``; ``None`` is the default
    schedule)."""
    from bp_osd_tpu_torch.decoder import TannerGraph, decode_pipeline, llr_from_channel
    from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_route

    if decoder not in DECODERS:
        raise ValueError(f"--decoder must be one of {tuple(DECODERS)}, got {decoder!r}")
    dev = _device(device)
    opts = DECODERS[decoder]
    qcode, H, H_f = _flagship_setup(code, dev)
    caps = stage_caps(opts["max_iter"] or qcode.N, stage1)
    batches = [error_syndromes(batch_rng(seed, "flagship", s), H_f, P_FLAGSHIP, batch)
               for s in range(steps)]
    extra = [error_syndromes(batch_rng(seed, "flagship", EXTRA + k), H_f, P_FLAGSHIP, batch)
             for k in range(WARMUP + 1)]
    sync()
    t0 = time.perf_counter()
    graph = TannerGraph(H, dev)
    consts = build_osd_consts(graph, opts["osd_method"], opts["osd_order"])
    llr0 = llr_from_channel(np.full(graph.n, P_FLAGSHIP)).to(dev)

    def decode(synd):
        return decode_pipeline(graph, synd, llr0, consts=consts, stage1_iters=stage1, **opts)

    decode(extra[0])
    sync()
    first_call_ms = (time.perf_counter() - t0) * 1e3
    decode(extra[1])
    on_card = dev.type == "cuda"
    gates = {}
    if code == "400" and decoder == "osd_cs42":  # (a)
        data = np.load(CORPUS)
        m = int(data["meta"][1])
        synd_c = torch.as_tensor(np.unpackbits(data["synd_packed"], axis=1)[:, :m], device=dev)
        out_c = decode(synd_c)
        corpus_check(out_c.osdw, out_c.converged, out_c.iterations, data, "flagship corpus")
        gates["corpus"] = f"reproduced bit for bit ({synd_c.shape[0]} rows)"
    else:
        gates["corpus"] = "not applicable (the corpus is the [[400,16,6]] osd_cs 42 decode)"
    rows = min(GATE_ROWS, batch)  # (b)
    gate_b = staged_decode_equal_plain(graph, batches[0][:rows], llr0, opts, consts,
                                       "flagship gate (b)", stage1)
    gates["plain"] = (f"K1 at every stage (caps {caps}) and the OSD kernel on "
                      f"{int((~gate_b[1]).sum())} failing rows bit-identical to the plain "
                      f"versions ({rows} rows)")

    walls, counts, kept = timed_steps(
        {"flagship": (lambda s: decode(batches[s]),
                      lambda o: (o.osdw, o.converged, o.iterations))}, steps)
    outs = kept["flagship"]
    osd_kernel = ROUTE_KERNEL[osd_route(graph, opts["osd_method"], opts["osd_order"])]
    used = ("bp_flood", osd_kernel)
    total = check_launches(counts["flagship"], every=used, on_card=on_card, what="flagship")
    satisfied_all([o[0] for o in outs], batches, H_f, "flagship gate (c)")  # (c)
    check(all(same(a[:rows], b) for a, b in zip(outs[0], gate_b)),
          "flagship: the timed decode's first rows differ from gate (b)'s decode")
    gates["satisfied"] = f"every osdw of the {steps} timed batches satisfies its syndrome"

    reset_launches()
    out, trace = trace_step(lambda: decode(extra[WARMUP]))
    traced = launches()
    # stage i launches K1 when a row ran past cap i - 1
    ran = sum(bool((out.iterations > prev).any()) for prev in [0] + caps[:-1])
    check(not on_card or traced["bp_flood"] == ran,
          f"flagship: the traced decode launched K1 {traced['bp_flood']} times, its "
          f"stages {caps} ran {ran}")
    bounds = pipeline_bounds(graph, extra[WARMUP], out.llr, out.converged, out.iterations,
                             opts, consts, stage1)
    kernels = kernel_lines(used, total, traced, trace, bounds)
    med = float(np.median(walls["flagship"]))
    value = batch / (med / 1e3)
    extra_fields = {}
    if code == "400" and decoder == "osd_cs42":
        base = baseline()
        extra_fields = {"vs_baseline": value / base["syndromes_per_s"], "baseline": base}
    conv = torch.stack([o[1] for o in outs]).float()
    return result_line(
        "flagship", f"syndromes_per_s_[[{qcode.N},{qcode.K}]]_p{P_FLAGSHIP}_{decoder}", value,
        "syndromes/s", walls["flagship"], seed=seed, steps=steps, first_call_ms=first_call_ms,
        kernels=kernels, trace=trace, gates=gates, dev=dev, code=code, decoder=decoder,
        batch=batch, options=dict(opts), stage_caps=caps,
        bp_converged_frac=float(conv.mean()),
        bp_mean_iterations=float(torch.stack([o[2] for o in outs]).float().mean()),
        osd_rows=[int((1 - c).sum()) for c in conv], **extra_fields)


def run_api(seed: int = 0, *, steps: int = STEPS, batch: int = B_FLAGSHIP, device=None) -> dict:
    """The decoder class with no knobs (``bench_api.py``), in turns with the
    flagship path on the same batches."""
    from bp_osd_tpu_torch import BpOsdDecoder
    from bp_osd_tpu_torch.decoder import TannerGraph, decode_pipeline, llr_from_channel
    from bp_osd_tpu_torch.decoder.osd import build_osd_consts

    dev = _device(device)
    opts = DECODERS["osd_cs42"]
    qcode, H, H_f = _flagship_setup("400", dev)
    batches = [error_syndromes(batch_rng(seed, "api", s), H_f, P_FLAGSHIP, batch)
               for s in range(steps)]
    extra = [error_syndromes(batch_rng(seed, "api", EXTRA + k), H_f, P_FLAGSHIP, batch)
             for k in range(WARMUP + 1)]
    sync()
    t0 = time.perf_counter()
    # no backend, device or chunk size: the defaults a user gets (the CPU
    # tests pass the device)
    dec = BpOsdDecoder(H, error_rate=P_FLAGSHIP, max_iter=0, bp_method="ms",
                       ms_scaling_factor=0, osd_method="osd_cs", osd_order=42,
                       **({} if device is None else {"device": device}))
    dec.decode_batch(extra[0], outputs="device")
    sync()
    first_call_ms = (time.perf_counter() - t0) * 1e3
    on_card = dev.type == "cuda"
    check(dec.device.type == dev.type and dec.backend == ("cuda" if on_card else "torch"),
          f"api: the decoder is on {dec.device} ({dec.backend})")
    graph = TannerGraph(H, dev)
    consts = build_osd_consts(graph, "osd_cs", 42)
    llr0 = llr_from_channel(np.full(graph.n, P_FLAGSHIP)).to(dev)

    def flagship(s):
        return decode_pipeline(graph, batches[s], llr0, consts=consts, **opts)

    dec.decode_batch(extra[1], outputs="device")
    decode_pipeline(graph, extra[1], llr0, consts=consts, **opts)
    walls, counts, kept = timed_steps({
        "api": (lambda s: dec.decode_batch(batches[s], outputs="device"), lambda o: o),
        "flagship": (flagship, lambda o: None)}, steps)
    used = ("bp_flood", "osd_cs")
    total = check_launches(counts["api"], every=used, on_card=on_card, what="api")
    check_launches(counts["flagship"], every=used, on_card=on_card, what="api's flagship path")
    satisfied_all(kept["api"], batches, H_f, "api gate (c)")
    gates = {"satisfied": f"every osdw of the {steps} timed batches satisfies its syndrome"}

    reset_launches()
    _, trace = trace_step(lambda: dec.decode_batch(extra[WARMUP], outputs="device"))
    traced = launches()
    bounds = pipeline_bounds(graph, extra[WARMUP], dec.log_prob_ratios_batch,
                             dec.converge_batch, dec.iter_batch, opts, consts)
    kernels = kernel_lines(used, total, traced, trace, bounds)
    api_ms, flag_ms = (float(np.median(walls[k])) for k in ("api", "flagship"))
    value = batch / (api_ms / 1e3)
    return result_line(
        "api", "syndromes_per_s_BpOsdDecoder_decode_batch_[[400,16,6]]_p0.05_osd_cs42", value,
        "syndromes/s", walls["api"], seed=seed, steps=steps, first_call_ms=first_call_ms,
        kernels=kernels, trace=trace, gates=gates, dev=dev, batch=batch,
        flagship_path={"value": batch / (flag_ms / 1e3), "spread": spread(walls["flagship"])},
        ratio_to_flagship=flag_ms / api_ms)


def run_large(seed: int = 0, *, p: float = 0.005, steps: int = STEPS, batch: int = B_LARGE,
              lift: int = LIFT, qcode=None, device=None) -> dict:
    """``BpOsdDecoder`` with ``proto``/``lift`` on the [[10000,420]] lifted
    product (``bench_large.py``); ``qcode`` is ``lifted_code(lift)`` where
    the caller has built it."""
    from bp_osd_tpu_torch import BpOsdDecoder
    from bp_osd_tpu_torch.decoder.bp import llr_from_channel
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
    from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode_plain, osd_route
    from bp_osd_tpu_torch.ops.cuda_lifted_bp import k6_route

    dev = _device(device)
    qcode = lifted_code(lift) if qcode is None else qcode
    H = dense(qcode.hx)
    H_f = torch.as_tensor(H, dtype=torch.float32, device=dev)
    batches = [error_syndromes(batch_rng(seed, "large", s), H_f, p, batch) for s in range(steps)]
    extra = [error_syndromes(batch_rng(seed, "large", EXTRA + k), H_f, p, batch)
             for k in range(WARMUP + TRACE_TRIES)]
    bp_kw = dict(bp_method="minimum_sum", max_iter=LIFT_ITERS, ms_scaling_factor=LIFT_MSF)
    sync()
    t0 = time.perf_counter()
    dec = BpOsdDecoder(qcode.hx, proto=qcode.hx_proto, lift=lift, error_rate=p,
                       bp_method="ms", max_iter=LIFT_ITERS, ms_scaling_factor=LIFT_MSF,
                       osd_method="osd_cs", osd_order=LIFT_ORDER,
                       **({} if device is None else {"device": device}))
    dec.decode_batch(extra[0], outputs="device")
    sync()
    first_call_ms = (time.perf_counter() - t0) * 1e3
    dec.decode_batch(extra[1], outputs="device")
    on_card = dev.type == "cuda"
    graph = dec.graph
    consts = build_osd_consts(graph, "osd_cs", LIFT_ORDER)
    llr0 = llr_from_channel(np.full(graph.n, p)).to(dev)

    def keep(out):  # the decode and its failing rows' LLRs
        fail = ~dec.converge_batch
        return out, dec.converge_batch, dec.log_prob_ratios_batch[fail].clone()

    walls, counts, kept = timed_steps(
        {"large": (lambda s: dec.decode_batch(batches[s], outputs="device"), keep)}, steps)
    steps_out = kept["large"]
    osd_kernel = ROUTE_KERNEL[osd_route(graph, "osd_cs", LIFT_ORDER)]
    total = check_launches(counts["large"], every=("bp_lifted",), some=(osd_kernel,),
                           on_card=on_card, what="large")
    satisfied_all([o[0] for o in steps_out], batches, H_f, "large")
    gates = {"satisfied": f"every osdw of the {steps} timed batches satisfies its syndrome"}
    # the OSD kernel against the plain version on the first failing rows
    fails = [(s, torch.nonzero(~c).flatten()) for s, (_, c, _) in enumerate(steps_out)]
    synd_f = torch.cat([batches[s][i] for s, i in fails])[:PLAIN_OSD_ROWS]
    llr_f = torch.cat([steps_out[s][2] for s, _ in fails])[:PLAIN_OSD_ROWS]
    osdw_f = torch.cat([steps_out[s][0][i] for s, i in fails])[:PLAIN_OSD_ROWS]
    if synd_f.shape[0]:
        osd_equal_plain(graph, synd_f, llr_f, "osd_cs", LIFT_ORDER, consts, f"large {osd_kernel}",
                        decoded=osdw_f)
    gates["plain"] = (f"{osd_kernel} bit-identical to the plain osd_cs and to the decode on "
                      f"{synd_f.shape[0]} failing rows of the timed batches")

    # lifted BP, and the OSD kernel (off the card its plain version) on the
    # failing rows, alone on every timed batch (host clock)
    lg = LiftedGraph(qcode.hx_proto, lift, dev)
    kernel = (wrappers()[osd_kernel] if on_card
              else functools.partial(osd_decode_plain, method="osd_cs"))
    bp_ms, osd_ms, osd_rows = [], [], []
    for s, (_, conv, llr_fail) in enumerate(steps_out):
        bp_ms.append(_timed(lambda: bp_decode_lifted(lg, batches[s], llr0, **bp_kw))[1])
        osd_rows.append(int(llr_fail.shape[0]))
        if llr_fail.shape[0]:
            perm = torch.argsort(llr_fail, dim=1, stable=True).to(torch.int32)
            osd_ms.append(_timed(lambda: kernel(graph, perm, batches[s][~conv],
                                                osd_order=LIFT_ORDER, pairs=consts.pairs))[1])

    # the traced step: the first extra batch whose decode runs the OSD kernel
    for k in range(WARMUP, WARMUP + TRACE_TRIES):
        reset_launches()
        out, trace = trace_step(lambda: dec.decode_batch(extra[k], outputs="device"))
        traced = launches()
        if not on_card or traced[osd_kernel]:
            break
    fail = ~dec.converge_batch
    bounds = osd_bounds(graph, extra[k][fail], dec.log_prob_ratios_batch[fail], "osd_cs",
                        LIFT_ORDER, consts)
    bounds["bp_lifted"] = k6_bound(lg, torch.as_tensor(dec.iter_batch), prior_rows=1,
                                   device_route=k6_route(lg) == "device")
    kernels = kernel_lines(("bp_lifted", osd_kernel), total, traced, trace, bounds)
    med = float(np.median(walls["large"]))
    conv_all = torch.stack([c for _, c, _ in steps_out]).float()
    return result_line(
        "large", f"syndromes_per_s_lifted_product_[[{qcode.N},{qcode.K}]]_p{p}_osdcs{LIFT_ORDER}",
        batch / (med / 1e3), "syndromes/s", walls["large"], seed=seed, steps=steps,
        first_call_ms=first_call_ms, kernels=kernels, trace=trace, gates=gates, dev=dev,
        p=p, batch=batch, lift=lift, bp_converged_frac=float(conv_all.mean()),
        osd_rows=osd_rows, lifted_bp_ms=spread(bp_ms),
        osd_kernel_ms_per_batch_with_failures=spread(osd_ms) if osd_ms else None,
        traced_batch=EXTRA + k)


def run_lifted_shard(seed: int = 0, *, steps: int = STEPS, batch: int = B_SHARD,
                     lift: int = LIFT, qcode=None, device=None) -> dict:
    """Block-row-sharded lifted BP on ``Mesh2D`` 1 x 1 and 1 x 2 (both shards
    on one device) against the unsharded lifted BP, on syndromes that never
    converge (``bench_lifted_shard.py``); then the sharded BP + OSD once."""
    from bp_osd_tpu_torch.decoder.bp import llr_from_channel
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
    from bp_osd_tpu_torch.parallel import Mesh2D
    from bp_osd_tpu_torch.parallel.large_code import lifted_sharded_bposd_fn
    from bp_osd_tpu_torch.parallel.lifted_shard import ShardedLiftedGraph, lifted_sharded_bp_fn

    dev = _device(device)
    qcode = lifted_code(lift) if qcode is None else qcode
    H = dense(qcode.hx)
    m, n = H.shape
    batches = [random_syndromes(batch_rng(seed, "lifted_shard", s), m, batch, dev)
               for s in range(steps)]
    extra = [random_syndromes(batch_rng(seed, "lifted_shard", EXTRA + k), m, batch, dev)
             for k in range(WARMUP + 1)]
    bp_kw = dict(bp_method="minimum_sum", max_iter=LIFT_ITERS, ms_scaling_factor=LIFT_MSF)
    sync()
    t0 = time.perf_counter()
    lg = LiftedGraph(qcode.hx_proto, lift, dev)
    llr0 = llr_from_channel(np.full(n, 0.005)).to(dev).expand(batch, n)
    fns = {"unsharded": lambda synd: bp_decode_lifted(lg, synd, llr0, **bp_kw)}
    for shards in (1, 2):
        sg = ShardedLiftedGraph(lg, shards)
        bp = lifted_sharded_bp_fn(sg, Mesh2D((dev,) * shards, (1, shards)), **bp_kw)
        width = shards * sg.mp_chunk * lift

        def sharded(synd, bp=bp, width=width):
            return bp(torch.cat([synd, synd.new_zeros(synd.shape[0], width - m)], 1), llr0)

        fns[f"sharded_1x{shards}"] = sharded
    fns["unsharded"](extra[0])
    sync()
    first_call_ms = (time.perf_counter() - t0) * 1e3
    for fn in fns.values():
        fn(extra[1])
    on_card = dev.type == "cuda"
    # the sharded BPs bit for bit against the unsharded one on the first batch
    want = fns["unsharded"](batches[0])
    for name in ("sharded_1x1", "sharded_1x2"):
        bp_bits_equal(fns[name](batches[0]), want, f"lifted_shard: {name} against the unsharded BP")
    gates = {"sharded_equal": "1 x 1 and 1 x 2 hard/llr bits/converged/iterations == "
                              "bp_decode_lifted on the first timed batch"}

    def keep(out):  # every row must run all iterations, or the A/B is not per-iteration
        return bool(out[2].any()) or bool((out[3] != LIFT_ITERS).any())

    walls, counts, kept = timed_steps({k: (lambda s, f=f: f(batches[s]), keep)
                                       for k, f in fns.items()}, steps)
    for name in fns:  # the 1 x 2 mesh's block-row-sharded BP is plain torch
        check_launches(counts[name], every=() if name == "sharded_1x2" else ("bp_lifted",),
                       on_card=on_card, what=f"lifted_shard {name}")
        check(not any(kept[name]), f"lifted_shard {name}: a row converged or stopped early")
    gates["never_converged"] = (f"no row of any step converged; every row ran {LIFT_ITERS} "
                                "iterations")

    # the sharded BP + OSD end to end once, at a rate where rows fail BP
    p_osd = P_SHARD_OSD
    H_f = torch.as_tensor(H, dtype=torch.float32, device=dev)
    synd_o = error_syndromes(batch_rng(seed, "lifted_shard", EXTRA + 16), H_f, p_osd, batch)
    mesh = Mesh2D((dev, dev), (1, 2))
    bposd = lifted_sharded_bposd_fn(lg, H, mesh, n_shards=2, **bp_kw, osd_method="osd_cs",
                                    osd_order=LIFT_ORDER)
    sg2 = ShardedLiftedGraph(lg, 2)
    pad = torch.cat([synd_o, synd_o.new_zeros(batch, 2 * sg2.mp_chunk * lift - m)], 1)
    l0_o = llr_from_channel(np.full(n, p_osd)).to(dev).expand(batch, n)
    reset_launches()
    osdw, conv = bposd(pad, l0_o)
    bposd_launches = launches()
    check(satisfies(osdw, H_f, synd_o), "lifted_shard: a sharded BP + OSD osdw violates its "
                                        "syndrome")
    if on_card:
        check(bposd_launches["osd_large"] > 0 and bposd_launches["bp_flood"] == 0
              and bposd_launches["bp_lifted"] == 0,
              f"lifted_shard: the sharded BP + OSD did not run K5 alone: {bposd_launches}")
    gates["bposd"] = (f"lifted_sharded_bposd_fn on 1 x 2 at p={p_osd}: {int((~conv).sum())} of "
                      f"{batch} rows through the OSD stage, all satisfied, launches "
                      f"{ {k: v for k, v in bposd_launches.items() if v} }")

    _, trace = trace_step(lambda: [f(extra[WARMUP]) for f in fns.values()])
    med = {k: float(np.median(v)) for k, v in walls.items()}
    per_it = {k: v / LIFT_ITERS for k, v in med.items()}
    return result_line(
        "lifted_shard", "lifted_bp_block_row_sharded_1x2_over_unsharded_time",
        med["sharded_1x2"] / med["unsharded"], "x (sharded 1 x 2 step time / unsharded)",
        walls["sharded_1x2"], seed=seed, steps=steps, first_call_ms=first_call_ms, kernels={},
        trace=trace, gates=gates, dev=dev, batch=batch, lift=lift, max_iter=LIFT_ITERS,
        ratio_1x1=med["sharded_1x1"] / med["unsharded"],
        ms_per_iteration=per_it, spreads={k: spread(v) for k, v in walls.items()})


@contextlib.contextmanager
def recording(on):
    """Record every side decode ``(side, syndromes, BpOsdBatch)`` the
    harness's device object ``on`` makes while the block runs."""
    records = []
    decode_side = on.decode_side

    def recorded(side, synd, first_osdw=None):
        out = decode_side(side, synd, first_osdw)
        records.append((side, synd, out))
        return out

    on.decode_side = recorded
    try:
        yield records
    finally:
        del on.decode_side


def run_harness(seed: int = 0, *, code: str = "400", steps: int = STEPS,
                runs: int = HARNESS_RUNS, batch: int | None = None, device=None) -> dict:
    """``css_decode_sim`` at the flagship example's options, ``runs`` runs a
    step, each step's LER held to the code's committed artifact."""
    from bp_osd_tpu_torch.decoder.osd import osd_route
    from bp_osd_tpu_torch.examples.qldpc_decode_example import OSD_OPTIONS
    from bp_osd_tpu_torch.sim import css_decode_sim

    dev = _device(device)
    qcode = flagship_code(code)
    art = artifact(ARTIFACTS[code])
    opts = dict(OSD_OPTIONS, target_runs=runs, run_sim=0, tqdm_disable=1, check_code=0,
                batch_size=batch or OSD_OPTIONS["batch_size"],
                backend="auto" if dev.type == "cuda" else "torch")

    def make(step):
        with contextlib.redirect_stdout(sys.stderr):  # the harness prints its set-up
            return css_decode_sim(hx=qcode.hx, hz=qcode.hz, **dict(
                opts, seed=harness_seed(batch_rng(seed, "harness", step))))

    def run(sim):
        with contextlib.redirect_stdout(sys.stderr):
            return json.loads(sim.run_decode_sim())

    sync()
    t0 = time.perf_counter()
    run(make(EXTRA))
    sync()
    first_call_ms = (time.perf_counter() - t0) * 1e3
    run(make(EXTRA + 1))
    on_card = dev.type == "cuda"
    sims = [make(s) for s in range(steps)]
    check(all(s.backend == ("cuda" if on_card else "torch") for s in sims),
          "harness: not on the asked device")
    walls, counts, kept = timed_steps({"harness": (lambda s: run(sims[s]), lambda o: o)}, steps)
    outs = kept["harness"]
    used = ("bp_flood", "osd_cs")
    total = check_launches(counts["harness"], every=used, on_card=on_card, what="harness")
    zs = []
    for s, out in enumerate(outs):
        check(out["run_count"] == runs, f"harness step {s}: {out['run_count']} runs, not {runs}")
        zs.append(held_to_artifact(out, art, f"harness [[{qcode.N}]] step {s}"))
    gates = {"ler": f"every step's OSDW LER within {HARNESS_SIGMAS} combined standard errors "
                    f"of {ARTIFACTS[code]} (largest {max(zs):.3f})"}

    sim = make(EXTRA + 2)
    reset_launches()
    with recording(sim._on) as records:
        _, trace = trace_step(lambda: run(sim))
    traced = launches()
    max_iter = int(sim.max_iter) or qcode.N
    sides = sim._on._sides  # side -> (graph, OSD tables, prior, Bayes pair)
    bounds = {"bp_flood": bound_sum(staged_k1_bound(sides[side][0], o.iterations, max_iter)
                                    for side, _, o in records)}
    osd = []
    for side, (g, consts, _, _) in sides.items():  # each side's failing rows in one count
        check(osd_route(g, "osd_cs", int(sim.osd_order)) == "k2", "harness: osd_cs not on K2")
        fail = [(synd[~o.converged], o.llr[~o.converged]) for sd, synd, o in records
                if sd == side]
        if fail:
            osd += osd_bounds(g, torch.cat([f[0] for f in fail]), torch.cat([f[1] for f in fail]),
                              "osd_cs", int(sim.osd_order), consts).values()
    if osd:
        bounds["osd_cs"] = bound_sum(osd)
    kernels = kernel_lines(used, total, traced, trace, bounds)
    med = float(np.median(walls["harness"]))
    osdw = np.array([o["osdw_logical_error_rate"] for o in outs])
    return result_line(
        "harness", f"runs_per_s_css_decode_sim_[[{qcode.N},{qcode.K}]]_flagship_example",
        runs / (med / 1e3), "runs/s", walls["harness"], seed=seed, steps=steps,
        first_call_ms=first_call_ms, kernels=kernels, trace=trace, gates=gates, dev=dev,
        code=code, runs=runs,
        batch=sims[0].batch_size, osdw_ler=spread(osdw),
        osdw_ler_pooled=float(1 - sum(o["osdw_success_count"] for o in outs) / (runs * steps)),
        artifact_osdw_ler=art["osdw_logical_error_rate"], sigmas=spread(zs))


RUNNERS = {"flagship": run_flagship, "api": run_api, "large": run_large,
           "lifted_shard": run_lifted_shard, "harness": run_harness}


def run(mode: str, seed: int = 0, **options) -> dict:
    """Run one mode on the card: its gates, its timed steps, its line."""
    if mode not in RUNNERS:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return RUNNERS[mode](seed, **options)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", required=True, choices=MODES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="timed steps (40 is what a benchmark runs; fewer for smoke runs)")
    ap.add_argument("--code", choices=tuple(SEED_CODES), help="flagship and harness")
    ap.add_argument("--decoder", choices=tuple(DECODERS), help="flagship")
    ap.add_argument("--stage1", type=parse_stage1,
                    help="flagship: the pipeline's stage1_iters, one int or a comma list "
                         "(default: auto_stage_schedule, 24,96 at max_iter 400)")
    ap.add_argument("--p", type=float, help="large: 0.005 (default) or the heavy point 0.028")
    args = ap.parse_args(argv)
    takes = {"code": ("flagship", "harness"), "decoder": ("flagship",), "stage1": ("flagship",),
             "p": ("large",)}
    options = {}
    for opt, modes in takes.items():
        if getattr(args, opt) is not None:
            if args.mode not in modes:
                ap.error(f"--{opt} applies to --mode {' or '.join(modes)}")
            options[opt] = getattr(args, opt)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch.py needs a CUDA card; torch.cuda.is_available() is false")
    from bp_osd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    line = run(args.mode, args.seed, steps=args.steps, **options)
    line["build_s"] = build_s
    print(json.dumps(line))


if __name__ == "__main__":
    main()  # a failed gate raises GateFailed: "FAILED: ..." on stderr, exit code 1
