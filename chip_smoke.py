"""Drive bp_osd_tpu_torch's main path once on a CUDA card, with checks.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, one line each (any failed check exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build the CUDA kernels from ``bp_osd_tpu_torch/csrc``;
3. K1 (``bp_flood.cu``) against its plain torch version on the 512
   syndromes of ``tests/data/flagship_corpus.npz`` ([[400,16,6]], p = 0.05,
   adaptive min-sum, max_iter 400): bit-identical, the corpus's
   ``converged``/``iterations`` reproduced, and the resume chain
   24 -> 96 -> 400 equal to a straight run;
4. K2 (``osd_cs.cu``, order 42) against its plain version on identical LLRs:
   bit-identical, and every osdw satisfies its syndrome;
5. the main path, ``BpOsdDecoder(...).decode_batch``: the corpus's osdw and
   weights bit for bit, then 16384 fresh syndromes (every osdw satisfies its
   syndrome) timed end to end; both kernels' launch counts must be > 0; then
   K1 at each of the decode's three launches (the rows and ``it0`` the
   pipeline gives stages 1-3, CUDA events, median of 5) and K2 on the
   decode's OSD rows, each beside its bound and its plain version, with the
   launch plans (team or warp shape, resident samples per SM from
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, registers); every
   stage's outputs (the state included) and K2's are held bit for bit to the
   plain versions on those inputs; stage 3 again with teams of 1, 2, 3 and 6
   warps and the corpus rows with teams of 3 and 6, each held to the plain
   version;
6. the README golden decode (surface code, errors on qubits 5 and 12);
7. K5 (``osd_large.cu``) against its plain version: (a) K5, K2 and the plain
   version bit-identical on the 512 corpus rows at order 42; (b) on the
   [[10000,420]] lifted product (lift 400) K5 and the plain version
   bit-identical on 8 rows that failed BP and on the first of them alone,
   every output satisfying its syndrome and osdw no heavier than osd0; K5
   timed on 1 row and on the 8 rows, each beside its bound, with its launch
   plan and, from this run's data (:class:`ElimWork`), the column steps,
   pivot steps, hit tests, hit columns and XORed words and the bytes they
   imply in a column-major and in the word-major scratch layout;
   (c) the aux corpus ``lifted_streamed`` (lift 60, where K2 does not fit)
   reproduced through ``BpOsdDecoder(..., proto, lift=60)`` with K5
   launched; the Python mirrors of K2's and K5's shared-memory sizes equal
   the library's;
8. the lifted path at full width: ``BpOsdDecoder(hx, proto=hx_proto,
   lift=400)`` (p = 0.005, min-sum 0.625, max_iter 100, osd_cs order 15) on
   512 fresh syndromes, timed (median of 3 calls), then one batch at
   p = 0.028 where about a quarter of the rows fail BP; every osdw satisfies
   its syndrome, K6 (the lifted BP, once a decode) and K5 are launched, K1
   and K2 are not; the p = 0.028 batch is split into lifted BP (K6),
   argsort, K5 and host glue;
9. K4: its warp kernel (``osd_cs.cu``, the flagship's placement) and its
   block kernel (``gf2_elim.cu``) in shared and in device memory, all five
   outputs equal ``eliminate_plain`` on the 512 corpus rows (skip rows
   zero); the default decoder ``BpOsdDecoder(hx, error_rate=0.05)`` (osd_0,
   max_iter 400) on the 16384 fresh syndromes, timed: every osd0 satisfies
   its syndrome, K4's warp kernel is launched and K2 is not; on that
   decode's OSD rows both K4 kernels bit-identical to the plain version and
   timed beside the bound, the warp kernel's launch plan, and the decode's
   wall split into staged BP, the OSD tail and host glue;
10. K3 (mode "e" of ``osd_cs.cu``): equal to the plain osd_e on the corpus
   rows at orders 12 and 16; the aux corpus ``flagship_osd_e`` reproduced
   through ``BpOsdDecoder(..., osd_method="osd_e", osd_order=12,
   max_iter=100)``; then the 16384 fresh syndromes at osd_e order 12, timed:
   all satisfied, K3 launched, K2 and K4 not; K3 held to the plain osd_e on
   that decode's OSD rows at orders 12 and 16 and timed at both, each beside
   its bound, with its launch plan;
11. the device-memory routes: osd_e order 8 on the lift-60 and lift-100
   ``proto``/``lift`` decoders goes to K4's block kernel (never its warp
   kernel) and the torch search (lift 60 in shared memory, where K4 also
   runs forced to device memory; lift 100 above K4's shared memory, in
   device memory), equal to ``osd_decode_plain`` on
   the rows BP failed; the dense lift-400 ``BpDecoder`` (no ``proto``) runs
   K1 with its state in device memory, bit-identical to ``bp_decode_plain``
   on 64 rows at max_iter 100; the Python mirrors ``k1_fits``/``k4_fits``
   equal the library's sizes;
12. the Monte-Carlo harness ``bp_osd_tpu_torch.sim.css_decode_sim`` on the
   flagship code: (a) one batch of 512 uniforms drawn on the card, through
   the card's harness and the CPU harness (``backend="torch"``), under the
   harness's defaults (``x->z``, bias [1,1,1], osd_cs 2) and the flagship
   example's configuration: every per-sample outcome equal; (b) the flagship
   example (``bp_osd_tpu_torch/examples/qldpc_decode_example.py``) at 100000
   runs: OSDW LER within 4 combined standard errors of
   ``examples/qldpc_decode_results.json``, every X side converged, K1 and K2
   launched, runs/s and one batch split into sampling+logicals, X side and Z
   side; (c) the [[625,25,8]] and [[900,36,10]] examples at 100000 runs
   against ``examples/hgp_{625,900}_decode_results.json`` (4 sigma), and one
   osd_e order-12 run of 16384 that launches K3;
13. ``BpOsdDecoder(schedule="layered")`` (min-sum, adaptive, osd_cs 42) on
   the 512 corpus rows: every output equal to the same decoder on the CPU,
   all satisfied, timed against the flooding decoder;
14. the lifted-product example (``examples/lifted_product_ler.py``'s
   experiment through ``BpOsdDecoder(hx, proto=hx_proto, lift=400)``) at
   p = 0.03, 4096 runs: OSDW LER within 4 sigma of
   ``examples/lifted_product_decode_results.json``, K5 launched; then the
   example's first 8 rows (its rng's first batch) through the same
   decoder on the card and on ``device="cpu"``: equal per sample in
   ``bp_decoding``, ``converge_batch`` and ``osdw``;
15. the data-parallel layer (``bp_osd_tpu_torch.parallel``): (a)
   ``sharded_decode_fn`` over ``make_mesh()`` (every card) on the 16384
   fresh flagship syndromes (adaptive min-sum, max_iter 400, osd_cs 42):
   the four outputs equal ``bp_decode`` + ``osd_decode`` on one card bit for
   bit, every osdw satisfies its syndrome, K1 and K2 launched, median walls
   and syndromes/s beside the unsharded call's; then with the default osd0
   (K4's warp kernel launched, K2 not), bit-identical too; (b) the harness at the
   flagship example's options, 100000 runs, ``use_mesh=1`` against
   ``use_mesh=0``: every counter equal, runs/s of both; (c) two ranks on the
   first card (``mesh=make_mesh(1)``), subprocesses of this script
   (``--rank``) joined by gloo on a free port, at (b)'s configuration: both
   ranks' reduced counters equal the one-process run, every launch on the
   first card, only rank 0's output file exists, each rank's runs/s; (d)
   with two or more cards, (a) over all of them, each shard's tensors on its
   own card while ``cuda:0`` stays current: the outputs equal, every card
   launched K1 and K2, each shard's wall; the sharded decode against one
   card at 512, 4096 and 16384 rows a card; the harness over every card
   against one card at batches 2000 (also with a 1e-4 s thread switch
   interval) and 16384; one rank a card (``use_mesh=-1``): counters equal,
   each rank's launches on its own card, the ranks' runs/s together (with
   one card, a line says that (d) does not apply);
16. the model-parallel layer (``parallel/edge_shard.py``, ``lifted_shard.py``,
   ``large_code.py``) on a 1 x 2 mesh (both model shards on ``cuda:0``; with
   two cards, one each): (a) ``edge_sharded_bposd_fn`` on 16384 fresh
   flagship syndromes (adaptive min-sum, max_iter 400, osd_cs 42): the
   sharded BP equal to K1 bit for bit (hard, llr, converged, iterations),
   osdw equal to ``bp_decode`` + ``osd_decode``, all satisfied, K2 launched
   on every card of the mesh and K1 not; (b) the [[10000,420]] lift-400 code
   at p = 0.028, 512 rows (min-sum 0.625, max_iter 100, osd_cs 15):
   ``lifted_sharded_bposd_fn`` (its BP equal to ``bp_decode_lifted``, K6) and
   ``edge_sharded_bposd_fn`` (its BP equal to K1), osdw equal to the
   unsharded BP + OSD, K5 launched on every card and K1/K2 not; for each
   decode the median of 3 walls and syndromes/s beside the unsharded
   decode's, BP's ms per iteration, the bytes the chain hands between shards
   and the launches by card; (c) with four cards, (b) on 2 x 2 and 1 x 4
   meshes, equal to one card (with fewer, a line says that (c) did not run).
17. the functional API on graphs built with no ``device`` (the card by
   default): (a) ``decode_pipeline(TannerGraph(H), ...)`` on the 512 corpus
   rows as numpy (adaptive min-sum, max_iter 400, osd_cs 42): osdw, weights,
   converged and iterations equal the corpus, every output on the card, K1
   and K2 launched and no other OSD kernel; (b)
   ``bp_decode_lifted(LiftedGraph(hx_proto, 400), ...)`` on 512 numpy
   syndromes at p = 0.005 (min-sum 0.625, max_iter 100): K6 launched once a
   call and no other kernel, equal bit for bit to the same call on a graph
   built with ``device="cuda"``; each call's walls (3 calls);
18. ``bench_torch.py``'s five modes (flagship, api, large, lifted_shard,
   harness) in this process at their default options with 3 timed steps,
   gates included: each mode's JSON line, and the seconds each took;
19. ``decode_pipeline``'s stage schedule (``stage1_iters``) at ``None`` (the
   default, 24 -> 96 -> 400), 32, (8, 32, 128) and 400 (one straight
   launch): (a) on the 512 corpus rows each schedule's six outputs equal
   the corpus and the default schedule's bit for bit (llr as int32 bits),
   K1 launched once a cap (3, 2, 4 and 1 times) and K2 once, each K1
   launch held bit for bit to ``bp_decode_plain`` on its rows and caps;
   (b) on the 16384 fresh syndromes each schedule's outputs equal the
   default's, every osdw satisfied, the decode's median wall of 5, K1's
   device ms at each launch (CUDA events, median of 5) beside its bound,
   and K1's share of the wall;
20. the syndrome check and the code generator: (a) uint8 card tensors
   holding 2 and 255 raise ``ValueError`` at every public entry point
   (``bp_decode``, ``decode_pipeline``, ``osd_decode``,
   ``bp_decode_layered``, ``bp_decode_lifted``, ``BpOsdDecoder.decode_batch``
   and ``decode``, received-vector mode, ``BpDecoder.decode``,
   ``sharded_decode_fn``, ``edge_sharded_bp_fn``) with one check a call and
   no kernel launched, one flagship ``decode_batch`` of the 16384 fresh rows
   makes one check over its three K1 launches, and the check alone on that
   16384 x 192 uint8 tensor is timed (host clock, median of 5); (b)
   ``bp_osd_tpu_torch/examples/generate_hgp_codes.py``'s ``generate`` writes
   into a temporary directory, its ``hx`` file reloaded into a
   ``TannerGraph`` on the card equals the flagship matrix, and
   ``decode_pipeline`` on it reproduces the corpus through K1 and K2;
21. K6 (``bp_lifted.cu``, the whole lifted BP decode in one launch) against
   its plain version ``decoder/lifted_bp.py:_bp_rows`` on the card: hard,
   llr bits, converged and iterations equal under min-sum 0.625, adaptive
   min-sum and product-sum (max_iter 100), on the shared route and forced
   to the device-memory route, on phase 8's 512 lift-400 rows at p = 0.005
   and p = 0.028, 512 rows at lift 60 and lift 100, a lift-400 batch of
   zero syndromes (every row converges at iteration 1), one of uniform
   random syndromes (no row converges), and 64 rows of the lift-400
   protograph's edges lifted to 942 and 943 (either side of the min-sum
   shared route's boundary) and to 1000 (the device-memory route by size);
   the heavy batch again at every team size of the plan's sweep
   (``ops/cuda_lifted_bp.py:TEAM_SIZES``, forced through ``_THREADS``); the
   Python mirror of K6's shared memory equals the library's; the plan
   (threads a row, rows an SM, registers, shared and local memory) and the
   sweep's heavy-batch times and a lone 100-iteration row's ms an
   iteration; K6, its device-memory route and the plain version timed with
   CUDA events on the p = 0.028 and p = 0.005 batches beside K6's bound.
22. K1 where its launches under-fill the card: (a) the gross code
   [[144,12,12]] over 12 noisy rounds (the benchmark cell
   ``gross144.ph12.p025.b4096``'s 936 x 2736 space-time matrix, 4096
   syndromes at p = 0.025, adaptive min-sum to 10^4 iterations, osd_cs 7)
   through ``BpOsdDecoder``: three K1 launches a decode, the recorder's
   stage rows equal K1's stages and ``bp_flood.latency_rows`` the rows of
   the stages on the latency plan, every osdw satisfied; each of the three
   staged K1 launches (``k1_stages``) held to ``bp_decode_plain`` in all
   five outputs, timed (CUDA events, median of 3) beside its bound, with
   its plan (latency or throughput, threads, rows a block, grid,
   registers); (b) 1, SMs + 9 and 2 SMs - 1 rows resumed (the gross
   matrix's stage 2 of 8192 syndromes, iterations 625-2496; the flagship's
   stage 3 of 16384, iterations 97-400), on the plan's choice and with the
   throughput team forced through ``_TEAM_WARPS``, each held to
   ``bp_decode_plain`` in all five outputs and timed beside its bound, the
   two in turns (8 rounds of a median of 3, the order swapped each round).
23. K5 where its launches under-fill the card (``phase23(tag)`` runs alone
   too): on the [[10000,420]] lifted product (lift 400, osd_cs 15), 16
   syndromes that lifted BP leaves at p = 0.005 and 16 at p = 0.028 (errors
   drawn on the card): K5 at 1, 2, 8 and 16 rows in the rule's plan
   (``osd_large_cluster``) and with 1, 2, 4 and 8 blocks a sample, each
   bit-identical to
   ``osd_decode_plain``; a lone row and 8 rows timed in the rule's plan and
   with a block a sample in turns (8 rounds of a median of 3, the order
   swapped each round), and a lone row by blocks a sample; 16, 31, 48 and
   66 BP-failing rows (the rule's middle bands) in every plan of C x rows
   <= SMs, in turns, each equal to a block a sample; 129 rows at
   p = 0.028 (a heavy batch's failures) in the rule's plan (a block a
   sample) and with clusters of 2, equal and timed; the recorder's
   ``osd_large.rows`` and ``osd_large.cluster_rows`` over a cluster launch
   and a heavy one; the rule at 1-132 rows against
   ``cudaOccupancyMaxActiveClusters``; the gross code's space-time matrix
   (936 x 2736, osd_cs 7), 8 rows bit-identical in every plan, a lone
   row timed in each, and 16-66 rows in every plan as at lift 400.
24. K1's wide plan (``phase24(tag)`` runs alone too): the two-gross code
   [[288,12,18]] over 18 noisy rounds (the benchmark cell
   ``twogross288.ph18.p015.b4096``'s 2736 x 8064 space-time matrix, 4096
   syndromes at p = 0.015, adaptive min-sum to 10^4 iterations, osd_cs 7)
   through ``BpOsdDecoder``: three K1 launches a decode, the recorder's
   stage rows equal K1's stages, ``bp_flood.wide_rows`` the rows of the
   stages on the wide plan and ``bp_flood.wide_row_iters`` their
   iterations, every osdw satisfied; each staged K1 launch held to
   ``bp_decode_plain`` in all five outputs and timed beside its bound in
   the wide plan (every stage, stage 1's 4096 rows on persistent blocks)
   and with the device-memory placement forced (``_TEAM_WARPS``), in
   turns, with its row-iterations (``bp.row_iters.<i>``) and the ns a
   row-iteration of each.

The helpers for timing, bounds and gates are those of
``bp_osd_tpu_torch/utils/measure.py``, which ``bench_torch.py`` shares.  It
prints the card's name and power limit and a JSON line of per-kernel
results before the last line, ``{"ok": true, "device": {...}}``.  Each kernel
there has its launches on the main path's run, per decode of the path
that uses it and in phase 16's model-sharded decodes
(``launches_model_parallel``), its time, its plain version's time, its bound and what sets
the bound (no single PyTorch call computes any of them: ``library_ms`` is
null).  A bound is the larger of the bytes the call must move (each input
read once, each output written once) over 3.35 TB/s and its operations over
the peak rate of their type: float32 at 67 TFLOP/s, integer at 64 INT32
lanes x 132 SMs x 1.98 GHz = 16.73 Tops/s (the larger of the two), counted
from this run's data (the iterations each BP row ran; the pivot searches,
the hit tests at pivot steps and the nonzero words XORed that each
elimination needs: :func:`elim_work`).  The OSD kernels also carry
``bound_ms_all_columns``, the earlier and larger count in which every
column step tests every column and XORs every word of a hit column.  The JAX package is
not imported: the JAX reference enters only through the committed corpora
and LER artifacts.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from bp_osd_tpu_torch.utils.measure import (Bound, ElimWork, artifact, artifact_sigmas,
                                           bound_sum, bound_text, card_line, check,
                                           corpus_check, cuda_ms, elim_bound, elim_work, host_ms,
                                           k1_bound, k1_equal, k1_merged, k1_stages,
                                           k1_stages_equal_plain, osd_cs_bound,
                                           osd_e_bound, reset_launches, same, satisfies, sigmas,
                                           sync)
from bp_osd_tpu_torch.utils.measure import launches as launch_counts

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "tests", "data", "flagship_corpus.npz")
AUX = os.path.join(ROOT, "tests", "data", "aux_corpora.npz")
SEED = 20261016
FRESH = 16384
# the (3,4)-regular lifted product of bench_large.py: [[10000,420]] at lift 400
PROTO = [[(0,), (0,), (0,), (0,)], [(0,), (1,), (2,), (3,)], [(0,), (2,), (4,), (6,)]]
LIFT, LIFT_P, LIFT_HEAVY_P, LIFT_B, LIFT_ORDER = 400, 0.005, 0.028, 512, 15
SIM_ROWS, SIM_RUNS, LIFT_RUNS = 512, 100000, 4096  # phases 12-14
LIFT_CPU_ROWS = 8  # phase 14's lift-400 rows on the CPU, whose plain OSD is slow at n = 10^4
STAGE_SCHEDULES = (None, 32, (8, 32, 128), 400)  # phase 19's stage1_iters
# phase 22: the benchmark cell gross144.ph12.p025.b4096's space-time decode
GROSS_ROUNDS, GROSS_P, GROSS_B, GROSS_ITERS = 12, 0.025, 4096, 10000
PAIR_ROUNDS = 8  # phase 22b: rounds of the plan's choice against the throughput team
BAND_ROWS = (16, 31, 48, 66)  # phase 23: K5 launches in the cluster rule's middle bands
# phase 24: the benchmark cell twogross288.ph18.p015.b4096's space-time decode
TWO_GROSS_ROUNDS, TWO_GROSS_P, TWO_GROSS_B = 18, 0.015, 4096
WIDE_ROUNDS = 4  # phase 24: rounds of the wide plan against the device-memory placement
BIG_RUNS = 6 * 16384  # phase 15d's harness at batch 16384
RANK_TIMEOUT = 300  # seconds the phase-15c ranks may take, start-up included


def plan_line(plan: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in plan.items())


def _with_team(warps, fn):
    """``fn()`` with K1's teams forced to ``warps`` warps (the throughput
    plan), through ``ops/cuda_bp.py:_TEAM_WARPS``."""
    from bp_osd_tpu_torch.ops import cuda_bp

    cuda_bp._TEAM_WARPS = warps
    try:
        return fn()
    finally:
        cuda_bp._TEAM_WARPS = 0


def phase12(dev, qcode, tag, rows=SIM_ROWS, runs=SIM_RUNS,
            osd_e_runs=FRESH) -> None:
    """The Monte-Carlo harness: (a) one batch on the card against the CPU
    harness on the same uniforms; (b) the flagship example at ``runs`` runs
    against its committed artifact, split into sampling+logicals, X side and
    Z side; (c) the [[625]] and [[900]] examples against theirs, and one
    osd_e order-12 run."""
    from bp_osd_tpu_torch.codes import hgp, mkmn_20_5_8, mkmn_24_6_10
    from bp_osd_tpu_torch.examples.qldpc_decode_example import OSD_OPTIONS
    from bp_osd_tpu_torch.sim import css_decode_sim

    quiet = dict(run_sim=0, tqdm_disable=1, check_code=0)
    configs = {"defaults": dict(error_rate=0.05), "flagship example": OSD_OPTIONS}
    report = []
    for name, opts in configs.items():
        kw = dict(opts, **quiet, seed=SEED, batch_size=rows)
        card = css_decode_sim(hx=qcode.hx, hz=qcode.hz, **kw)
        host = css_decode_sim(hx=qcode.hx, hz=qcode.hz, backend="torch", **kw)
        check(card.backend == "cuda", "the harness is not on the card")
        rand = torch.rand(rows, card.N, generator=torch.Generator(dev).manual_seed(SEED),
                          device=dev)
        reset_launches()
        got = card._batch_stats(rand)
        launched = launch_counts()
        want = host._batch_stats(rand.cpu())
        for k in want:
            check(np.array_equal(got[k].cpu().numpy(), want[k].numpy()),
                  f"harness {name}: {k} on the card != the CPU harness")
        check(launched["bp_flood"] > 0 and launched["osd_cs"] > 0,
              f"harness {name}: kernels {launched}")
        report.append(f"{name} ({card.channel_update}, bias {card.xyz_error_bias}, "
                      f"osd_cs {card.osd_order}): {int(want['osdw_success'].sum())}/{rows} "
                      f"osdw successes")
    print(f"phase 12a harness batch of {rows} on the card == the CPU harness per sample on "
          "the same uniforms: " + "; ".join(report))

    def run(code, **opts):
        sim = css_decode_sim(hx=code.hx, hz=code.hz, **dict(OSD_OPTIONS, **quiet, **opts))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = json.loads(sim.run_decode_sim())
        torch.cuda.synchronize()
        return sim, out, time.perf_counter() - t0

    def held(out, art, what):
        z = artifact_sigmas(out, art)
        check(z <= 4.0, f"{what} OSDW LER {out['osdw_logical_error_rate']} is {z:.2f} sigma "
                        f"from the artifact's {art['osdw_logical_error_rate']}")
        return (f"OSDW LER {out['osdw_logical_error_rate']:.5f} +- "
                f"{out['osdw_logical_error_rate_eb']:.5f} ({z:.2f} sigma from the artifact's "
                f"{art['osdw_logical_error_rate']:.4f}), OSD0 "
                f"{out['osd0_logical_error_rate']:.5f}, BP {out['bp_logical_error_rate']:.5f}")

    reset_launches()
    sim, out, wall = run(qcode, target_runs=runs)
    launches = launch_counts()
    check(out["run_count"] == runs and out["bp_converge_count_x"] == runs,
          f"flagship harness counters: {out['run_count']} runs, "
          f"{out['bp_converge_count_x']} X-side convergences")
    check(launches["bp_flood"] > 0 and launches["osd_cs"] > 0, f"harness kernels {launches}")
    flagship = held(out, artifact("qldpc_decode_results.json"), "flagship")
    # one batch of the run's size, split: draw + errors + syndromes, X side, Z side, logicals
    B = sim.batch_size
    g = torch.Generator(dev).manual_seed(SEED + 12)
    ex, ez, sx, sz = sim._sample(torch.rand(B, sim.N, generator=g, device=dev))
    ox, oz = sim._decode_side("x", sx), sim._decode_side("z", sz)
    sample_ms = cuda_ms(lambda: sim._sample(torch.rand(B, sim.N, generator=g, device=dev)), 3)
    x_ms = cuda_ms(lambda: sim._decode_side("x", sx), 3)
    z_ms = cuda_ms(lambda: sim._decode_side("z", sz), 3)
    logic_ms = cuda_ms(lambda: sim._outcomes(ex, ez, ox, oz), 3)
    print(f"phase 12b flagship example harness, {runs} runs in batches of {B}: {flagship}; "
          f"{runs / wall:.1f} runs/s ({wall:.3f} s, {wall * 1e3 * B / runs:.3f} ms per batch); "
          f"one batch: sampling {sample_ms:.3f} + logicals {logic_ms:.3f} ms, X side "
          f"{x_ms:.3f} ms, Z side {z_ms:.3f} ms ({int(oz.converged.sum())}/{B} converged); "
          f"launches {launches} {tag}")

    report = []
    for name, seed_fn in (("625", mkmn_20_5_8), ("900", mkmn_24_6_10)):
        code = hgp(seed_fn())
        reset_launches()
        _, out, wall = run(code, target_runs=runs)
        check(launch_counts()["osd_cs"] > 0, f"[[{code.N}]] harness did not launch K2")
        art = artifact(f"hgp_{name}_decode_results.json")
        report.append(f"[[{code.N},{code.K}]] {held(out, art, name)}, {runs / wall:.1f} runs/s")
    reset_launches()
    _, out, wall = run(qcode, target_runs=osd_e_runs, batch_size=0, osd_method="osd_e",
                       osd_order=12)
    launched = launch_counts()
    check(launched["osd_e"] > 0 and launched["osd_cs"] == 0, f"osd_e harness kernels {launched}")
    print(f"phase 12c " + "; ".join(report) + f"; flagship at osd_e order 12, {osd_e_runs} runs "
          f"in one batch: OSDW LER {out['osdw_logical_error_rate']:.5f} +- "
          f"{out['osdw_logical_error_rate_eb']:.5f}, {osd_e_runs / wall:.1f} runs/s, launches "
          f"{launched} {tag}")


def phase13(H, synd, dec_flood, tag) -> None:
    """Layered BpOsdDecoder on the card against the same decoder on the CPU,
    timed against the flooding decoder."""
    from bp_osd_tpu_torch import BpOsdDecoder

    kw = dict(error_rate=0.05, max_iter=0, bp_method="ms", ms_scaling_factor=0,
              osd_method="osd_cs", osd_order=42, schedule="layered")
    card = BpOsdDecoder(H, **kw)
    host = BpOsdDecoder(H, device="cpu", **kw)
    H_f = torch.as_tensor(H, dtype=torch.float32, device=synd.device)
    out = card.decode_batch(synd, outputs="device")
    check(satisfies(out, H_f, synd), "a layered osdw violates its syndrome")
    host.decode_batch(synd.cpu())
    for a in ("osdw_decoding_batch", "osd0_decoding_batch", "bp_decoding_batch",
              "log_prob_ratios_batch", "converge_batch", "iter_batch"):
        check(np.array_equal(getattr(card, a).cpu().numpy(), getattr(host, a)),
              f"layered {a} on the card != the CPU")
    walls = {}
    for name, dec in (("flooding", dec_flood), ("layered", card), ("layered ", card),
                      ("flooding ", dec_flood)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.decode_batch(synd, outputs="device")
        torch.cuda.synchronize()
        walls.setdefault(name.strip(), []).append(time.perf_counter() - t0)
    conv = card.converge_batch
    print(f"phase 13 layered BpOsdDecoder (min-sum, adaptive, max_iter 400, osd_cs 42) on the "
          f"{synd.shape[0]} corpus rows: card == CPU in every output, all satisfied; converged "
          f"{int(conv.sum())}, mean iterations of the converged "
          f"{float(card.iter_batch[conv].float().mean()):.2f} (flooding "
          f"{float(dec_flood.iter_batch[dec_flood.converge_batch].float().mean()):.2f}); "
          f"walls layered {[round(w * 1e3, 3) for w in walls['layered']]} ms, flooding "
          f"{[round(w * 1e3, 3) for w in walls['flooding']]} ms {tag}")


def phase14(qcode, tag, runs=LIFT_RUNS) -> None:
    """The lifted-product LER example at p = 0.03 against its artifact, then
    the example's first :data:`LIFT_CPU_ROWS` rows through its decoder on the
    card and on the CPU, equal per sample."""
    from bp_osd_tpu_torch import BpOsdDecoder
    from bp_osd_tpu_torch.examples import lifted_product_ler as ex
    from bp_osd_tpu_torch.examples.lifted_product_ler import run_point
    from bp_osd_tpu_torch.sim.css_decode_sim import _mod2mul

    art = artifact("lifted_product_decode_results.json")["points"]["0.03"]
    reset_launches()
    t0 = time.perf_counter()
    point = run_point(qcode, 0.03, runs)
    wall = time.perf_counter() - t0
    launched = launch_counts()
    z = sigmas(point["osdw_logical_error_rate"], point["osdw_error_bar"],
               art["osdw_logical_error_rate"], art["osdw_error_bar"])
    check(z <= 4.0, f"lifted OSDW LER {point['osdw_logical_error_rate']} is {z:.2f} sigma from "
                    f"the artifact's {art['osdw_logical_error_rate']}")
    check(launched["osd_large"] > 0, f"the lifted example did not launch K5: {launched}")
    keys = [k for k in art if k != "runtime_s"]
    print(f"phase 14 lifted-product example, p = 0.03, {point['runs']} runs: {point} "
          f"({z:.2f} sigma from the artifact's OSDW LER); every field but the runtime equal to "
          f"the artifact: {all(point[k] == art[k] for k in keys)}; {wall:.3f} s, "
          f"{point['runs'] / wall:.1f} runs/s; launches {launched} {tag}")

    # the example's first rows (its rng, its first batch) on the card and on the CPU
    t0 = time.perf_counter()
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    rng = np.random.default_rng(ex.SEED)
    err = (rng.random((ex.B, H.shape[1])) < 0.03).astype(np.uint8)[:LIFT_CPU_ROWS]
    synd = _mod2mul(torch.as_tensor(err), torch.as_tensor(H, dtype=torch.float32))
    outs = {}
    for device in ("cuda", "cpu"):
        dec = BpOsdDecoder(qcode.hx, proto=qcode.hx_proto, lift=qcode.lift, error_rate=0.03,
                           max_iter=ex.MAX_ITER, bp_method="minimum_sum",
                           ms_scaling_factor=0.625, osd_method="osd_cs",
                           osd_order=ex.OSD_ORDER, device=device)
        t = time.perf_counter()
        dec.decode_batch(synd.to(dec.device))
        outs[device] = (dec.bp_decoding_batch, dec.converge_batch, dec.osdw_decoding_batch,
                        time.perf_counter() - t)
    for name, a, b in zip(("bp_decoding", "converge_batch", "osdw"), outs["cuda"], outs["cpu"]):
        check(np.array_equal(a, b), f"phase 14 lifted rows: {name} on the card != the CPU")
    conv = int(outs["cpu"][1].sum())
    print(f"phase 14 the example's first {LIFT_CPU_ROWS} rows at p = 0.03 through "
          f"BpOsdDecoder(proto, lift={qcode.lift}): card == CPU per sample in bp_decoding, "
          f"converge_batch and osdw ({conv} converged, {LIFT_CPU_ROWS - conv} through OSD); "
          f"card {outs['cuda'][3]:.3f} s, CPU {outs['cpu'][3]:.3f} s, all "
          f"{time.perf_counter() - t0:.1f} s {tag}")


def phase15(H, fresh, tag) -> None:
    """The data-parallel layer: (a) the sharded decode over every card
    against the unsharded decode; (b) the harness with and without the mesh;
    (c) two gloo ranks on one card; (d) the shards on several cards."""
    from bp_osd_tpu_torch.decoder import TannerGraph, bp_decode, osd_decode
    from bp_osd_tpu_torch.decoder.bp import llr_from_channel
    from bp_osd_tpu_torch.examples.qldpc_decode_example import OSD_OPTIONS
    from bp_osd_tpu_torch.ops.cuda_bp import bp_flood
    from bp_osd_tpu_torch.ops.cuda_osd import osd_cs
    from bp_osd_tpu_torch.parallel import (make_mesh, shard_batch_fn, shard_decode_fn,
                                           sharded_decode_fn)

    dev = fresh.device
    B, n = fresh.shape[0], H.shape[1]
    graph = TannerGraph(H, dev)
    H_f = torch.as_tensor(H, dtype=torch.float32, device=dev)
    llr0 = llr_from_channel(np.full(n, 0.05)).to(dev).expand(B, n).contiguous()
    kw = dict(bp_method="minimum_sum", max_iter=0, ms_scaling_factor=0.0)
    osd_kw = dict(osd_method="osd_cs", osd_order=42)

    def unsharded(g, synd, l0, **osd):
        bp = bp_decode(g, synd, l0, **kw)
        osd = osd_decode(g, synd, bp.llr, **(osd or osd_kw))
        keep = bp.converged[:, None]
        return (torch.where(keep, bp.hard, osd.osdw), torch.where(keep, bp.hard, osd.osd0),
                bp.hard, bp.converged)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    mesh = make_mesh()
    sharded = sharded_decode_fn(graph, mesh, **kw, **osd_kw)
    want = unsharded(graph, fresh, llr0)
    reset_launches()
    got = sharded(fresh, llr0)
    launched = launch_counts()
    for name, a, b in zip(("osdw", "osd0", "bp_hard", "converged"), got, want):
        check(same(a, b), f"15a sharded {name} != the unsharded decode")
    check(satisfies(got[0], H_f, fresh), "15a: a sharded osdw violates its syndrome")
    check(launched["bp_flood"] > 0 and launched["osd_cs"] > 0, f"15a kernels {launched}")
    walls = {"unsharded": [], "sharded": []}
    for name in ("unsharded", "sharded", "sharded", "unsharded", "unsharded", "sharded"):
        fn = sharded if name == "sharded" else lambda s, l: unsharded(graph, s, l)
        walls[name].append(wall(lambda: fn(fresh, llr0))[1])
    med = {k: float(np.median(v)) for k, v in walls.items()}
    # the JAX function's default OSD, osd0: K4's warp kernel on every shard
    reset_launches()
    got0 = sharded_decode_fn(graph, mesh, **kw)(fresh, llr0)
    launched0 = launch_counts()
    want0 = unsharded(graph, fresh, llr0, osd_method="osd0", osd_order=0)
    check(all(same(a, b) for a, b in zip(got0, want0)), "15a sharded osd0 != unsharded")
    check(satisfies(got0[1], H_f, fresh), "15a: a sharded osd0 violates its syndrome")
    check(launched0["eliminate_warp"] > 0 and launched0["osd_cs"] == 0,
          f"15a osd0 kernels {launched0}")
    print(f"phase 15a sharded_decode_fn over make_mesh() ({len(mesh)} card(s)) on {B} fresh "
          f"flagship syndromes (adaptive min-sum, max_iter {n}, osd_cs 42): osdw/osd0/bp_hard/"
          f"converged bit-identical to bp_decode + osd_decode on one card, all satisfied, "
          f"{int((~want[3]).sum())} OSD rows; launches {launched}; the default osd0 sharded "
          f"the same way bit-identical too, launches {launched0}; median wall sharded "
          f"{med['sharded'] * 1e3:.3f} ms ({B / med['sharded']:.1f} syndromes/s) vs unsharded "
          f"{med['unsharded'] * 1e3:.3f} ms ({B / med['unsharded']:.1f} syndromes/s); walls "
          f"{ {k: [round(w * 1e3, 3) for w in v] for k, v in walls.items()} } ms {tag}")

    # (b) the harness with and without the mesh, same seed and batch size
    from bp_osd_tpu_torch.codes import hgp, mkmn_16_4_6
    from bp_osd_tpu_torch.sim import css_decode_sim

    qcode = hgp(mkmn_16_4_6())
    opts = dict(OSD_OPTIONS, target_runs=SIM_RUNS, run_sim=0, tqdm_disable=1, check_code=0)
    runs = {}
    for use_mesh in (0, 1, 1, 0, 0, 1):
        sim = css_decode_sim(hx=qcode.hx, hz=qcode.hz, use_mesh=use_mesh, **opts)
        check(sim.use_mesh == use_mesh and sim.backend == "cuda", "15b harness settings")
        reset_launches()
        _, w = wall(sim.run_decode_sim)
        launched = launch_counts()
        check(launched["bp_flood"] > 0 and launched["osd_cs"] > 0, f"15b kernels {launched}")
        c = {k: getattr(sim, k) for k in _SIM_COUNTERS}
        check(runs.setdefault("counters", c) == c,
              f"15b use_mesh={use_mesh} counters {c} != {runs['counters']}")
        runs.setdefault(use_mesh, []).append(sim.run_count / w)
    print(f"phase 15b flagship example harness, {SIM_RUNS} runs in batches of "
          f"{OSD_OPTIONS['batch_size']}: use_mesh=1 == use_mesh=0 in every counter "
          f"{runs['counters']}; runs/s use_mesh=0 {[round(r, 1) for r in runs[0]]}, use_mesh=1 "
          f"{[round(r, 1) for r in runs[1]]} {tag}")

    # (c) two ranks sharing the first card, at (b)'s configuration
    ranks, files, total = run_ranks(2, "first", OSD_OPTIONS["batch_size"], SIM_RUNS)
    for r, rank in enumerate(ranks):
        check(rank["counters"] == runs["counters"],
              f"15c rank {r} counters {rank['counters']} != one process {runs['counters']}")
        check(rank["launches"]["bp_flood"] > 0 and rank["launches"]["osd_cs"] > 0,
              f"15c rank {r} kernels {rank['launches']}")
        check(all(set(on) == {"0"} for on in rank["launches_on"].values()),
              f"15c rank {r} launched off the first card: {rank['launches_on']}")
    check(files == ["rank0.json"], f"15c output files {files}")
    print(f"phase 15c two gloo ranks on {torch.cuda.get_device_name(0)} (cuda:0, {SIM_RUNS} "
          f"runs, {OSD_OPTIONS['batch_size'] // 2} rows of each batch a rank): both ranks' "
          f"reduced counters == one process, only rank 0's output file; runs/s of each rank's "
          f"run {[round(SIM_RUNS / k['wall'], 1) for k in ranks]} (walls "
          f"{[round(k['wall'], 3) for k in ranks]} s; {total:.1f} s with start-up); "
          f"{rank_split(ranks)}; launches {[k['launches'] for k in ranks]} {tag}")

    # (d) shards on several cards, cuda:0 current in every worker thread
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"phase 15d did not run: it needs two or more cards, this machine has {cards}")
        return
    shard_walls = {}

    def timed_shard(synd, l0):
        g = graph.to(synd.device)
        check(torch.cuda.current_device() == 0, "15d: a worker thread changed the current card")
        out, shard_walls[synd.device.index] = wall(lambda: unsharded(g, synd, l0))
        return out

    for f in (bp_flood, osd_cs):
        f.launches_on.clear()
    got = sharded(fresh, llr0)
    per_card = {f.__name__: dict(f.launches_on) for f in (bp_flood, osd_cs)}
    for name, a, b in zip(("osdw", "osd0", "bp_hard", "converged"), got, want):
        check(same(a, b), f"15d sharded {name} over {cards} cards != the unsharded decode")
    check(all(per_card[f][i] > 0 for f in per_card for i in range(cards)),
          f"15d: a card did not run its own launches: {per_card}")
    timed = shard_decode_fn(timed_shard, mesh)
    out, w = wall(lambda: timed(fresh, llr0))
    check(all(same(a, b) for a, b in zip(out, want)), "15d timed shards != unsharded")
    print(f"phase 15d {cards} cards, cuda:0 current while shard k's tensors sit on cuda:k: "
          f"outputs bit-identical, launches by card {per_card}; shard walls "
          f"{ {k: round(v * 1e3, 3) for k, v in sorted(shard_walls.items())} } ms in a "
          f"{w * 1e3:.3f} ms sharded call {tag}")

    # (d) where the mesh starts to pay: the sharded decode over every card
    # against one card, by rows a card
    g = torch.Generator(dev).manual_seed(SEED + 15)
    scan = []
    for per in (512, 4096, 16384):
        rows = per * cards
        synd = torch.remainder((torch.rand(rows, n, generator=g, device=dev) < 0.05).float()
                               @ H_f.T, 2).to(torch.uint8)
        l0 = llr0[:1].expand(rows, n).contiguous()
        check(all(same(a, b) for a, b in zip(sharded(synd, l0), unsharded(graph, synd, l0))),
              f"15d sharded != unsharded at {rows} rows")
        ws = {"unsharded": [], "sharded": []}
        for name in ("unsharded", "sharded", "sharded", "unsharded", "unsharded", "sharded"):
            fn = sharded if name == "sharded" else lambda s, l: unsharded(graph, s, l)
            ws[name].append(wall(lambda: fn(synd, l0))[1])
        one, many = (float(np.median(ws[k])) for k in ("unsharded", "sharded"))
        scan.append(f"{per} rows a card (B {rows}): one card {one * 1e3:.3f} ms "
                    f"({rows / one:.1f} syndromes/s), {cards} cards {many * 1e3:.3f} ms "
                    f"({rows / many:.1f} syndromes/s), {one / many:.3f}x")
    print(f"phase 15d sharded decode over {cards} cards against one card, medians of 3, "
          f"bit-identical: " + "; ".join(scan) + f" {tag}")

    # (d) the harness over every card: at (b)'s batch with the interpreter's
    # default thread switch interval and a short one, and at batch 16384
    # (BIG_RUNS, whole batches, so that ranks, which trim no batch, match)
    def harness(use_mesh, **kw):
        sim = css_decode_sim(hx=qcode.hx, hz=qcode.hz, use_mesh=use_mesh, **dict(opts, **kw))
        _, w = wall(sim.run_decode_sim)
        return {k: getattr(sim, k) for k in _SIM_COUNTERS}, sim.run_count / w

    rates, big = {}, {}
    default_interval = sys.getswitchinterval()
    for name, interval, use_mesh, batch in (
            ("batch 2000, one card", default_interval, 0, 2000),
            ("batch 2000, mesh", default_interval, 1, 2000),
            ("batch 2000, mesh, switch interval 1e-4 s", 1e-4, 1, 2000),
            ("batch 16384, one card", default_interval, 0, 16384),
            ("batch 16384, mesh", default_interval, 1, 16384)):
        sys.setswitchinterval(interval)
        try:
            c, rates[name] = harness(use_mesh, batch_size=batch,
                                     target_runs=SIM_RUNS if batch == 2000 else BIG_RUNS)
        finally:
            sys.setswitchinterval(default_interval)
        ref = runs["counters"] if batch == 2000 else big.setdefault("counters", c)
        check(c == ref, f"15d harness {name} counters {c} != {ref}")
    print(f"phase 15d flagship example harness over {cards} cards, {SIM_RUNS} runs at batch "
          f"2000 and {BIG_RUNS} at 16384, counters equal to one card at each batch; runs/s "
          f"{ {k: round(v, 1) for k, v in rates.items()} } {tag}")

    # (d) one harness batch of (b)'s size over the mesh: each shard's wall on
    # its worker thread, against the shards in turn on this thread and the
    # whole batch on one card
    sim0 = css_decode_sim(hx=qcode.hx, hz=qcode.hz, use_mesh=0, **opts)
    rand = torch.rand(sim0.batch_size, sim0.N, generator=g, device=dev)
    stats_walls = {}

    def timed_stats(part, on):
        t0 = time.perf_counter()
        out = on.batch_stats(part)
        torch.cuda.synchronize(part.device)
        stats_walls.setdefault(part.device.index, []).append((time.perf_counter() - t0) * 1e3)
        return out

    ons = [sim0._on.to(d) for d in mesh.devices]
    parts = rand.chunk(len(mesh))
    timed_batch = shard_batch_fn(timed_stats, mesh)
    mesh_ms = host_ms(lambda: timed_batch(rand, sim0._on), 5)
    turn_ms = host_ms(lambda: [on.batch_stats(p.to(on.device)) for on, p in zip(ons, parts)], 5)
    one_ms = host_ms(lambda: sim0._on.batch_stats(rand), 5)
    print(f"phase 15d one harness batch of {sim0.batch_size} (medians of 5): one card "
          f"{one_ms:.3f} ms; {cards} cards, a worker thread each {mesh_ms:.3f} ms (shard walls "
          f"{ {k: round(float(np.median(v)), 3) for k, v in sorted(stats_walls.items())} } ms); "
          f"the shards in turn on one thread {turn_ms:.3f} ms {tag}")

    # (d) one rank a card, each on its own card by default, at (b)'s
    # configuration and at batch 16384
    for batch, total_runs, ref in ((2000, SIM_RUNS, runs["counters"]),
                                   (16384, BIG_RUNS, big["counters"])):
        ranks, files, total = run_ranks(cards, "own", batch, total_runs)
        for r, rank in enumerate(ranks):
            check(rank["counters"] == ref,
                  f"15d rank {r} at batch {batch}: counters {rank['counters']} != one process {ref}")
            check(all(set(on) == {str(r)} for on in rank["launches_on"].values())
                  and rank["launches"]["bp_flood"] > 0,
                  f"15d rank {r} did not launch on its own card only: {rank['launches_on']}")
        check(files == ["rank0.json"], f"15d output files {files}")
        slowest = max(k["wall"] for k in ranks)
        print(f"phase 15d {cards} gloo ranks, one a card (use_mesh=-1, LOCAL_RANK's card), "
              f"{total_runs} runs in batches of {batch}: reduced counters == one process on "
              f"every rank, each rank's launches on its own card; {total_runs / slowest:.1f} "
              f"runs/s together (slowest rank {slowest:.3f} s; walls "
              f"{[round(k['wall'], 3) for k in ranks]} s; {total:.1f} s with start-up); "
              f"{rank_split(ranks)} {tag}")


def interleaved_walls(fns: dict, reps: int = 3) -> dict:
    """Median host seconds of each ``fns[name]()``, every card synchronised
    before and after, the calls taken in turn ``reps`` times."""
    walls = {k: [] for k in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls[name].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in walls.items()}


def chain_bytes(shards: int, lanes: int, n: int, iters: torch.Tensor) -> tuple[int, int]:
    """Bytes a model-sharded BP hands between shards: each iteration, each
    hop of the chain carries ``lanes`` running sums ``[rows, n]`` f32, the
    totals go back to every other shard (``[rows, n]`` f32) and each other
    shard's parity verdict comes home (``[rows]`` bool), for the rows still
    live (a row is live in iterations ``1 .. iters[row]``).  Returns the
    first iteration's bytes and the whole run's."""
    per_row = (shards - 1) * ((lanes + 1) * 4 * n + 1)
    return per_row * iters.numel(), per_row * int(iters.long().sum())


def phase16(tag, qcode=None) -> dict:
    """The model-parallel layer (``edge_shard``, ``lifted_shard``,
    ``large_code``): (a) the flagship on a 1 x 2 mesh, (b) [[10000,420]] on a
    1 x 2 mesh, (c) with four cards, (b) on 2 x 2 and 1 x 4 meshes.  Returns
    each kernel's launches in the model-sharded decodes."""
    from bp_osd_tpu_torch.codes import hgp, lifted_hgp, mkmn_16_4_6
    from bp_osd_tpu_torch.decoder import TannerGraph, bp_decode, osd_decode
    from bp_osd_tpu_torch.decoder.bp import bp_decode_plain, llr_from_channel
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
    from bp_osd_tpu_torch.ops.cuda_bp import bp_flood
    from bp_osd_tpu_torch.ops.cuda_gf2 import eliminate
    from bp_osd_tpu_torch.ops.cuda_lifted_bp import bp_lifted
    from bp_osd_tpu_torch.ops.cuda_osd import osd_cs, osd_e
    from bp_osd_tpu_torch.ops.cuda_osd_large import osd_large
    from bp_osd_tpu_torch.parallel import Mesh2D, ShardedTannerGraph, edge_sharded_bp_fn
    from bp_osd_tpu_torch.parallel.large_code import (edge_sharded_bposd_fn,
                                                      lifted_sharded_bposd_fn)
    from bp_osd_tpu_torch.parallel.lifted_shard import ShardedLiftedGraph, lifted_sharded_bp_fn
    from bp_osd_tpu_torch.parallel.mesh import make_mesh_2d

    dev = torch.device("cuda", 0)
    cards = torch.cuda.device_count()
    wrappers = (bp_flood, osd_cs, osd_e, eliminate, osd_large, bp_lifted)
    model_parallel = {f.__name__: 0 for f in wrappers}

    def reset():
        for f in wrappers:
            f.launches = 0
            f.launches_on.clear()

    def launched():
        out = {f.__name__: dict(f.launches_on) for f in wrappers if f.launches}
        for f in wrappers:
            model_parallel[f.__name__] += f.launches
        return out

    def pair_mesh():
        """Two model shards: on cuda:0 and cuda:1 where there are two cards,
        else both on cuda:0."""
        return make_mesh_2d(1, 2) if cards >= 2 else Mesh2D((dev, dev), (1, 2))

    def mesh_name(mesh):
        return f"{mesh.shape[0]} x {mesh.shape[1]} ({', '.join(map(str, mesh.devices))})"

    def bp_equal(got, want, what):
        for name, a, b in zip(("hard", "llr", "converged", "iterations"), got, want):
            check(same(a, b), f"{what}: {name} differs")

    def syndromes(H_f, B, p, seed):
        g = torch.Generator(dev).manual_seed(seed)
        err = (torch.rand(B, H_f.shape[1], generator=g, device=dev) < p).float()
        return torch.remainder(err @ H_f.T, 2).to(torch.uint8)

    def ms_per_it(wall, iters):
        return wall * 1e3 / max(int(iters.max()), 1)

    # (a) the flagship, full width, on a 1 x 2 mesh
    H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
    m, n = H.shape
    graph = TannerGraph(H, dev)
    H_f = torch.as_tensor(H, dtype=torch.float32, device=dev)
    B = FRESH
    synd = syndromes(H_f, B, 0.05, SEED + 16)
    llr0 = llr_from_channel(np.full(n, 0.05)).to(dev).expand(B, n).contiguous()
    kw = dict(bp_method="minimum_sum", max_iter=0, ms_scaling_factor=0.0)
    osd_kw = dict(osd_method="osd_cs", osd_order=42)
    mesh = pair_mesh()
    sg = ShardedTannerGraph(H, 2)
    synd_pad = torch.cat([synd, synd.new_zeros(B, 2 * sg.m_chunk - m)], 1)
    bp_sh = edge_sharded_bp_fn(sg, mesh, **kw)
    bposd = edge_sharded_bposd_fn(sg, mesh, **kw, **osd_kw)
    reset()
    got = bp_sh.decode(synd_pad, llr0)
    check(bp_flood.launches == 0, "16a: the model-sharded BP launched K1")
    want = bp_decode(graph, synd, llr0, **kw)  # K1
    bp_equal(got, want, "16a edge-sharded BP against K1")
    reset()
    osdw, conv = bposd(synd_pad, llr0)
    on = launched()
    want_osd = osd_decode(graph, synd, want.llr, skip=want.converged, **osd_kw).osdw
    check(same(osdw, torch.where(want.converged[:, None], want.hard, want_osd)),
          "16a: sharded osdw != bp_decode + osd_decode")
    check(same(conv, want.converged), "16a: sharded converged != K1's")
    check(satisfies(osdw, H_f, synd), "16a: a sharded osdw violates its syndrome")
    check(on.get("osd_cs") and all(on["osd_cs"].get(d.index, 0) > 0 for d in mesh.devices)
          and "bp_flood" not in on, f"16a: K2 not launched on every card of the mesh: {on}")
    its = want.iterations

    def unsharded():
        bp = bp_decode(graph, synd, llr0, **kw)
        return osd_decode(graph, synd, bp.llr, skip=bp.converged, **osd_kw)

    def plain():
        bp = bp_decode_plain(graph, synd, llr0, method="minimum_sum", max_iter=n,
                             ms_scaling_factor=0.0)
        return osd_decode(graph, synd, bp[1], skip=bp[2], **osd_kw)

    bp_w = interleaved_walls({
        "K1": lambda: bp_decode(graph, synd, llr0, **kw),
        "plain": lambda: bp_decode_plain(graph, synd, llr0, method="minimum_sum", max_iter=n,
                                         ms_scaling_factor=0.0),
        "sharded": lambda: bp_sh.decode(synd_pad, llr0)})
    dec_w = interleaved_walls({"unsharded": unsharded, "plain": plain,
                               "sharded": lambda: bposd(synd_pad, llr0)})
    first, total = chain_bytes(2, 4, n, its)
    print(f"phase 16a edge_sharded_bposd_fn on a {mesh_name(mesh)} mesh, flagship [[400,16,6]] "
          f"at full width, {B} fresh syndromes (adaptive min-sum, max_iter {n}, osd_cs 42): "
          f"BP bit-identical to K1 (hard/llr/converged/iterations, {int((~conv).sum())} OSD "
          f"rows), osdw bit-identical to bp_decode + osd_decode, all satisfied; launches by "
          f"card {on}; medians of 3: decode sharded {dec_w['sharded'] * 1e3:.3f} ms "
          f"({B / dec_w['sharded']:.1f} syndromes/s), unsharded K1 + K2 "
          f"{dec_w['unsharded'] * 1e3:.3f} ms ({B / dec_w['unsharded']:.1f} syndromes/s), "
          f"unsharded plain torch BP + K2 {dec_w['plain'] * 1e3:.3f} ms "
          f"({B / dec_w['plain']:.1f} syndromes/s); BP alone sharded "
          f"{bp_w['sharded'] * 1e3:.3f} ms ({ms_per_it(bp_w['sharded'], its):.3f} ms per "
          f"iteration over {int(its.max())}), plain {bp_w['plain'] * 1e3:.3f} ms "
          f"({ms_per_it(bp_w['plain'], its):.3f}), K1 {bp_w['K1'] * 1e3:.3f} ms; chain "
          f"{first} bytes at iteration 1, {total / max(int(its.max()), 1):.1f} a iteration "
          f"on average ({total} in all; a hop within one card copies nothing) {tag}")

    # (b) the [[10000,420]] lifted product, full width, on a 1 x 2 mesh
    if qcode is None:
        qcode = lifted_hgp(PROTO, lift=LIFT)
    Hl = np.asarray(qcode.hx.toarray(), np.uint8)
    ml, nl = Hl.shape
    gl = TannerGraph(Hl, dev)
    lg = LiftedGraph(qcode.hx_proto, LIFT, dev)
    Hl_f = torch.as_tensor(Hl, dtype=torch.float32, device=dev)
    Bl = LIFT_B
    synd_l = syndromes(Hl_f, Bl, LIFT_HEAVY_P, SEED + 17)
    l0 = llr_from_channel(np.full(nl, LIFT_HEAVY_P)).to(dev).expand(Bl, nl).contiguous()
    kw_l = dict(bp_method="minimum_sum", max_iter=100, ms_scaling_factor=0.625)
    osd_l = dict(osd_method="osd_cs", osd_order=LIFT_ORDER)
    want_l = bp_decode_lifted(lg, synd_l, l0, **kw_l)
    want_k1 = bp_decode(gl, synd_l, l0, **kw_l)  # K1, its state in device memory
    want_l_osdw = torch.where(want_l.converged[:, None], want_l.hard, osd_decode(
        gl, synd_l, want_l.llr, skip=want_l.converged, **osd_l).osdw)
    want_k1_osdw = torch.where(want_k1.converged[:, None], want_k1.hard, osd_decode(
        gl, synd_l, want_k1.llr, skip=want_k1.converged, **osd_l).osdw)
    for w in (want_l_osdw, want_k1_osdw):
        check(satisfies(w, Hl_f, synd_l), "16b: an unsharded osdw violates its syndrome")

    def lifted_run(mesh, shards, what):
        """Both model-sharded decodes of (b) on ``mesh``: the BPs against the
        unsharded ones, osdw against the unsharded BP + OSD, K5 launched on
        every card of the mesh and K1/K2 never."""
        slg = ShardedLiftedGraph(lg, shards)
        sgl = ShardedTannerGraph(Hl, shards)
        pad_l = torch.cat([synd_l, synd_l.new_zeros(Bl, shards * slg.mp_chunk * LIFT - ml)], 1)
        pad_e = torch.cat([synd_l, synd_l.new_zeros(Bl, shards * sgl.m_chunk - ml)], 1)
        lbp = lifted_sharded_bp_fn(slg, mesh, **kw_l)
        ebp = edge_sharded_bp_fn(sgl, mesh, **kw_l)
        lbposd = lifted_sharded_bposd_fn(lg, Hl, mesh, n_shards=shards, **kw_l, **osd_l)
        ebposd = edge_sharded_bposd_fn(sgl, mesh, **kw_l, **osd_l)
        reset()
        bp_equal(lbp(pad_l, l0), want_l, f"{what} block-row-sharded BP against bp_decode_lifted")
        bp_equal(ebp.decode(pad_e, l0), want_k1, f"{what} edge-sharded BP against K1")
        check(bp_flood.launches == 0 and (shards == 1 or bp_lifted.launches == 0),
              f"{what}: a model-sharded BP launched K1 or K6")
        ons = {}
        for name, fn, pad, w in (("lifted", lbposd, pad_l, want_l_osdw),
                                 ("edge", ebposd, pad_e, want_k1_osdw)):
            reset()
            osdw, conv = fn(pad, l0)
            ons[name] = on = launched()
            check(same(osdw, w), f"{what} {name}-sharded osdw != the unsharded BP + OSD")
            check(on.get("osd_large") and all(on["osd_large"].get(d.index, 0) > 0
                                               for d in mesh.devices)
                  and "osd_cs" not in on and "bp_flood" not in on
                  and (shards == 1 or "bp_lifted" not in on),
                  f"{what} {name}: K5 not launched on every card, or K1/K2/K6 launched: {on}")
        check(torch.cuda.current_device() == 0, f"{what}: the current card changed")
        return lbp, ebp, lbposd, ebposd, pad_l, pad_e, ons

    mesh = pair_mesh()
    lbp, ebp, lbposd, ebposd, pad_l, pad_e, ons = lifted_run(mesh, 2, "16b")

    def unsharded_l():
        bp = bp_decode_lifted(lg, synd_l, l0, **kw_l)
        return osd_decode(gl, synd_l, bp.llr, skip=bp.converged, **osd_l)

    def unsharded_k1():
        bp = bp_decode(gl, synd_l, l0, **kw_l)
        return osd_decode(gl, synd_l, bp.llr, skip=bp.converged, **osd_l)

    bp_w = interleaved_walls({
        "lifted": lambda: bp_decode_lifted(lg, synd_l, l0, **kw_l),
        "lifted sharded": lambda: lbp(pad_l, l0),
        "K1": lambda: bp_decode(gl, synd_l, l0, **kw_l),
        "edge sharded": lambda: ebp.decode(pad_e, l0)})
    dec_w = interleaved_walls({
        "lifted": unsharded_l, "lifted sharded": lambda: lbposd(pad_l, l0),
        "K1": unsharded_k1, "edge sharded": lambda: ebposd(pad_e, l0)})
    lf, lt = chain_bytes(2, 1, nl, want_l.iterations)
    ef, et = chain_bytes(2, 4, nl, want_k1.iterations)
    n_it = int(want_l.iterations.max())
    print(f"phase 16b [[{nl},{qcode.K}]] lift {LIFT} at full width on a {mesh_name(mesh)} mesh, "
          f"B={Bl} at p={LIFT_HEAVY_P} (min-sum 0.625, max_iter 100, osd_cs {LIFT_ORDER}): "
          f"block-row-sharded BP bit-identical to bp_decode_lifted "
          f"({int((~want_l.converged).sum())} rows failed), edge-sharded BP bit-identical to "
          f"K1 ({int((~want_k1.converged).sum())} failed); both osdw bit-identical to the "
          f"unsharded BP + OSD, all satisfied; launches by card {ons}; medians of 3, decode "
          + ", ".join(f"{k} {v * 1e3:.3f} ms ({Bl / v:.1f} syndromes/s)"
                      for k, v in dec_w.items())
          + "; BP alone " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in bp_w.items())
          + f" (ms per iteration over {n_it}: lifted "
          f"{ms_per_it(bp_w['lifted'], want_l.iterations):.3f}, lifted sharded "
          f"{ms_per_it(bp_w['lifted sharded'], want_l.iterations):.3f}, edge sharded "
          f"{ms_per_it(bp_w['edge sharded'], want_k1.iterations):.3f}); chain bytes at "
          f"iteration 1 / a iteration on average: lifted {lf} / {lt / n_it:.1f}, edge {ef} / "
          f"{et / max(int(want_k1.iterations.max()), 1):.1f} (a hop within one card copies "
          f"nothing) {tag}")

    # (c) four cards: (b) on 2 x 2 and 1 x 4 meshes
    if cards < 4:
        print(f"phase 16c did not run: it needs four cards, this machine has {cards}")
        return model_parallel
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh_2d(*shape)
        _, _, lbposd, ebposd, pad_l, pad_e, ons = lifted_run(mesh, shape[1], "16c")
        w = interleaved_walls({"lifted sharded": lambda: lbposd(pad_l, l0),
                               "edge sharded": lambda: ebposd(pad_e, l0)})
        print(f"phase 16c {mesh_name(mesh)} mesh, cuda:0 current, (b)'s decodes: BPs and osdw "
              f"bit-identical to one card; launches by card {ons}; medians of 3 "
              + ", ".join(f"{k} {v * 1e3:.3f} ms ({Bl / v:.1f} syndromes/s)"
                          for k, v in w.items()) + f" {tag}")
    return model_parallel


def phase17(tag, qcode) -> None:
    """The functional API on graphs built with no ``device``: (a)
    ``decode_pipeline(TannerGraph(H), ...)`` on the corpus's numpy
    syndromes, through K1 and K2; (b) ``bp_decode_lifted(LiftedGraph(proto,
    400), ...)`` on one numpy lift-400 batch, through K6."""
    from bp_osd_tpu_torch.codes import hgp, mkmn_16_4_6
    from bp_osd_tpu_torch.decoder import TannerGraph, decode_pipeline
    from bp_osd_tpu_torch.decoder.bp import llr_from_channel
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted

    def walls(fn, reps=3):
        """The host walls of ``reps`` calls, each synchronised, and the last
        output."""
        out, ws = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ws.append(time.perf_counter() - t0)
        return out, ws

    def on_card(*xs):
        return all(x.device.type == "cuda" for x in xs)

    # (a) the main path's decode on a default graph, numpy in
    data = np.load(CORPUS)
    B, m, n, max_iter, osd_order, _ = (int(x) for x in data["meta"])
    H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
    graph = TannerGraph(H)
    check(graph.device.type == "cuda", f"TannerGraph(H) is on {graph.device}, not the card")
    synd = np.unpackbits(data["synd_packed"], axis=1)[:, :m]
    llr0 = llr_from_channel(np.full(n, 0.05)).numpy()
    kw = dict(bp_method="minimum_sum", ms_scaling_factor=0.0, max_iter=max_iter,
              osd_method="osd_cs", osd_order=osd_order)
    reset_launches()
    out, ws = walls(lambda: decode_pipeline(graph, synd, llr0, **kw))
    got = launch_counts()
    check(got["bp_flood"] > 0 and got["osd_cs"] > 0,
          f"decode_pipeline on a default graph did not launch K1 and K2: {got}")
    check(got["osd_e"] == got["eliminate"] == got["osd_large"] == 0,
          f"decode_pipeline at osd_cs launched another OSD kernel: {got}")
    check(on_card(*out), "decode_pipeline's outputs are not all on the card")
    corpus_check(out.osdw, out.converged, out.iterations, data, "decode_pipeline")

    # (b) the functional lifted BP on a default graph, numpy in
    hl = np.asarray(qcode.hx.toarray(), np.uint8)
    ml, nl = hl.shape
    t0 = time.perf_counter()
    lg = LiftedGraph(qcode.hx_proto, LIFT)
    build_s = time.perf_counter() - t0
    check(lg.device.type == "cuda", f"LiftedGraph(proto, {LIFT}) is on {lg.device}")
    lg_cuda = LiftedGraph(qcode.hx_proto, LIFT, device="cuda")
    rng = np.random.default_rng(SEED + 17)
    synd_l = ((rng.random((LIFT_B, nl)) < LIFT_P).astype(np.uint8) @ hl.T % 2).astype(np.uint8)
    l0 = llr_from_channel(np.full(nl, LIFT_P)).numpy()
    kw_l = dict(bp_method="minimum_sum", max_iter=100, ms_scaling_factor=0.625)
    reset_launches()
    res, ws_l = walls(lambda: bp_decode_lifted(lg, synd_l, l0, **kw_l))
    got_l = launch_counts()
    check(got_l["bp_lifted"] == 3 and not any(v for k, v in got_l.items() if k != "bp_lifted"),
          f"the functional lifted BP did not launch K6 alone, once a call: {got_l}")
    check(on_card(*res), "bp_decode_lifted's outputs are not all on the card")
    want = bp_decode_lifted(lg_cuda, synd_l, l0, **kw_l)
    for name, a, b in zip(res._fields, res, want):
        check(same(a, b), f"bp_decode_lifted on a default graph: {name} differs from "
                          "device='cuda'")
    check(same(res.llr.view(torch.int32), want.llr.view(torch.int32)),
          "bp_decode_lifted llr bits differ from device='cuda'")
    n_conv = int(res.converged.sum())
    check(0 < n_conv, "no lift-400 row converged")
    print(f"phase 17 default graphs on {graph.device}: (a) decode_pipeline(TannerGraph(H), "
          f"numpy syndromes) on the {B} corpus rows (adaptive min-sum, max_iter {max_iter}, "
          f"osd_cs {osd_order}): osdw/weights/converged/iterations == corpus, outputs on the "
          f"card, launches {got}, walls {[round(w * 1e3, 3) for w in ws]} ms (median "
          f"{np.median(ws) * 1e3:.3f}); (b) bp_decode_lifted(LiftedGraph(hx_proto, {LIFT}), "
          f"numpy syndromes) on {LIFT_B} rows at p={LIFT_P} (min-sum 0.625, max_iter 100; "
          f"graph built in {build_s:.2f} s): == device='cuda' bit for bit, {n_conv}/{LIFT_B} "
          f"converged, outputs on the card, launches {got_l} over the 3 calls, walls "
          f"{[round(w * 1e3, 3) for w in ws_l]} ms (median {np.median(ws_l) * 1e3:.3f}) {tag}")


def phase18(tag, qcode) -> None:
    """``bench_torch.py``'s modes in this process, each at its default
    options with 3 timed steps and every gate; the lifted modes reuse
    ``qcode``, the [[10000,420]] code."""
    import bench_torch

    t0 = time.perf_counter()
    for mode in bench_torch.MODES:
        t = time.perf_counter()
        kw = {"qcode": qcode} if mode in ("large", "lifted_shard") else {}
        line = bench_torch.run(mode, SEED, steps=3, **kw)
        print(f"phase 18 {mode} ({time.perf_counter() - t:.1f} s): {json.dumps(line)}")
    print(f"phase 18 bench_torch.py's {len(bench_torch.MODES)} modes, 3 steps each, in "
          f"{time.perf_counter() - t0:.1f} s {tag}")


def phase19(tag, graph, synd, fresh, H_f, consts) -> dict:
    """``decode_pipeline`` at each of :data:`STAGE_SCHEDULES`: (a) on the
    corpus rows ``synd``, bit for bit against the corpus, the default
    schedule and, launch by launch, K1's plain version, with K1 launched
    once a cap; (b) on the fresh rows, timed, K1 at each launch beside its
    bound.  Returns each schedule's caps, launches and times."""
    from bp_osd_tpu_torch.decoder import decode_pipeline
    from bp_osd_tpu_torch.decoder.bp import llr_from_channel
    from bp_osd_tpu_torch.decoder.pipeline import stage_caps
    from bp_osd_tpu_torch.ops.cuda_bp import bp_flood

    data = np.load(CORPUS)
    B, _, n, max_iter, osd_order, _ = (int(x) for x in data["meta"])
    llr0 = llr_from_channel(np.full(n, 0.05)).to(graph.device)
    kw = dict(bp_method="minimum_sum", ms_scaling_factor=0.0, max_iter=max_iter,
              osd_method="osd_cs", osd_order=osd_order, consts=consts)
    bp_kw = dict(method="minimum_sum", ms_scaling_factor=0.0)

    def bits(out):
        return out._replace(llr=out.llr.view(torch.int32))

    def equal(out, ref, what):
        for name, a, b in zip(out._fields, bits(out), bits(ref)):
            check(same(a, b), f"phase 19 {what}: {name} differs from the default schedule's")

    # (a) the corpus rows: bits, launches, each K1 launch against its plain version
    ref, report = None, []
    for sched in STAGE_SCHEDULES:
        what = f"stage1_iters={sched}"
        caps = stage_caps(max_iter, sched)
        reset_launches()
        out = decode_pipeline(graph, synd, llr0, stage1_iters=sched, **kw)
        got = launch_counts()
        check(got["bp_flood"] == len(caps) and got["osd_cs"] == 1,
              f"phase 19 {what}: caps {caps} but launches {got}")
        check(got["osd_e"] == got["eliminate"] == got["osd_large"] == 0,
              f"phase 19 {what}: another OSD kernel launched: {got}")
        corpus_check(out.osdw, out.converged, out.iterations, data, f"phase 19 {what}")
        ref = out if ref is None else ref
        equal(out, ref, what)
        stages = k1_stages(graph, synd, llr0.expand(B, n), max_iter, sched, **bp_kw)
        check([st.kw["max_iter"] for st in stages] == caps,
              f"phase 19 {what}: K1's stages ran to {[st.kw['max_iter'] for st in stages]}")
        k1_stages_equal_plain(stages, f"phase 19 {what}")
        for name, a, b in zip(("hard", "llr", "converged", "iterations"), k1_merged(stages),
                              (out.bp_hard, out.llr, out.converged, out.iterations)):
            check(same(a, b), f"phase 19 {what}: K1's staged {name} differs from the decode's")
        report.append(f"{sched}: caps {caps}, K1 x{got['bp_flood']} "
                      f"(rows {[st.args[1].shape[0] for st in stages]})")
    print(f"phase 19a stage schedules on the {B} corpus rows (adaptive min-sum, max_iter "
          f"{max_iter}, osd_cs {osd_order}): every schedule's osdw/osd0/bp_hard/converged/"
          f"iterations/llr == corpus and == the default schedule's bit for bit, each K1 launch "
          f"== bp_decode_plain on its rows and caps, K2 x1: " + "; ".join(report) + f" {tag}")

    # (b) the fresh rows: the decode's wall, K1 at each launch beside its bound
    F = fresh.shape[0]
    ref_f, rows = None, {}
    for sched in STAGE_SCHEDULES:
        what = f"stage1_iters={sched}"
        caps = stage_caps(max_iter, sched)

        def decode():
            return decode_pipeline(graph, fresh, llr0, stage1_iters=sched, **kw)

        wall = host_ms(decode, 5)
        reset_launches()
        out = decode()
        got = launch_counts()
        check(satisfies(out.osdw, H_f, fresh), f"phase 19 {what}: a fresh osdw violates its "
                                               "syndrome")
        ref_f = out if ref_f is None else ref_f
        equal(out, ref_f, f"{what}, fresh rows")
        stages = k1_stages(graph, fresh, llr0.expand(F, n), max_iter, sched, **bp_kw)
        check(got["bp_flood"] == len(stages),
              f"phase 19 {what}: {got['bp_flood']} K1 launches, {len(stages)} stages")
        stage_ms, stage_b = [], []
        for i, st in enumerate(stages):
            nrows = st.args[1].shape[0]
            stage_ms.append(cuda_ms(lambda: bp_flood(*st.args, **st.kw), 5))
            stage_b.append(k1_bound(graph, nrows, st.sample_its,
                                    prior_rows=1 if i == 0 else nrows, v2c_in=i > 0,
                                    emit=st.kw["emit_state"]))
        k1_ms = sum(stage_ms)
        rows[str(sched)] = {"caps": caps, "launches": got["bp_flood"],
                            "stage_rows": [st.args[1].shape[0] for st in stages],
                            "stage_ms": stage_ms, "stage_bound_ms": [b.ms for b in stage_b],
                            "k1_ms": k1_ms, "bound_ms": bound_sum(stage_b).ms,
                            "wall_ms": wall}
        print(f"phase 19b {what} on {F} fresh syndromes: caps {caps}, == the default "
              f"schedule's bit for bit, all satisfied; decode median of 5 {wall:.3f} ms, "
              f"{F / wall * 1e3:.1f} syndromes/s; K1 x"
              f"{got['bp_flood']}: " + ", ".join(
                  f"{r} rows {ms:.3f} ms (bound {b.ms:.4f})"
                  for r, ms, b in zip(rows[str(sched)]["stage_rows"], stage_ms, stage_b))
              + f" = {k1_ms:.3f} ms, {100 * k1_ms / wall:.1f}% of the wall, bound "
              f"{bound_sum(stage_b).ms:.4f} ms; launches {got} {tag}")
    return rows


def phase20(tag, H, fresh) -> None:
    """(a) Syndromes above 1 rejected at every public entry point on the
    card, before any kernel, with one check a call; the check's own time.
    (b) The port's ``generate_hgp_codes`` example's ``hx`` file, reloaded on
    the card, reproduces the corpus through ``decode_pipeline``."""
    from bp_osd_tpu_torch import BpDecoder, BpOsdDecoder
    from bp_osd_tpu_torch.codes import lifted_hgp, mkmn_16_4_6
    from bp_osd_tpu_torch.decoder import bp as bp_mod
    from bp_osd_tpu_torch.decoder import (LayeredTannerGraph, TannerGraph, bp_decode,
                                          bp_decode_layered, decode_pipeline, osd_decode)
    from bp_osd_tpu_torch.decoder.bp import llr_from_channel
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
    from bp_osd_tpu_torch.examples.generate_hgp_codes import generate
    from bp_osd_tpu_torch.parallel import (Mesh2D, ShardedTannerGraph, edge_sharded_bp_fn,
                                           make_mesh, sharded_decode_fn)

    # (a) every public entry point, uint8 card tensors holding 2 and 255
    dev = fresh.device
    m, n = H.shape
    graph = TannerGraph(H, dev)
    rows = fresh[:64]
    llr0 = llr_from_channel(np.full(n, 0.05)).to(dev)
    kw = dict(bp_method="minimum_sum", max_iter=400, ms_scaling_factor=0.0)
    osd_kw = dict(osd_method="osd_cs", osd_order=42)
    lq = lifted_hgp(PROTO, lift=8)
    lrows = torch.zeros(64, lq.hx.shape[0], dtype=torch.uint8, device=dev)
    l_llr0 = llr_from_channel(np.full(lq.hx.shape[1], 0.05)).to(dev)
    sg = ShardedTannerGraph(H, 2)

    def osdd(**extra):
        return BpOsdDecoder(H, error_rate=0.05, max_iter=0, bp_method="ms", ms_scaling_factor=0,
                            **osd_kw, **extra)

    def edge(s):
        pad = torch.zeros(s.shape[0], 2 * sg.m_chunk - m, dtype=s.dtype, device=dev)
        return edge_sharded_bp_fn(sg, Mesh2D((dev, dev), (1, 2)), **kw).decode(
            torch.cat([s, pad], 1), llr0)

    entries = {
        "bp_decode": (rows, lambda s: bp_decode(graph, s, llr0, **kw)),
        "decode_pipeline": (rows, lambda s: decode_pipeline(graph, s, llr0, **kw, **osd_kw)),
        "osd_decode": (rows, lambda s: osd_decode(graph, s, llr0.expand(64, n), **osd_kw)),
        "bp_decode_layered": (rows, lambda s: bp_decode_layered(
            LayeredTannerGraph(H, dev), s, llr0, **kw)),
        "bp_decode_lifted": (lrows, lambda s: bp_decode_lifted(
            LiftedGraph(lq.hx_proto, 8, dev), s, l_llr0, **kw)),
        "BpOsdDecoder.decode_batch": (rows, lambda s: osdd().decode_batch(s)),
        "BpOsdDecoder.decode": (rows[:1], lambda s: osdd().decode(s[0])),
        "BpOsdDecoder received_vector": (
            torch.zeros(64, n, dtype=torch.uint8, device=dev),
            lambda s: osdd(input_vector_type="received_vector").decode_batch(s)),
        "BpDecoder.decode": (rows[:1], lambda s: BpDecoder(
            H, error_rate=0.05, max_iter=0, bp_method="ms", ms_scaling_factor=0).decode(s[0])),
        "sharded_decode_fn": (rows, lambda s: sharded_decode_fn(
            graph, make_mesh(1), **kw, **osd_kw)(s, llr0.expand(64, n))),
        "edge_sharded_bp_fn": (rows, edge),
    }
    checks = []
    real = bp_mod._check_binary

    def counting(s, what):
        checks.append(what)
        return real(s, what)

    bp_mod._check_binary = counting
    try:
        reset_launches()
        rejected = 0
        for name, (good, call) in entries.items():
            for value in (2, 255):
                bad = good.clone()
                bad[0, 1] = value
                try:
                    call(bad)
                    error = None
                except ValueError as e:
                    error = str(e)
                check(error is not None and "0 or 1" in error,
                      f"phase 20 {name}: an entry {value} was not rejected ({error})")
                rejected += 1
        sync()
        got = launch_counts()
        check(not any(got.values()), f"phase 20 rejected calls launched kernels: {got}")
        check(len(checks) == rejected, f"phase 20: {len(checks)} checks for {rejected} calls")
        # one check a valid decode, over the default schedule's three K1 launches
        checks.clear()
        reset_launches()
        dec = osdd()
        dec.decode_batch(fresh, outputs="device")
        sync()
        got = launch_counts()
        check(len(checks) == 1 and got["bp_flood"] == 3 and got["osd_cs"] == 1,
              f"phase 20 one flagship decode: {len(checks)} checks, launches {got}")
    finally:
        bp_mod._check_binary = real
    one_check = host_ms(lambda: real(fresh, "syndromes"), 5)
    print(f"phase 20a uint8 card tensors with an entry 2 or 255: ValueError at all "
          f"{len(entries)} public entry points ({rejected} calls: {', '.join(entries)}), one "
          f"check a call, no kernel launched; one flagship decode_batch of {fresh.shape[0]}: "
          f"one check, K1 x3, K2 x1; the check alone on a {fresh.shape[0]} x {m} uint8 card "
          f"tensor ((s > 1).any() and its host read): {one_check:.4f} ms (host clock, median of "
          f"5) {tag}")

    # (b) the example's hx file, reloaded on the card, decodes the corpus
    data = np.load(CORPUS)
    B, m, n, max_iter, osd_order, _ = (int(x) for x in data["meta"])
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        qcode = generate(mkmn_16_4_6(), out_dir=out_dir)
        gen_s = time.perf_counter() - t0
        files = sorted(os.listdir(out_dir))
        hx = np.loadtxt(os.path.join(out_dir, f"hgp_{qcode.code_params}_hx.txt"), dtype=np.uint8)
    check(np.array_equal(hx, H), "the generated hx differs from hgp(mkmn_16_4_6()).hx")
    g = TannerGraph(hx, dev)
    synd = torch.as_tensor(np.unpackbits(data["synd_packed"], axis=1)[:, :m], device=dev)
    reset_launches()
    out = decode_pipeline(g, synd, llr_from_channel(np.full(n, 0.05)).to(dev),
                          bp_method="minimum_sum", ms_scaling_factor=0.0, max_iter=max_iter,
                          osd_method="osd_cs", osd_order=osd_order)
    got = launch_counts()
    check(got["bp_flood"] > 0 and got["osd_cs"] > 0,
          f"phase 20b decode_pipeline did not launch K1 and K2: {got}")
    corpus_check(out.osdw, out.converged, out.iterations, data, "phase 20b")
    print(f"phase 20b generate_hgp_codes.generate(mkmn_16_4_6()) in {gen_s:.2f} s: "
          f"{qcode.code_params}, files {files}; hx reloaded on {g.device} == "
          f"hgp(mkmn_16_4_6()).hx; decode_pipeline on the {B} corpus rows: osdw/weights/"
          f"converged/iterations == corpus, launches {got} {tag}")


def phase21(tag, qcode, fresh_l, heavy_l) -> dict:
    """K6 against its plain version ``_bp_rows`` on the card (see the module
    docstring), then its times beside its bound.  Returns the kernels line's
    numbers for K6."""
    from bp_osd_tpu_torch.codes import lifted_hgp
    from bp_osd_tpu_torch.decoder.bp import llr_from_channel
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, _bp_rows
    from bp_osd_tpu_torch.ops import _build
    import bp_osd_tpu_torch.ops.cuda_lifted_bp as k6
    from bp_osd_tpu_torch.utils.measure import k6_bound

    dev = torch.device("cuda")
    lib = _build.load()
    rules = (("minimum_sum", 0.625), ("minimum_sum", 0.0), ("product_sum", 1.0))

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def k6_run(g, synd, l0, method, msf, route, max_iter=100):
        k6._FORCE_DEVICE_ROUTE = route == "device"
        try:
            return k6.bp_lifted(g, synd, l0, method, max_iter, msf)
        finally:
            k6._FORCE_DEVICE_ROUTE = False

    def held(g, synd, l0, what, rules=rules, routes=("shared", "device")):
        """K6 on ``routes`` equal to ``_bp_rows`` under ``rules``, bit for
        bit; returns the plain outputs of the first rule and the largest
        llr difference (0.0)."""
        first, err = None, 0.0
        for method, msf in rules:
            want = _bp_rows(g, synd, l0, method, 100, msf)
            first = want if first is None else first
            for route in routes:
                got = k6_run(g, synd, l0, method, msf, route)
                sync()
                for name, a, b in zip(("hard", "llr", "converged", "iterations"), got, want):
                    check(same(bits(a), bits(b)), f"phase 21 {what}, {method} {msf}, {route} "
                                                  f"route: K6 {name} differs from _bp_rows")
                err = max(err, float((got[1] - want[1]).abs().max()))
        return first, err

    t0 = time.perf_counter()
    lg = LiftedGraph(qcode.hx_proto, LIFT, dev)
    nl = lg.n
    report, err = [], 0.0
    batches = {}
    for name, synd, p in (("p=0.005", fresh_l, LIFT_P), ("p=0.028", heavy_l, LIFT_HEAVY_P)):
        l0 = llr_from_channel(np.full(nl, p)).to(dev).expand(synd.shape[0], nl)
        want, e = held(lg, synd, l0, f"lift {LIFT} {name}")
        batches[name] = (synd, l0, want)
        err = max(err, e)
        report.append(f"lift {LIFT} {name}: {int(want[2].sum())}/{synd.shape[0]} converged, "
                      f"{int(want[3].sum())} row-iterations")
    # every row converges at iteration 1; no row converges
    zero = torch.zeros(LIFT_B, lg.m, dtype=torch.uint8, device=dev)
    l0 = batches["p=0.005"][1]
    want, _ = held(lg, zero, l0, "zero syndromes")
    check(bool(want[2].all()) and bool((want[3] == 1).all()),
          "phase 21: zero syndromes did not all converge at iteration 1")
    g_rand = torch.Generator(dev).manual_seed(SEED + 21)
    rand = (torch.rand(LIFT_B, lg.m, generator=g_rand, device=dev) < 0.5).to(torch.uint8)
    want, _ = held(lg, rand, l0, "uniform random syndromes")
    check(not bool(want[2].any()) and bool((want[3] == 100).all()),
          "phase 21: a uniform random syndrome converged")
    report.append(f"{LIFT_B} zero syndromes all converged at iteration 1; {LIFT_B} uniform "
                  f"random syndromes none, all 100 iterations")
    # lifts 60 and 100
    for lift in (60, 100):
        q = lifted_hgp(PROTO, lift=lift)
        H_f = torch.as_tensor(q.hx.toarray(), dtype=torch.float32, device=dev)
        rng = np.random.default_rng(SEED + lift)
        err_m = torch.as_tensor((rng.random((LIFT_B, H_f.shape[1])) < 0.03).astype(np.float32),
                                device=dev)
        synd = torch.remainder(err_m @ H_f.T, 2).to(torch.uint8)
        g = LiftedGraph(q.hx_proto, lift, dev)
        l0 = llr_from_channel(np.full(g.n, 0.03)).to(dev).expand(LIFT_B, g.n)
        want, _ = held(g, synd, l0, f"lift {lift}")
        report.append(f"lift {lift} ({k6.k6_route(g)} route by size): "
                      f"{int(want[2].sum())}/{LIFT_B} converged")

    def edges_lifted(lift):
        """64 rows of the lift-400 protograph's edges lifted to ``lift``,
        syndromes of errors at p = 0.01 routed through ``chk_var``."""
        g = LiftedGraph(qcode.hx_proto, lift, dev)
        rng = np.random.default_rng(SEED + lift)
        e = torch.as_tensor((rng.random((64, g.n)) < 0.01).astype(np.uint8), device=dev)
        pad = torch.cat([e, e.new_zeros(64, 1)], 1)
        synd = (pad[:, g.chk_var].view(64, g.m, g.wr).sum(-1) & 1).to(torch.uint8)
        return g, synd, llr_from_channel(np.full(g.n, 0.01)).to(dev).expand(64, g.n)

    # the min-sum shared route's boundary (lift 942 | 943), and lift 1000
    graphs = {}
    for lift, route, rl in ((942, "shared", rules[:2]), (943, "device", rules[:2]),
                            (1000, "device", rules[:1])):
        g, synd, l0 = graphs[lift] = edges_lifted(lift)
        check(k6.k6_route(g) == route, f"lift {lift} takes the {k6.k6_route(g)} route")
        want, _ = held(g, synd, l0, f"lift {lift}", rules=rl,
                       routes=("shared", "device") if route == "shared" else ("device",))
        report.append(f"lift {lift} ({route} route by size, {len(rl)} min-sum rules): "
                      f"{int(want[2].sum())}/64 converged")
    mirror = all(k6.bp_lifted_smem_bytes(lg.mp, lg.np_, L, lg.wr, lg.depth, ps, route)
                 == lib.bp_lifted_smem_bytes(lg.mp, lg.np_, L, lg.wr, lg.depth, int(ps),
                                             int(route))
                 for L in (60, 100, 400, 527, 528, 942, 943, 1000) for ps in (False, True)
                 for route in (False, True))
    check(mirror, "K6's shared-memory mirror differs from the library")

    # every team size of the plan's sweep, bit for bit on the heavy batch
    synd_h, l0_h, _ = batches["p=0.028"]
    sweep = {}
    for T in k6.TEAM_SIZES:
        k6._THREADS = T
        try:
            sweep[T] = {"plan": k6.bp_lifted_plan(lg)}
            held(lg, synd_h, l0_h, f"lift {LIFT} p=0.028 at {T} threads a row",
                 routes=("shared",))
        finally:
            k6._THREADS = 0
    check_s = time.perf_counter() - t0

    # times at the main path's shapes: K6, its device-memory route, the plain loop
    times = {}
    for name, (synd, l0, want) in batches.items():
        times[name] = {
            "ms": cuda_ms(lambda: k6_run(lg, synd, l0, "minimum_sum", 0.625, "shared"), 5),
            "device_route_ms": cuda_ms(
                lambda: k6_run(lg, synd, l0, "minimum_sum", 0.625, "device"), 5),
            "plain_ms": cuda_ms(lambda: _bp_rows(lg, synd, l0, "minimum_sum", 100, 0.625), 3),
            "bound": k6_bound(lg, want[3], prior_rows=1, device_route=False),
            "max_iterations": int(want[3].max())}
    plan = k6.bp_lifted_plan(lg)
    plan_dev = k6.bp_lifted_plan(graphs[1000][0])
    # the plan's team size against the others: the heavy batch, and one row
    # of a uniform random syndrome (all 100 iterations), ms an iteration
    lone, l0_lone = rand[:1], batches["p=0.028"][1][:1]
    for T in k6.TEAM_SIZES:
        k6._THREADS = T
        try:
            sweep[T]["heavy_ms"] = cuda_ms(
                lambda: k6_run(lg, synd_h, l0_h, "minimum_sum", 0.625, "shared"), 5)
            sweep[T]["lone_row_ms_per_iteration"] = cuda_ms(
                lambda: k6_run(lg, lone, l0_lone, "minimum_sum", 0.625, "shared"), 5) / 100
        finally:
            k6._THREADS = 0
    lone_ms_it = sweep[plan["threads"]]["lone_row_ms_per_iteration"]
    heavy = times["p=0.028"]
    print(f"phase 21 K6 vs _bp_rows on the card (min-sum 0.625, adaptive, product-sum; max_iter "
          f"100; shared and device-memory routes): hard/llr bits/converged/iterations "
          f"bit-identical on " + "; ".join(report) + f"; shared-memory mirror == library "
          f"({check_s:.1f} s), every team size of the sweep included; plan "
          f"{plan_line(plan)}; lift 1000 {plan_line(plan_dev)}; team sweep (threads a row: "
          f"rows an SM, registers, local bytes; heavy-batch ms; lone-row ms an iteration): "
          + "; ".join(f"{T}: {e['plan']['rows_per_sm']}, {e['plan']['registers']}, "
                      f"{e['plan']['local_bytes']}; {e['heavy_ms']:.3f}; "
                      f"{e['lone_row_ms_per_iteration']:.4f}" for T, e in sweep.items())
          + "; "
          + "; ".join(f"{LIFT_B} rows {name}: K6 {t['ms']:.3f} ms (device-memory route "
                      f"{t['device_route_ms']:.3f}), plain {t['plain_ms']:.3f} ms, bound "
                      f"{t['bound'].detail()}, {100 * t['bound'].ms / t['ms']:.2f}% of it, rows "
                      f"to {t['max_iterations']} iterations" for name, t in times.items())
          + f" {tag}")
    return {"err": err, "ms": heavy["ms"], "plain_ms": heavy["plain_ms"],
            "bound": heavy["bound"], "p0005_ms": times["p=0.005"]["ms"],
            "p0005_plain_ms": times["p=0.005"]["plain_ms"],
            "p0005_bound_ms": times["p=0.005"]["bound"].ms,
            "device_route_ms": heavy["device_route_ms"], "plan": plan,
            "lone_row_ms_per_iteration": lone_ms_it,
            "sweep": {str(T): {"threads": T, "rows_per_sm": e["plan"]["rows_per_sm"],
                               "registers": e["plan"]["registers"],
                               "heavy_ms": e["heavy_ms"],
                               "lone_row_ms_per_iteration": e["lone_row_ms_per_iteration"]}
                      for T, e in sweep.items()}}


def phase22(tag) -> dict:
    """K1 on the gross code's space-time matrix and at launches that
    under-fill the card (see the module docstring).  Returns the kernels
    line's numbers for K1's latency plan."""
    from bp_osd_tpu_torch import BpOsdDecoder
    from bp_osd_tpu_torch.codes import gross_code, hgp, mkmn_16_4_6, phenomenological
    from bp_osd_tpu_torch.decoder.bp import bp_decode_plain, llr_from_channel
    from bp_osd_tpu_torch.decoder.tanner import TannerGraph
    from bp_osd_tpu_torch.ops.cuda_bp import bp_flood, bp_flood_plan
    from bp_osd_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(SEED + 22)

    def problem(H, p, rows):
        """The graph, ``rows`` syndromes of errors at rate ``p`` on every
        column, and the channel prior broadcast over them."""
        graph = TannerGraph(H, dev)
        H_f = torch.as_tensor(H, dtype=torch.float32, device=dev)
        e = torch.as_tensor((rng.random((rows, graph.n)) < p).astype(np.float32), device=dev)
        synd = torch.remainder(e @ H_f.T, 2).to(torch.uint8)
        return graph, synd, llr_from_channel(np.full(graph.n, p)).to(dev).expand(rows, graph.n)

    def timed(graph, args, kw, warps=0, ms=None):
        """One launch held to the plain version (all five outputs), timed
        (CUDA events, median of 3, unless ``ms`` is given), beside its bound
        and its plan."""
        out = _with_team(warps, lambda: bp_flood(*args, **kw))
        k1_equal(out, bp_decode_plain(*args, **kw),
                 f"phase 22 {args[1].shape[0]} rows, iterations {kw['it0'] + 1}-"
                 f"{kw['max_iter']}, teams {warps or 'of the plan'}")
        rows, its = args[1].shape[0], kw["max_iter"] - kw["it0"]
        if ms is None:
            ms = _with_team(warps, lambda: cuda_ms(lambda: bp_flood(*args, **kw), 3))
        b = k1_bound(graph, rows, int((out[3] - kw["it0"]).sum()),
                     prior_rows=1 if args[2].stride(0) == 0 else rows,
                     v2c_in=kw["v2c_init"] is not None, emit=kw["emit_state"])
        plan = _with_team(warps, lambda: bp_flood_plan(graph, rows))
        return {"rows": rows, "it0": kw["it0"], "max_iter": kw["max_iter"], "ms": ms,
                "us_per_iteration": 1000 * ms / its, "bound_ms": b.ms, "bound_by": b.by,
                "plan": "latency" if plan["latency"] else "throughput",
                "threads": plan["team_threads"], "rows_per_block": plan["teams_per_block"],
                "grid": plan["grid"], "registers": plan["registers"]}

    def text(r):
        return (f"{r['rows']} rows {r['plan']} ({r['threads']} threads x {r['rows_per_block']} "
                f"rows a block, grid {r['grid']}, {r['registers']} registers): {r['ms']:.3f} ms, "
                f"{r['us_per_iteration']:.3f} us an iteration, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")

    # (a) one decode of the gross144 cell's shape through the main path
    H_st = phenomenological(gross_code().hx, GROSS_ROUNDS).H.toarray().astype(np.uint8)
    graph, synd, l0 = problem(H_st, GROSS_P, GROSS_B)
    bp_kw = dict(method="minimum_sum", ms_scaling_factor=0.0)
    dec = BpOsdDecoder(H_st, error_rate=GROSS_P, max_iter=GROSS_ITERS, bp_method="ms",
                       ms_scaling_factor=0, osd_method="osd_cs", osd_order=7)
    dec.decode_batch(synd, outputs="device")  # warm-up: the kernels' first use
    reset_launches()
    profiling.collect()
    profiling.enable()
    try:
        out = dec.decode_batch(synd, outputs="device")
    finally:
        profiling.disable()
    counters = profiling.collect().counters
    got = {k: v for k, v in launch_counts().items() if v}
    stages = k1_stages(graph, synd, l0, GROSS_ITERS, **bp_kw)
    stage_rows = [counters.get(f"bp.stage_rows.{i + 1}", 0) for i in range(len(stages))]
    check(stage_rows == [st.args[1].shape[0] for st in stages],
          f"phase 22 the decode's stage rows {stage_rows} differ from K1's stages")
    check(got.get("bp_flood") == len(stages) == 3, f"phase 22 one decode's launches {got}")
    check(same(stages[-1].rows[~stages[-1].out[2]], torch.nonzero(~dec.converge_batch).flatten()),
          "phase 22 the staged rows differ from the decoder's failures")
    latency_rows = sum(r for r in stage_rows if bp_flood_plan(graph, r)["latency"])
    check(counters.get("bp_flood.latency_rows", 0) == latency_rows > 0,
          f"phase 22 bp_flood.latency_rows {counters.get('bp_flood.latency_rows')} != "
          f"{latency_rows}, the rows of the stages on the latency plan")
    H_f = torch.as_tensor(H_st, dtype=torch.float32, device=dev)
    check(satisfies(out, H_f, synd), "phase 22 a gross osdw violates its syndrome")
    gross = [timed(graph, st.args, st.kw) for st in stages]
    print(f"phase 22a gross code [[144,12,12]] over {GROSS_ROUNDS} rounds ({graph.m} x {graph.n}), "
          f"{GROSS_B} syndromes at p = {GROSS_P}, adaptive min-sum to {GROSS_ITERS}: one decode's "
          f"launches {got}, bp_flood.latency_rows {latency_rows}; K1 at its stages, five outputs "
          f"bit-identical to bp_decode_plain: "
          + "; ".join(f"stage {i + 1} " + text(r) for i, r in enumerate(gross)) + f" {tag}")

    # (b) 1, SMs + 9 and 2 SMs - 1 rows resumed, on the plan and with the
    # throughput team forced: the gross matrix's stage 2 (iterations
    # 625-2496) of twice the rows, and the flagship's stage 3 (97-400)
    H_fl = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
    cases = []
    for name, (g, s, l), caps in (("gross144", problem(H_st, GROSS_P, 2 * GROSS_B), GROSS_ITERS),
                                   ("flagship", problem(H_fl, 0.05, FRESH), 400)):
        st = k1_stages(g, s, l, caps, **bp_kw)[1 if name == "gross144" else 2]
        warps = bp_flood_plan(g, 1 << 20)["team_threads"] // 32  # the throughput team
        for rows in (1, sms + 9, 2 * sms - 1):
            check(st.args[1].shape[0] >= rows, f"phase 22 {name}: {st.args[1].shape[0]} rows "
                  f"resumed, fewer than {rows}")
            args = (g, st.args[1][:rows], st.args[2][:rows])
            kw = dict(st.kw, v2c_init=st.kw["v2c_init"][:rows])
            # in turns, the order swapped each round: of two timings back to
            # back the first read up to 15% slower, the plan alike
            ms = {0: [], warps: []}
            for r in range(PAIR_ROUNDS):
                for w in ((0, warps) if r % 2 == 0 else (warps, 0)):
                    ms[w].append(_with_team(w, lambda: cuda_ms(lambda: bp_flood(*args, **kw),
                                                               3)))
            cases.append({"graph": name,
                          "default": timed(g, args, kw, ms=float(np.median(ms[0]))),
                          "throughput": timed(g, args, kw, warps, float(np.median(ms[warps])))})
    print("phase 22b K1 resumed, five outputs bit-identical to bp_decode_plain, the plan's "
          f"choice against the throughput team forced, in turns ({PAIR_ROUNDS} rounds): "
          + "; ".join(f"{c['graph']} {text(c['default'])} | forced {text(c['throughput'])}"
                      for c in cases) + f" {tag}")
    return {"gross144_stages": gross, "gross144_launches": got["bp_flood"],
            "gross144_latency_rows": latency_rows, "under_filled": cases}


def phase23(tag) -> dict:
    """K5 where its launches under-fill the card: the cluster plan (see the
    module docstring).  Returns the kernels line's numbers for it."""
    from bp_osd_tpu_torch.codes import gross_code, lifted_hgp, phenomenological
    from bp_osd_tpu_torch.decoder.bp import llr_from_channel
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
    from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode_plain
    from bp_osd_tpu_torch.decoder.tanner import TannerGraph
    from bp_osd_tpu_torch.ops.cuda_osd_large import (_osd_large, osd_large, osd_large_cluster,
                                                     osd_large_clusters)
    from bp_osd_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)

    def k5(graph, perm, synd, pairs, cluster=None):
        return _osd_large(graph, perm, synd, LIFT_ORDER, pairs, None, cluster)

    def held(graph, perm, synd, pairs, want, clusters, what):
        """K5 in each plan of ``clusters`` (None: the rule's) equal to ``want``."""
        for c in clusters:
            got = k5(graph, perm, synd, pairs, c)
            check(same(got[0], want[0]) and same(got[1], want[1]),
                  f"phase 23 {what}: K5 with {c or 'the rule'}'s clusters differs from "
                  f"osd_decode_plain")

    def in_turns(fns: dict) -> dict:
        """Each ``fn`` timed PAIR_ROUNDS times (median of 3), in turns, the
        order reversed each round; the medians."""
        ms = {k: [] for k in fns}
        for r in range(PAIR_ROUNDS):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                ms[k].append(cuda_ms(fns[k], 3))
        return {k: float(np.median(v)) for k, v in ms.items()}

    def bands(graph, perm, synd, pairs, order, what) -> dict:
        """Launches of 16 to 66 rows, the rule's middle bands: every plan
        with C x rows <= SMs, in turns, each equal to a block a sample;
        rows -> {blocks a sample: ms}, the rule's plan under "rule"."""
        out = {}
        for rows in BAND_ROWS:
            args = (graph, perm[:rows], synd[:rows], order, pairs, None)
            rule = osd_large_cluster(rows, sms, lambda c: osd_large_clusters(graph, order, c)
                                     ["clusters"])
            plans = [1] + [c for c in (2, 4, 8) if rows * c <= sms]
            one = _osd_large(*args, 1)
            for c in plans[1:]:
                got = _osd_large(*args, c)
                check(same(got[0], one[0]) and same(got[1], one[1]),
                      f"phase 23 {what}, {rows} rows: {c} blocks a sample differ from one")
            ms = in_turns({c: (lambda c=c: _osd_large(*args, c)) for c in plans})
            out[rows] = {"rule": rule, **ms}
        return out

    def band_text(b: dict) -> str:
        return "; ".join(f"{rows} rows (rule {v['rule']}) "
                         + ", ".join(f"{c}: {ms:.3f}" for c, ms in v.items() if c != "rule")
                         for rows, v in b.items())

    # (a) the lifted product [[10000,420]] at lift 400: rows that failed BP
    qcode = lifted_hgp(PROTO, lift=LIFT)
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    graph, lgraph = TannerGraph(H, dev), LiftedGraph(qcode.hx_proto, LIFT, dev)
    H_f = torch.as_tensor(H, dtype=torch.float32, device=dev)
    pairs = build_osd_consts(graph, "osd_cs", LIFT_ORDER).pairs
    sizes = {c: osd_large_clusters(graph, LIFT_ORDER, c) for c in (2, 4, 8)}
    resident = {c: v["clusters"] for c, v in sizes.items()}

    def failing(p, rows):
        """``rows`` syndromes of errors at rate ``p`` that lifted BP (min-sum
        0.625, 100 iterations) leaves, with their reliability order."""
        l0 = llr_from_channel(np.full(graph.n, p)).to(dev)
        synd, llr = [], []
        for _ in range(64):
            err = (torch.rand((4096, graph.n), generator=gen, device=dev) < p).float()
            s = torch.remainder(err @ H_f.T, 2).to(torch.uint8)
            bp = bp_decode_lifted(lgraph, s, l0, bp_method="ms", max_iter=100,
                                  ms_scaling_factor=0.625)
            fail = torch.nonzero(~bp.converged).flatten()
            synd.append(s[fail])
            llr.append(bp.llr[fail])
            if sum(x.shape[0] for x in synd) >= rows:
                break
        synd, llr = torch.cat(synd)[:rows], torch.cat(llr)[:rows]
        check(synd.shape[0] == rows, f"phase 23: fewer than {rows} rows failed BP at p = {p}")
        return synd, torch.argsort(llr, dim=1, stable=True).to(torch.int32)

    lines, timed, middle = [], {}, {}
    for p in (LIFT_P, LIFT_HEAVY_P):
        synd, perm = failing(p, max(BAND_ROWS))
        want = osd_decode_plain(graph, perm[:16], synd[:16], method="osd_cs",
                                osd_order=LIFT_ORDER, pairs=pairs)
        check(satisfies(want[1], H_f, synd[:16]), f"phase 23 p = {p}: a plain osdw violates its "
              "syndrome")
        for rows in (1, 2, 8, 16):
            held(graph, perm[:rows], synd[:rows], pairs, (want[0][:rows], want[1][:rows]),
                 (None, 1, 2, 4, 8),
                 f"lift {LIFT}, p = {p}, {rows} rows")
        for rows in (1, 8):
            rule = osd_large_cluster(rows, sms, resident.get)
            ms = in_turns({c: (lambda c=c: k5(graph, perm[:rows], synd[:rows], pairs, c))
                           for c in (rule, 1)})
            timed[(p, rows)] = {"cluster": rule, "ms": ms[rule], "one_block_ms": ms[1]}
        sweep = in_turns({c: (lambda c=c: k5(graph, perm[:1], synd[:1], pairs, c))
                          for c in (1, 2, 4, 8)})
        middle[str(p)] = bands(graph, perm, synd, pairs, LIFT_ORDER, f"lift {LIFT}, p = {p}")
        lines.append(f"p = {p}: 16 BP-failing rows, K5 bit-identical to osd_decode_plain at 1, "
                     f"2, 8 and 16 rows in the rule's plan and with 1, 2, 4, 8 blocks a "
                     f"sample; in turns ({PAIR_ROUNDS} rounds of a median of 3) 1 row "
                     f"{timed[(p, 1)]['ms']:.3f} ms ({timed[(p, 1)]['cluster']} blocks) vs "
                     f"{timed[(p, 1)]['one_block_ms']:.3f} (a block), 8 rows "
                     f"{timed[(p, 8)]['ms']:.3f} ms ({timed[(p, 8)]['cluster']}) vs "
                     f"{timed[(p, 8)]['one_block_ms']:.3f}; a lone row by blocks a sample "
                     + ", ".join(f"{c}: {v:.3f}" for c, v in sweep.items()) + " ms; by blocks "
                     "a sample (ms) " + band_text(middle[str(p)]))

    # the heavy point: a batch's ~129 failing rows at p = 0.028, in the
    # rule's plan (a block a sample) and with clusters of 2 (two waves)
    heavy_s, heavy_p = failing(LIFT_HEAVY_P, 129)
    rule = osd_large_cluster(129, sms, resident.get)
    check(rule == 1, f"phase 23: the rule gave {rule} blocks a sample to 129 rows")
    one = k5(graph, heavy_p, heavy_s, pairs, 1)
    held(graph, heavy_p, heavy_s, pairs, one, (None, 2), "129 rows against a block a sample")
    heavy = in_turns({c: (lambda c=c: k5(graph, heavy_p, heavy_s, pairs, c)) for c in (1, 2)})

    # the counters: a launch's rows, and those of the cluster plan
    profiling.collect()
    profiling.enable()
    try:
        osd_large(graph, heavy_p[:16], heavy_s[:16], osd_order=LIFT_ORDER, pairs=pairs)
        osd_large(graph, heavy_p, heavy_s, osd_order=LIFT_ORDER, pairs=pairs)
    finally:
        profiling.disable()
    counters = profiling.collect().counters
    check(counters.get("osd_large.rows") == 16 + 129
          and counters.get("osd_large.cluster_rows") == 16,
          f"phase 23 counters {counters.get('osd_large.rows')} rows, "
          f"{counters.get('osd_large.cluster_rows')} cluster rows; want 145 and 16")

    # (b) the rule against cudaOccupancyMaxActiveClusters
    rules = {}
    for B in (1, 2, 8, 16, 17, 32, 33, 44, 66, 67, 129, 132):
        got = osd_large_cluster(B, sms, resident.get)
        fits = [c for c in (8, 4, 2) if B * c <= sms and resident[c] >= B]
        check(got == (fits[0] if fits else 1), f"phase 23 the rule at {B} rows: {got}")
        rules[B] = got

    # (c) the gross code's space-time matrix, rows forced into each plan
    H_st = phenomenological(gross_code().hx, GROSS_ROUNDS).H.toarray().astype(np.uint8)
    g_st = TannerGraph(H_st, dev)
    pairs_st = build_osd_consts(g_st, "osd_cs", 7).pairs
    n_st = max(BAND_ROWS)
    err = (torch.rand((n_st, g_st.n), generator=gen, device=dev) < GROSS_P).float()
    s_st = torch.remainder(err @ torch.as_tensor(H_st, dtype=torch.float32, device=dev).T,
                           2).to(torch.uint8)
    p_st = torch.argsort(torch.randn((n_st, g_st.n), generator=gen, device=dev), dim=1,
                         stable=True).to(torch.int32)
    want = osd_decode_plain(g_st, p_st[:8], s_st[:8], method="osd_cs", osd_order=7,
                            pairs=pairs_st)
    for c in (None, 1, 2, 4, 8):
        got = _osd_large(g_st, p_st[:8], s_st[:8], 7, pairs_st, None, c)
        check(same(got[0], want[0]) and same(got[1], want[1]),
              f"phase 23 gross144: K5 with {c or 'the rule'}'s clusters differs from "
              "osd_decode_plain")
    gross = in_turns({c: (lambda c=c: _osd_large(g_st, p_st[:1], s_st[:1], 7, pairs_st, None,
                                                  c)) for c in (1, 2, 4, 8)})
    gross_bands = bands(g_st, p_st, s_st, pairs_st, 7, "gross144")
    print(f"phase 23 K5's cluster plan, lift {LIFT} ({graph.m} x {graph.n}, rank "
          f"{graph.rank}, osd_cs {LIFT_ORDER}; {sms} SMs; clusters resident at once "
          + ", ".join(f"{c} blocks: {v['clusters']} ({v['registers']} registers)"
                      for c, v in sizes.items()) + "): " + "; ".join(lines)
          + f"; 129 rows at p = {LIFT_HEAVY_P}: a block a sample {heavy[1]:.3f} ms, clusters "
          f"of 2 {heavy[2]:.3f} ms (equal bits); counters osd_large.rows 145, cluster_rows 16; "
          f"the rule by rows " + ", ".join(f"{B}: {c}" for B, c in rules.items())
          + f"; gross144 ({g_st.m} x {g_st.n}) 8 rows bit-identical in every plan, a lone row "
          + ", ".join(f"{c} blocks {v:.3f}" for c, v in gross.items()) + " ms; by blocks a "
          f"sample (ms) {band_text(gross_bands)} {tag}")
    return {"sms": sms, "resident_clusters": resident,
            "lone_row": {str(p): timed[(p, 1)] for p in (LIFT_P, LIFT_HEAVY_P)},
            "rows8": {str(p): timed[(p, 8)] for p in (LIFT_P, LIFT_HEAVY_P)},
            "heavy_129": {"one_block_ms": heavy[1], "cluster2_ms": heavy[2]},
            "rule": rules, "gross144_lone_row": gross,
            "bands": {"lift400": middle, "gross144": gross_bands}}


def phase24(tag) -> dict:
    """K1's wide plan on the two-gross code's space-time matrix (see the
    module docstring).  Returns the kernels line's numbers for it."""
    from bp_osd_tpu_torch import BpOsdDecoder
    from bp_osd_tpu_torch.codes import phenomenological, two_gross_code
    from bp_osd_tpu_torch.decoder.bp import bp_decode_plain, llr_from_channel
    from bp_osd_tpu_torch.decoder.tanner import TannerGraph
    from bp_osd_tpu_torch.ops.cuda_bp import bp_flood, bp_flood_plan, wide_grid, wide_plan
    from bp_osd_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(SEED + 24)
    H = phenomenological(two_gross_code().hx, TWO_GROSS_ROUNDS).H.toarray().astype(np.uint8)
    graph = TannerGraph(H, dev)
    H_f = torch.as_tensor(H, dtype=torch.float32, device=dev)
    e = torch.as_tensor((rng.random((TWO_GROSS_B, graph.n)) < TWO_GROSS_P).astype(np.float32),
                        device=dev)
    synd = torch.remainder(e @ H_f.T, 2).to(torch.uint8)
    l0 = llr_from_channel(np.full(graph.n, TWO_GROSS_P)).to(dev).expand(TWO_GROSS_B, graph.n)
    bp_kw = dict(method="minimum_sum", ms_scaling_factor=0.0)

    dec = BpOsdDecoder(H, error_rate=TWO_GROSS_P, max_iter=GROSS_ITERS, bp_method="ms",
                       ms_scaling_factor=0, osd_method="osd_cs", osd_order=7)
    dec.decode_batch(synd, outputs="device")  # warm-up: the kernels' first use
    reset_launches()
    profiling.collect()
    profiling.enable()
    try:
        out = dec.decode_batch(synd, outputs="device")
    finally:
        profiling.disable()
    counters = profiling.collect().counters
    got = {k: v for k, v in launch_counts().items() if v}
    stages = k1_stages(graph, synd, l0, GROSS_ITERS, **bp_kw)
    stage_rows = [counters.get(f"bp.stage_rows.{i + 1}", 0) for i in range(len(stages))]
    check(stage_rows == [st.args[1].shape[0] for st in stages],
          f"phase 24 the decode's stage rows {stage_rows} differ from K1's stages")
    check(got.get("bp_flood") == len(stages) == 3, f"phase 24 one decode's launches {got}")
    wide = [wide_plan(graph, r) for r in stage_rows]
    check(all(wide), f"phase 24 the stages' plans {wide}: every stage in the wide plan")
    row_iters = [counters.get(f"bp.row_iters.{i + 1}", 0) for i in range(len(stages))]
    check(row_iters == [st.sample_its for st in stages],
          f"phase 24 bp.row_iters {row_iters} differ from K1's stages")
    wide_rows, wide_iters = sum(stage_rows), sum(row_iters)
    check(counters.get("bp_flood.wide_rows", 0) == wide_rows > 0,
          f"phase 24 bp_flood.wide_rows {counters.get('bp_flood.wide_rows')} != {wide_rows}, "
          "every staged row")
    check(counters.get("bp_flood.wide_row_iters", 0) == wide_iters,
          f"phase 24 bp_flood.wide_row_iters {counters.get('bp_flood.wide_row_iters')} != "
          f"{wide_iters}, the iterations of every stage")
    check(satisfies(out, H_f, synd), "phase 24 a two-gross osdw violates its syndrome")

    results = []
    for i, st in enumerate(stages):
        k1_equal(bp_flood(*st.args, **st.kw), bp_decode_plain(*st.args, **st.kw),
                 f"phase 24 stage {i + 1} ({st.args[1].shape[0]} rows)")
        ms = {0: [], 1: []}  # the wide plan, the device-memory placement forced
        for r in range(WIDE_ROUNDS):
            for warps in (0, 1) if r % 2 == 0 else (1, 0):
                ms[warps].append(_with_team(warps, lambda: cuda_ms(
                    lambda: bp_flood(*st.args, **st.kw), 1)))
        rows, its = st.args[1].shape[0], st.kw["max_iter"] - st.kw["it0"]
        b = k1_bound(graph, rows, st.sample_its,
                     prior_rows=1 if st.args[2].stride(0) == 0 else rows,
                     v2c_in=st.kw["v2c_init"] is not None, emit=st.kw["emit_state"])
        plan = bp_flood_plan(graph, rows)
        check(plan["grid"] == wide_grid(rows, sms),
              f"phase 24 stage {i + 1} grid {plan['grid']} != wide_grid {wide_grid(rows, sms)}")
        wide_ms, dm_ms = float(np.median(ms[0])), float(np.median(ms[1]))
        results.append({
            "stage": i + 1, "rows": rows, "it0": st.kw["it0"], "max_iter": st.kw["max_iter"],
            "ms": wide_ms, "us_per_iteration": 1000 * wide_ms / its, "bound_ms": b.ms,
            "bound_by": b.by, "row_iters": st.sample_its,
            "ns_per_row_iteration": 1e6 * wide_ms / st.sample_its, "device_memory_ms": dm_ms,
            "device_memory_ns_per_row_iteration": 1e6 * dm_ms / st.sample_its,
            "threads": plan["team_threads"], "grid": plan["grid"],
            "registers": plan["registers"], "smem_bytes": plan["smem_bytes"]})
    print(f"phase 24 two-gross code [[288,12,18]] over {TWO_GROSS_ROUNDS} rounds ({graph.m} x "
          f"{graph.n}), {TWO_GROSS_B} syndromes at p = {TWO_GROSS_P}, adaptive min-sum to "
          f"{GROSS_ITERS}: one decode's launches {got}, bp_flood.wide_rows {wide_rows}, "
          f"bp_flood.wide_row_iters {wide_iters}, bp.row_iters {row_iters}; K1 at its stages, "
          "five outputs bit-identical to bp_decode_plain: "
          + "; ".join(f"stage {r['stage']} {r['rows']} rows wide: {r['ms']:.3f} ms (device "
                      f"memory forced {r['device_memory_ms']:.3f} ms, in turns; "
                      f"{r['threads']} threads, grid {r['grid']}, {r['registers']} "
                      f"registers, {r['smem_bytes']} B shared)"
                      f", {r['us_per_iteration']:.3f} us an iteration, "
                      f"{r['ns_per_row_iteration']:.1f} ns a row-iteration "
                      f"({r['row_iters']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                      for r in results)
          + f" {tag}")
    return {"two_gross_stages": results, "two_gross_launches": got["bp_flood"],
            "two_gross_wide_rows": wide_rows, "two_gross_wide_row_iters": wide_iters,
            "two_gross_row_iters": row_iters}


def rank_split(ranks: list[dict]) -> str:
    """Each rank's ms a batch, beside one reduction's and one slice's decode."""
    return ("each rank's first batch of one (a fresh process, before the timed run) "
            + str([round(k["first_batch_s"], 3) for k in ranks]) + " s; ms a batch by rank "
            + str([round(k["batch_ms"], 3) for k in ranks])
            + ", one gloo reduction of the counts " + str([round(k["reduce_ms"], 3) for k in ranks])
            + ", one batch slice's stats " + str([round(k["stats_ms"], 3) for k in ranks]))


def run_ranks(world: int, placement: str, batch: int,
              runs: int) -> tuple[list[dict], list[str], float]:
    """``world`` ranks of :func:`rank_main`, subprocesses of this script
    joined by gloo on a free port, any still running after
    ``RANK_TIMEOUT`` killed; each rank's last line, the output files and
    the seconds taken with start-up.  Fails if a rank fails, hangs or exits
    non-zero."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as out_dir, tempfile.TemporaryDirectory() as log_dir:
        logs = [open(os.path.join(log_dir, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   str(world), str(port), out_dir, placement, str(batch),
                                   str(runs)],
                                  stdout=logs[r], stderr=subprocess.STDOUT, text=True,
                                  env=dict(os.environ, LOCAL_RANK=str(r)))
                 for r in range(world)]
        t0 = time.perf_counter()
        try:  # a rank that fails stops the others, which would wait for it
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.perf_counter() - t0 < RANK_TIMEOUT):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        total = time.perf_counter() - t0
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        files = sorted(os.listdir(out_dir))
    check(total < RANK_TIMEOUT, f"ranks ran past {RANK_TIMEOUT} s: {[o[-2000:] for o in outs]}")
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{out[-3000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out in outs], files, total


_SIM_COUNTERS = ("run_count", "bp_converge_count_x", "bp_converge_count_z", "bp_success_count",
                 "osd0_success_count", "osdw_success_count", "min_logical_weight")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, out_dir: str, placement: str, batch: int,
              runs: int) -> None:
    """One rank of :func:`run_ranks`: the flagship example harness at batch
    ``batch``, ``runs`` runs, in a gloo group of ``world`` ranks, on the
    first card (``placement`` "first",
    ``use_mesh=1`` over ``make_mesh(1)``) or on its own (``"own"``,
    ``use_mesh=-1``); prints its counters, the wall of its run and its
    launches, in total and by card, as the last line."""
    sys.path.insert(0, ROOT)
    from bp_osd_tpu_torch.codes import hgp, mkmn_16_4_6
    from bp_osd_tpu_torch.examples.qldpc_decode_example import OSD_OPTIONS
    from bp_osd_tpu_torch.ops import launch_counter
    from bp_osd_tpu_torch.ops.cuda_bp import bp_flood
    from bp_osd_tpu_torch.ops.cuda_osd import osd_cs
    from bp_osd_tpu_torch.parallel import host_batch_slice, initialize, make_mesh
    from bp_osd_tpu_torch.parallel.distributed import reduce_batch_counts

    check(initialize(f"127.0.0.1:{port}", world, rank), "initialize returned False")
    qcode = hgp(mkmn_16_4_6())
    from bp_osd_tpu_torch.sim import css_decode_sim

    mesh = dict(use_mesh=1, mesh=make_mesh(1)) if placement == "first" else dict(use_mesh=-1)
    opts = dict(OSD_OPTIONS, run_sim=0, tqdm_disable=1, check_code=0, batch_size=batch, **mesh)
    # a fresh process's first batch loads kernels and libraries: one batch
    # first, so the timed run is as warm as the one-process run it is set beside
    t0 = time.perf_counter()
    css_decode_sim(hx=qcode.hx, hz=qcode.hz, **dict(opts, target_runs=1)).run_decode_sim()
    first = time.perf_counter() - t0
    sim = css_decode_sim(hx=qcode.hx, hz=qcode.hz, **dict(
        opts, target_runs=runs, output_file=os.path.join(out_dir, f"rank{rank}.json")))
    check(sim.use_mesh == 1, f"rank {rank}: use_mesh {sim.use_mesh}")
    for f in (bp_flood, osd_cs):
        launch_counter(f)
    torch.cuda.synchronize(sim._device)
    t0 = time.perf_counter()
    sim.run_decode_sim()
    torch.cuda.synchronize(sim._device)
    wall = time.perf_counter() - t0
    launches = {"bp_flood": bp_flood.launches, "osd_cs": osd_cs.launches}
    launches_on = {f.__name__: dict(f.launches_on) for f in (bp_flood, osd_cs)}
    # the pieces of a batch: one reduction of the counts, one slice's stats
    t0 = time.perf_counter()
    for _ in range(50):
        reduce_batch_counts([0] * 5, 0)
    reduce_ms = (time.perf_counter() - t0) * 1e3 / 50
    start, keep = host_batch_slice(sim.batch_size)
    part = torch.rand(sim.batch_size, sim.N, device=sim._device)[start:start + keep]
    stats = []
    for _ in range(6):
        torch.cuda.synchronize(sim._device)
        t0 = time.perf_counter()
        sim._stats(part)
        torch.cuda.synchronize(sim._device)
        stats.append((time.perf_counter() - t0) * 1e3)
    torch.distributed.destroy_process_group()
    print(json.dumps({"counters": {k: getattr(sim, k) for k in _SIM_COUNTERS}, "wall": wall,
                      "batch_ms": wall * 1e3 * sim.batch_size / sim.run_count,
                      "reduce_ms": reduce_ms, "stats_ms": float(np.median(stats[1:])),
                      "first_batch_s": first,
                      "launches": launches, "launches_on": launches_on}))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from bp_osd_tpu_torch import BpDecoder, BpOsdDecoder, bposd_decoder
    from bp_osd_tpu_torch.codes import hgp, lifted_hgp, mkmn_16_4_6, rep_code
    from bp_osd_tpu_torch.decoder.bp import bp_decode_plain, llr_from_channel
    from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph, bp_decode_lifted
    from bp_osd_tpu_torch.decoder.osd import (build_osd_consts, eliminate_plain, osd_decode,
                                              osd_decode_plain, osd_route)
    from bp_osd_tpu_torch.decoder.tanner import TannerGraph
    from bp_osd_tpu_torch.ops import _build
    from bp_osd_tpu_torch.ops.cuda_bp import (bp_flood, bp_flood_plan, bp_flood_smem_bytes,
                                              bp_flood_table_bytes, bp_flood_team_bytes, k1_fits)
    from bp_osd_tpu_torch.decoder.pipeline import _staged_bp
    from bp_osd_tpu_torch.ops.cuda_gf2 import (eliminate, gf2_elim_plan, gf2_elim_smem_bytes,
                                               gf2_elim_warp_smem_bytes, k4_fits, k4_placement)
    from bp_osd_tpu_torch.ops.cuda_lifted_bp import bp_lifted, bp_lifted_plan
    from bp_osd_tpu_torch.ops.cuda_osd import (k2_fits, osd_cs, osd_cs_plan,
                                               osd_cs_warp_smem_bytes, osd_e)
    from bp_osd_tpu_torch.ops.cuda_osd_large import (osd_large, osd_large_panel, osd_large_plan,
                                                     osd_large_smem_bytes)
    from bp_osd_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    print(f"phase 1 card: {card}; torch: {kind}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    so_path, log = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(so_path, ROOT)}; "
          + " | ".join(ptxas))

    data = np.load(CORPUS)
    B, m, n, max_iter, osd_order, _ = (int(x) for x in data["meta"])
    H = np.asarray(hgp(mkmn_16_4_6()).hx.toarray(), np.uint8)
    graph = TannerGraph(H, dev)
    H_f = torch.as_tensor(H, dtype=torch.float32, device=dev)
    synd = torch.as_tensor(np.unpackbits(data["synd_packed"], axis=1)[:, :m], device=dev)
    ref_osdw = torch.as_tensor(np.unpackbits(data["osdw_packed"], axis=1)[:, :n], device=dev)
    llr0 = llr_from_channel(np.full(n, 0.05)).to(dev).expand(B, n)
    bp_kw = dict(method="minimum_sum", ms_scaling_factor=0.0)

    # ---- phase 3: K1 vs plain ----
    k = bp_flood(graph, synd, llr0, max_iter=max_iter, **bp_kw)
    p = bp_decode_plain(graph, synd, llr0, max_iter=max_iter, **bp_kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("hard", "llr", "converged", "iterations"), k, p):
        check(same(a, b), f"K1 {name} differs from the plain version")
    bp_err = float((k[1] - p[1]).abs().max())
    check(np.array_equal(k[2].cpu().numpy(), data["converged"]), "K1 converged != corpus")
    check(np.array_equal(k[3].cpu().numpy(), data["iterations"]), "K1 iterations != corpus")
    s1 = bp_flood(graph, synd, llr0, max_iter=24, emit_state=True, **bp_kw)
    s1p = bp_decode_plain(graph, synd, llr0, max_iter=24, emit_state=True, **bp_kw)
    check(same(s1[4], s1p[4]), "K1 emitted v2c differs from the plain version")
    hard, llr, conv, iters, v2c = (x.clone() for x in s1)
    for s_prev, s_next in ((24, 96), (96, max_iter)):
        sel = torch.nonzero(~conv).flatten()
        out = bp_flood(graph, synd[sel], llr0[sel], max_iter=s_next, v2c_init=v2c[sel],
                       it0=s_prev, emit_state=True, **bp_kw)
        hard[sel], llr[sel], conv[sel], iters[sel], v2c[sel] = out
    for name, a, b in zip(("hard", "llr", "converged", "iterations"), (hard, llr, conv, iters), k):
        check(same(a, b), f"K1 resume chain 24->96->400: {name} differs from a straight run")
    print(f"phase 3 K1 vs plain: {B} corpus rows x max_iter {max_iter}: hard/llr/converged/"
          f"iterations bit-identical (max |dllr| = {bp_err}), corpus converged "
          f"{int(k[2].sum())}/{B} and iterations reproduced, resume 24->96->400 == straight")

    # ---- phase 4: K2 vs plain on identical LLRs ----
    consts = build_osd_consts(graph, "osd_cs", osd_order)
    perm = torch.argsort(k[1], dim=1, stable=True).to(torch.int32)
    e0, ew = osd_cs(graph, perm, synd, osd_order=osd_order, pairs=consts.pairs)
    q0, qw = osd_decode_plain(graph, perm, synd, method="osd_cs", osd_order=osd_order,
                              pairs=consts.pairs)
    check(same(e0, q0) and same(ew, qw), "K2 osd0/osdw differ from the plain version")
    check(satisfies(ew, H_f, synd) and satisfies(e0, H_f, synd), "K2 output violates syndromes")
    skip = k[2]
    e0s, ews = osd_cs(graph, perm, synd, osd_order=osd_order, pairs=consts.pairs, skip=skip)
    live = ~skip
    check(same(ews[live], ew[live]) and not bool(ews[skip].any()), "K2 skip rows")
    osd_err = float((ew.int() - qw.int()).abs().max())
    print(f"phase 4 K2 vs plain: {B} rows, osd_cs order {osd_order}: osd0/osdw bit-identical, "
          f"all satisfy their syndromes, skip rows masked")

    # ---- phase 5: the main path through BpOsdDecoder ----
    bp_flood.launches = 0
    osd_cs.launches = 0
    dec = BpOsdDecoder(H, error_rate=0.05, max_iter=0, bp_method="ms", ms_scaling_factor=0,
                       osd_method="osd_cs", osd_order=osd_order)
    check(dec.device.type == "cuda" and dec.backend == "cuda", "decoder is not on the card")
    osdw = dec.decode_batch(synd, outputs="device")
    check(same(osdw, ref_osdw), "BpOsdDecoder osdw != corpus")
    check(np.array_equal(osdw.sum(1).cpu().numpy(), data["weights"]), "weights != corpus")
    rng = np.random.default_rng(SEED)
    errors = torch.as_tensor((rng.random((FRESH, n)) < 0.05).astype(np.float32), device=dev)
    fresh = torch.remainder(errors @ H_f.T, 2).to(torch.uint8)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dec.decode_batch(fresh, outputs="device")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {"bp_flood": bp_flood.launches, "osd_cs": osd_cs.launches}
    check(launches["bp_flood"] > 0 and launches["osd_cs"] > 0, f"kernel not launched: {launches}")
    check(satisfies(out, H_f, fresh), "a fresh osdw violates its syndrome")
    conv_f = float(dec.converge_batch.float().mean())
    mean_it = float(dec.iter_batch.float().mean())
    rate = FRESH / float(np.median(walls))
    print(f"phase 5 main path: corpus osdw/weights reproduced; {FRESH} fresh syndromes "
          f"(seed {SEED}, p=0.05) all satisfied; {rate:.1f} syndromes/s "
          f"(median of walls {[round(w, 4) for w in walls]} s); converged fraction "
          f"{conv_f:.4f}; mean iterations {mean_it:.2f}; launches {launches} {tag}")

    # one decode's launches, then K1 at each of its three launches (the rows,
    # it0 and state the pipeline gives each stage) and K2 on its OSD rows,
    # beside their bounds and plain versions
    bp_flood.launches = osd_cs.launches = 0
    dec.decode_batch(fresh, outputs="device")
    per_decode = {"bp_flood": bp_flood.launches, "osd_cs": osd_cs.launches}
    check(per_decode == {"bp_flood": 3, "osd_cs": 1}, f"one decode's launches {per_decode}")
    fl0 = llr0[:1].expand(FRESH, n)
    # (arguments, keywords, kernel outputs, sample-iterations, rows) of each stage
    stages = k1_stages(graph, fresh, fl0, max_iter, **bp_kw)
    check(len(stages) == 3, f"{len(stages)} K1 stages, not 3")
    last = stages[-1]
    check(same(last.rows[~last.out[2]], torch.nonzero(~dec.converge_batch).flatten()),
          "the staged rows differ from the decoder's failures")

    stage_ms, stage_plain_ms, stage_bound, report = [], [], [], []
    for i, (args, kw_s, out, sample_its, _) in enumerate(stages):
        nrows = args[1].shape[0]
        want = bp_decode_plain(*args, **kw_s)  # the last stage's stays for the sweep
        k1_equal(out, want, f"stage {i + 1} ({nrows} rows)")
        k_ms = cuda_ms(lambda: bp_flood(*args, **kw_s), 5)
        p_ms = cuda_ms(lambda: bp_decode_plain(*args, **kw_s), 1)
        b = k1_bound(graph, nrows, sample_its, prior_rows=1 if i == 0 else nrows,
                     v2c_in=i > 0, emit=kw_s["emit_state"])
        plan = bp_flood_plan(graph, nrows)
        stage_ms.append(k_ms)
        stage_plain_ms.append(p_ms)
        stage_bound.append(b)
        report.append(f"stage {i + 1} ({nrows} rows, iterations {kw_s['it0'] + 1}-"
                      f"{kw_s['max_iter']}, {sample_its} sample-iterations): {k_ms:.3f} ms vs plain "
                      f"{p_ms:.3f} ms, outputs bit-identical; bound {b.detail()}, "
                      f"{100 * b.ms / k_ms:.1f}% of it; plan: {plan_line(plan)}")
    # other team sizes, each held to the plain version: stage 3 at one warp
    # (the smallest team) to six, and the 512 corpus rows (a harness-sized
    # stage) at three warps (the flagship's team) and at six
    corpus = ((graph, synd, llr0), dict(max_iter=max_iter, **bp_kw), p)
    sweep = []
    for label, (a_s, k_s, w_s), teams in (("stage 3", (args, kw_s, want), (1, 2, 3, 6)),
                                          ("corpus", corpus, (3, 6))):
        for tw in teams:
            k1_equal(_with_team(tw, lambda: bp_flood(*a_s, **k_s)), w_s,
                     f"{label} with teams of {tw} warps")
            plan = _with_team(tw, lambda: bp_flood_plan(graph, a_s[1].shape[0]))
            t_ms = _with_team(tw, lambda: cuda_ms(lambda: bp_flood(*a_s, **k_s), 5))
            sweep.append(f"{label} {a_s[1].shape[0]} rows, {tw} warp(s) {t_ms:.3f} ms "
                         f"({plan['resident_per_sm']} resident, {plan['registers']} registers)")
    report.append("other teams, bit-identical: " + ", ".join(sweep))
    bp_ms, bp_plain_ms = sum(stage_ms), sum(stage_plain_ms)
    bp_bound = bound_sum(stage_bound)
    fail = ~dec.converge_batch
    f_synd = fresh[fail]
    f_perm = torch.argsort(dec.log_prob_ratios_batch[fail], dim=1, stable=True).to(torch.int32)
    f_got = osd_cs(graph, f_perm, f_synd, osd_order=osd_order, pairs=consts.pairs)
    f_want = osd_decode_plain(graph, f_perm, f_synd, method="osd_cs", osd_order=osd_order,
                              pairs=consts.pairs)
    check(same(f_got[0], f_want[0]) and same(f_got[1], f_want[1]),
          "K2 osd0/osdw differ from the plain version on the decode's OSD rows")
    osd_ms = cuda_ms(lambda: osd_cs(graph, f_perm, f_synd, osd_order=osd_order,
                                    pairs=consts.pairs), 5)
    osd_plain_ms = cuda_ms(lambda: osd_decode_plain(graph, f_perm, f_synd, method="osd_cs",
                                                    osd_order=osd_order, pairs=consts.pairs), 3)
    nf = f_perm.shape[0]
    osd_b = osd_cs_bound(graph, f_perm, f_synd, consts.pairs)
    print("phase 5 K1 at the decode's launches: " + "; ".join(report)
          + f"; K1 per decode {bp_ms:.3f} ms vs plain {bp_plain_ms:.3f} ms, bound "
          f"{bp_bound.detail()}, {100 * bp_bound.ms / bp_ms:.1f}% of it {tag}")
    print(f"phase 5 K2 B={nf} order {osd_order}: {osd_ms:.3f} ms vs plain {osd_plain_ms:.3f} ms, "
          f"osd0/osdw bit-identical; {bound_text(osd_b, osd_ms)}; "
          f"plan: {plan_line(osd_cs_plan(graph, nf, osd_order))}; launches per decode "
          f"{per_decode} {tag}")

    # ---- phase 6: README golden decode ----
    surf = hgp(rep_code(3), rep_code(3), compute_distance=True)
    bpd = bposd_decoder(surf.hz, error_rate=0.05, channel_probs=[None], max_iter=surf.N,
                        bp_method="ms", ms_scaling_factor=0, osd_method="osd_cs", osd_order=7)
    error = np.zeros(surf.N, np.uint8)
    error[[5, 12]] = 1
    got = bpd.decode(surf.hz @ error % 2)
    want = np.zeros(surf.N, np.uint8)
    want[8] = 1
    check(np.array_equal(got, want), f"README golden decode gave {got}")
    print(f"phase 6 README golden decode on {bpd.device}: osdw flips qubit 8")

    # ---- phase 7: K5 vs plain ----
    lib = _build.load()
    for mm, nn, lam in ((graph.m, graph.n, osd_order), (480, 1000, LIFT_ORDER),
                        (720, 1500, LIFT_ORDER), (4800, 10000, LIFT_ORDER), (720, 1500, 0)):
        for panel in (1, 16, osd_large_panel(mm, nn, lam)):
            check(osd_large_smem_bytes(mm, nn, lam, panel)
                  == lib.osd_large_smem_bytes(nn, -(-mm // 32), lam, panel),
                  f"K5 shared-memory mirror differs from the library at m={mm} n={nn} "
                  f"lam={lam} panel={panel}")
        for warps in (1, 20):
            check(osd_cs_warp_smem_bytes(mm, nn, lam, warps)
                  == lib.osd_cs_warp_smem_bytes(nn, -(-mm // 32), lam, warps),
                  f"K2 shared-memory mirror differs from the library at m={mm} n={nn} lam={lam}")
    a0, aw = osd_large(graph, perm, synd, osd_order=osd_order, pairs=consts.pairs)
    check(same(a0, q0) and same(aw, qw) and same(a0, e0) and same(aw, ew),
          "K5 differs from K2 / the plain version on the corpus rows")
    t0 = time.perf_counter()
    qcode = lifted_hgp(PROTO, lift=LIFT)
    Hl = np.asarray(qcode.hx.toarray(), np.uint8)
    ml, nl = Hl.shape
    dec_l = BpOsdDecoder(qcode.hx, error_rate=LIFT_P, max_iter=100, bp_method="ms",
                         ms_scaling_factor=0.625, osd_method="osd_cs", osd_order=LIFT_ORDER,
                         proto=qcode.hx_proto, lift=LIFT)
    gl, lgl = dec_l.graph, LiftedGraph(qcode.hx_proto, LIFT, dev)
    check(not k2_fits(gl, LIFT_ORDER) and not k2_fits(gl, 0), "K2 claims to fit lift 400")
    Hl_f = torch.as_tensor(Hl, dtype=torch.float32, device=dev)
    build_s = time.perf_counter() - t0

    def lifted_batch(p, seed, rows):
        rng = np.random.default_rng(seed)
        err = torch.as_tensor((rng.random((rows, nl)) < p).astype(np.float32), device=dev)
        return torch.remainder(err @ Hl_f.T, 2).to(torch.uint8)

    heavy = lifted_batch(LIFT_HEAVY_P, SEED + 1, 64)
    l0_heavy = llr_from_channel(np.full(nl, LIFT_HEAVY_P)).to(dev)
    bp_h = bp_decode_lifted(lgl, heavy, l0_heavy, bp_method="ms", max_iter=100,
                            ms_scaling_factor=0.625)
    fail8 = torch.nonzero(~bp_h.converged).flatten()[:8]
    check(fail8.numel() == 8, f"only {fail8.numel()} of 64 rows failed BP at p={LIFT_HEAVY_P}")
    s8 = heavy[fail8]
    p8 = torch.argsort(bp_h.llr[fail8], dim=1, stable=True).to(torch.int32)
    pairs_l = build_osd_consts(gl, "osd_cs", LIFT_ORDER).pairs
    k5 = osd_large(gl, p8, s8, osd_order=LIFT_ORDER, pairs=pairs_l)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    k5_plain = osd_decode_plain(gl, p8, s8, method="osd_cs", osd_order=LIFT_ORDER, pairs=pairs_l)
    end.record()
    torch.cuda.synchronize()
    k5_plain_ms = start.elapsed_time(end)
    check(same(k5[0], k5_plain[0]) and same(k5[1], k5_plain[1]),
          "K5 osd0/osdw differ from the plain version at lift 400")
    check(satisfies(k5[0], Hl_f, s8) and satisfies(k5[1], Hl_f, s8),
          "K5 output violates syndromes at lift 400")
    check(bool((k5[1].sum(1) <= k5[0].sum(1)).all()), "K5 osdw heavier than osd0")
    k5_err = float((k5[1].int() - k5_plain[1].int()).abs().max())

    def k5_run(rows):  # K5 on the first `rows` rows
        return osd_large(gl, p8[:rows], s8[:rows], osd_order=LIFT_ORDER, pairs=pairs_l)

    one = k5_run(1)
    check(same(one[0], k5_plain[0][:1]) and same(one[1], k5_plain[1][:1]),
          "K5 on the first row alone differs from the plain version")
    k5_ms, k5_one_ms = cuda_ms(lambda: k5_run(8), 3), cuda_ms(lambda: k5_run(1), 3)
    work8 = elim_work(gl, p8, s8)

    def k5_bound(rows):
        return osd_cs_bound(gl, p8[:rows], s8[:rows], pairs_l, work=work8.rows(slice(0, rows)))

    k5_b, k5_one_b = k5_bound(8), k5_bound(1)
    k5_plan = osd_large_plan(gl, LIFT_ORDER)
    profiling.collect()
    profiling.enable()
    k5_run(8)
    profiling.disable()
    k5_counts = profiling.collect().counters
    k5_pivots, k5_passes = k5_counts["osd_large.pivots"], k5_counts["osd_large.panel_passes"]
    check(k5_pivots == 8 * gl.rank, f"K5 counted {k5_pivots} pivots on 8 rows of rank {gl.rank}")

    def traffic_line(w: ElimWork, label: str) -> str:
        cm, wm = w.traffic()
        return (f"{label}: {int(w.steps.sum())} column steps, {int(w.pivots.sum())} pivot "
                f"steps, {int(w.pivot_tests.sum())} tests at pivot steps, "
                f"{int(w.hits.sum())} hit columns, {int(w.xor_words.sum())} XORed words; "
                f"hit tests + XORs move {cm / 1e6:.1f} MB column-major, {wm / 1e6:.1f} MB "
                f"word-major")

    k5_report = (
        f"K5 (panels of {k5_plan['panel']}; 8 rows: {k5_pivots} pivots in {k5_passes} trailing "
        f"passes, {k5_pivots / k5_passes:.2f} a pass) 1 row {k5_one_ms:.3f} ms, "
        f"{bound_text(k5_one_b, k5_one_ms)}; 8 rows {k5_ms:.3f} ms, "
        f"{bound_text(k5_b, k5_ms)}; plan {plan_line(k5_plan)}; plain "
        f"{k5_plain_ms:.1f} ms for the 8 rows; " + traffic_line(work8.rows(slice(0, 1)), "row 0")
        + "; " + traffic_line(work8, "8 rows"))

    aux = np.load(AUX)
    _, ma, na = (int(x) for x in aux["lifted_streamed_shape"])
    qa = lifted_hgp(PROTO, lift=60)
    dec_a = BpOsdDecoder(qa.hx, error_rate=0.05, max_iter=12, bp_method="minimum_sum",
                         ms_scaling_factor=0.625, osd_method="osd_cs", osd_order=15,
                         proto=qa.hx_proto, lift=60)
    synd_a = torch.as_tensor(np.unpackbits(aux["lifted_streamed_synd"], axis=1)[:, :ma],
                             device=dev)
    before_k5, before_k2 = osd_large.launches, osd_cs.launches
    osdw_a = dec_a.decode_batch(synd_a)
    check(osd_large.launches > before_k5 and osd_cs.launches == before_k2,
          "the lift-60 aux corpus did not go through K5 alone")
    check(np.array_equal(np.packbits(osdw_a, axis=1), aux["lifted_streamed_osdw"]),
          "lifted_streamed osdw != aux corpus")
    check(np.array_equal(dec_a.converge_batch, aux["lifted_streamed_conv"])
          and np.array_equal(dec_a.iter_batch, aux["lifted_streamed_iters"]),
          "lifted_streamed converged/iterations != aux corpus")
    print(f"phase 7 K5 vs plain: corpus rows K5 == K2 == plain at order {osd_order}; "
          f"lift {LIFT} (m={ml}, n={nl}, rank {gl.rank}; code + decoder built in "
          f"{build_s:.1f} s): 8 BP-failing rows and the first alone bit-identical, all "
          f"satisfied, osdw weights {k5[1].sum(1).tolist()} <= osd0 "
          f"{k5[0].sum(1).tolist()}; {k5_report}; aux corpus lifted_streamed reproduced "
          f"through K5; K2/K5 shared-memory mirrors == library {tag}")

    # ---- phase 8: the lifted path at full width ----
    fresh_l = lifted_batch(LIFT_P, SEED + 2, LIFT_B)
    heavy_l = lifted_batch(LIFT_HEAVY_P, SEED + 3, LIFT_B)
    for f in (bp_flood, osd_cs, osd_large, bp_lifted):
        f.launches = 0
    walls_l = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_l = dec_l.decode_batch(fresh_l, outputs="device")
        torch.cuda.synchronize()
        walls_l.append(time.perf_counter() - t0)
    conv_l = float(dec_l.converge_batch.float().mean())
    check(satisfies(out_l, Hl_f, fresh_l), "a lifted osdw violates its syndrome")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_h = dec_l.decode_batch(heavy_l, channel_probs=np.full(nl, LIFT_HEAVY_P),
                               outputs="device")
    torch.cuda.synchronize()
    wall_h = time.perf_counter() - t0
    launches_l = {"bp_flood": bp_flood.launches, "osd_cs": osd_cs.launches,
                  "osd_large": osd_large.launches, "bp_lifted": bp_lifted.launches}
    check(launches_l["osd_large"] > 0, f"K5 not launched on the lifted path: {launches_l}")
    check(launches_l["bp_lifted"] == 4, f"K6 not launched once a lifted decode: {launches_l}")
    check(launches_l["osd_cs"] == 0 and launches_l["bp_flood"] == 0,
          f"the lifted path launched K1/K2: {launches_l}")
    check(satisfies(out_h, Hl_f, heavy_l), "a heavy-batch lifted osdw violates its syndrome")
    osd_large.launches = bp_lifted.launches = 0
    dec_l.decode_batch(heavy_l, channel_probs=np.full(nl, LIFT_HEAVY_P), outputs="device")
    k5_per_decode, k6_per_decode = osd_large.launches, bp_lifted.launches
    conv_h = dec_l.converge_batch.clone()
    n_fail_h = int((~conv_h).sum())
    rate_l = LIFT_B / float(np.median(walls_l))

    # where the time goes on the heavy batch: lifted BP, argsort, K5, host glue
    l0_l = llr_from_channel(np.full(nl, LIFT_P)).to(dev)
    lbp_ms = cuda_ms(lambda: bp_decode_lifted(lgl, fresh_l, l0_l, bp_method="ms", max_iter=100,
                                              ms_scaling_factor=0.625), 3)
    hbp_ms = cuda_ms(lambda: bp_decode_lifted(lgl, heavy_l, l0_heavy, bp_method="ms",
                                              max_iter=100, ms_scaling_factor=0.625), 3)
    llr_fail = dec_l.log_prob_ratios_batch[~conv_h]
    sort_ms = cuda_ms(lambda: torch.argsort(llr_fail, dim=1, stable=True), 3)
    p_fail = torch.argsort(llr_fail, dim=1, stable=True).to(torch.int32)
    s_fail = heavy_l[~conv_h]
    k5_all = osd_large(gl, p_fail, s_fail, osd_order=LIFT_ORDER, pairs=pairs_l)
    check(same(k5_all[1][:8], osd_decode_plain(gl, p_fail[:8], s_fail[:8], method="osd_cs",
                                               osd_order=LIFT_ORDER, pairs=pairs_l)[1]),
          "K5 differs from the plain version on the heavy batch's first failing rows")
    k5_all_ms = cuda_ms(lambda: osd_large(gl, p_fail, s_fail, osd_order=LIFT_ORDER,
                                          pairs=pairs_l), 3)
    glue_ms = wall_h * 1e3 - hbp_ms - sort_ms - k5_all_ms
    k6_plan = bp_lifted_plan(lgl)
    print(f"phase 8 lifted path: [[{nl},{qcode.K}]] lift {LIFT}, B={LIFT_B}, p={LIFT_P}: "
          f"all satisfied; {rate_l:.1f} syndromes/s (median of walls "
          f"{[round(w, 4) for w in walls_l]} s); converged fraction {conv_l:.4f}; lifted BP "
          f"(K6) {lbp_ms:.3f} ms per batch; p={LIFT_HEAVY_P}: {n_fail_h}/{LIFT_B} rows failed "
          f"BP, all satisfied, wall {wall_h * 1e3:.3f} ms = lifted BP (K6, {k6_plan['threads']} "
          f"threads a row, {k6_plan['rows_per_sm']} an SM) {hbp_ms:.3f} + argsort "
          f"{sort_ms:.3f} + K5 {k5_all_ms:.3f} ({k5_all_ms / max(n_fail_h, 1):.3f} ms per "
          f"failing row) + host glue {glue_ms:.3f} ms; K5 "
          f"on 1 row {k5_one_ms:.3f} ms, on 8 rows {k5_ms:.3f} ms vs plain "
          f"{k5_plain_ms:.1f} ms; launches {launches_l}, K5 {k5_per_decode} and K6 "
          f"{k6_per_decode} per decode {tag}")

    # launch_counts(): eliminate counts both K4 kernels, eliminate_warp the warp kernel
    def max_err(xs, ys):
        return max(float((x.long() - y.long()).abs().max()) if x.numel() else 0.0
                   for x, y in zip(xs, ys))

    def timed_decode(dec, batch, reps=3):
        """Median wall of ``reps`` decodes (outputs left on the card) and the
        last output."""
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec.decode_batch(batch, outputs="device")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return out, walls

    def failing_rows(dec, batch):
        fail = ~dec.converge_batch
        return (torch.argsort(dec.log_prob_ratios_batch[fail], dim=1, stable=True)
                .to(torch.int32), batch[fail])

    # ---- phase 9: K4 vs plain; the default decoder (osd_0) on the card ----
    check(k4_placement(graph) == "warp", "K4's auto placement is not the warp kernel")
    el_plain = eliminate_plain(graph, perm, synd)
    el_plain_skip = eliminate_plain(graph, perm, synd, skip=skip)
    for pl in ("warp", "shared", "global"):
        el = eliminate(graph, perm, synd, placement=pl)
        for name, a, b in zip(el._fields, el, el_plain):
            check(same(a, b), f"K4 ({pl}) {name} differs from eliminate_plain")
        el_skip = eliminate(graph, perm, synd, skip=skip, placement=pl)
        check(all(same(a, b) and not bool(a[skip].any()) for a, b in zip(el_skip, el_plain_skip)),
              f"K4 ({pl}) skip rows")
    dec0 = BpOsdDecoder(H, error_rate=0.05)
    check((dec0.osd_method, dec0.max_iter, dec0.bp_method) == ("osd0", n, "minimum_sum"),
          "BpOsdDecoder defaults moved")
    check(osd_route(graph, dec0.osd_method, dec0.osd_order) == "k4", "osd0 is not routed to K4")
    reset_launches()
    out0, walls0 = timed_decode(dec0, fresh)
    launches0 = launch_counts()
    check(launches0["eliminate_warp"] > 0
          and launches0["eliminate"] == launches0["eliminate_warp"] and launches0["bp_flood"] > 0 and launches0["osd_cs"] == 0 and launches0["osd_e"] == 0,
          f"the default decoder's kernels: {launches0}")
    check(satisfies(dec0.osd0_decoding_batch, H_f, fresh) and satisfies(out0, H_f, fresh),
          "a default-decoder osd0 violates its syndrome")
    f_perm0, f_synd0 = failing_rows(dec0, fresh)
    n4 = f_perm0.shape[0]
    want0 = eliminate_plain(graph, f_perm0, f_synd0)
    for pl in ("warp", "shared"):  # the decode's OSD rows, bit for bit
        got0 = eliminate(graph, f_perm0, f_synd0, placement=pl)
        for name, a, b in zip(got0._fields, got0, want0):
            check(same(a, b), f"K4 ({pl}) {name} differs from eliminate_plain on the default "
                              f"decode's {n4} OSD rows")
        if pl == "warp":
            k4_err = max_err(got0, want0)
    k4_ms = cuda_ms(lambda: eliminate(graph, f_perm0, f_synd0, placement="warp"), 5)
    k4_block_ms = cuda_ms(lambda: eliminate(graph, f_perm0, f_synd0, placement="shared"), 5)
    # K2 at order 0 runs the same warp elimination with no h_work to write
    k2_0_ms = cuda_ms(lambda: osd_cs(graph, f_perm0, f_synd0, osd_order=0), 5)
    k4_plan = gf2_elim_plan(graph, n4)
    k4_b = elim_bound(graph, f_perm0, f_synd0)
    reset_launches()
    dec0.decode_batch(fresh, outputs="device")
    k4_per_decode = launch_counts()["eliminate_warp"]
    k4_plain_ms = cuda_ms(lambda: eliminate_plain(graph, f_perm0, f_synd0), 3)
    f_llr0 = dec0.log_prob_ratios_batch[~dec0.converge_batch]
    tail0_ms = cuda_ms(lambda: osd_decode(graph, f_synd0, f_llr0, osd_method="osd0"), 5)
    l0_dec0 = dec0._llr0().expand(FRESH, n)
    bp0_ms = cuda_ms(lambda: _staged_bp(graph, fresh, l0_dec0, dec0.bp_method, n,
                                        dec0.ms_scaling_factor), 3)
    wall0_ms = float(np.median(walls0)) * 1e3
    print(f"phase 9 K4 vs plain: {B} corpus rows, the warp kernel and the block kernel in "
          f"shared and device memory: the five outputs equal eliminate_plain, skip rows zero; "
          f"default BpOsdDecoder(hx, error_rate=0.05) on {FRESH} fresh syndromes: all osd0 "
          f"satisfied; {FRESH / float(np.median(walls0)):.1f} syndromes/s (median of walls "
          f"{[round(w, 4) for w in walls0]} s); converged fraction "
          f"{float(dec0.converge_batch.float().mean()):.4f}; launches {launches0}; "
          f"K4 B={n4} (the warp kernel and the block kernel both bit-identical to the plain "
          f"version): warp {k4_ms:.3f} ms, block (shared memory) {k4_block_ms:.3f} ms, plain "
          f"{k4_plain_ms:.3f} ms; warp {bound_text(k4_b, k4_ms)}; block "
          f"{100 * k4_b[0].ms / k4_block_ms:.2f}% of the bound; K2 at order 0 on the same rows "
          f"(the same elimination, no h_work) {k2_0_ms:.3f} ms; plan: {plan_line(k4_plan)}; "
          f"{k4_per_decode} launch(es) per decode; split of the {wall0_ms:.3f} ms wall: staged "
          f"BP {bp0_ms:.3f} + OSD tail (argsort + K4 + osd0 read-off) {tail0_ms:.3f} + host "
          f"glue {wall0_ms - bp0_ms - tail0_ms:.3f} ms {tag}")

    # ---- phase 10: K3 vs plain; the osd_e decoder on the card ----
    for o in (12, 16):
        a = osd_e(graph, perm, synd, osd_order=o)
        b = osd_decode_plain(graph, perm, synd, method="osd_e", osd_order=o)
        check(same(a[0], b[0]) and same(a[1], b[1]), f"K3 differs from the plain osd_e at order {o}")
        check(satisfies(a[1], H_f, synd), f"a K3 osdw violates its syndrome at order {o}")
    k3_err = max_err(a, b)
    _, me, ne = (int(x) for x in aux["flagship_osd_e_shape"])
    dec_e = BpOsdDecoder(H, error_rate=0.05, max_iter=100, bp_method="minimum_sum",
                         ms_scaling_factor=0.0, osd_method="osd_e", osd_order=12)
    synd_e = torch.as_tensor(np.unpackbits(aux["flagship_osd_e_synd"], axis=1)[:, :me],
                             device=dev)
    before_k3 = osd_e.launches
    osdw_e = dec_e.decode_batch(synd_e)
    check(osd_e.launches > before_k3, "the aux corpus flagship_osd_e did not launch K3")
    check(np.array_equal(np.packbits(osdw_e, axis=1), aux["flagship_osd_e_osdw"])
          and np.array_equal(dec_e.converge_batch, aux["flagship_osd_e_conv"])
          and np.array_equal(dec_e.iter_batch, aux["flagship_osd_e_iters"]),
          "flagship_osd_e osdw/converged/iterations != aux corpus")
    reset_launches()
    out_e, walls_e = timed_decode(dec_e, fresh)
    launches_e = launch_counts()
    check(launches_e["osd_e"] > 0 and launches_e["osd_cs"] == 0
          and launches_e["eliminate"] == 0, f"the osd_e decoder's kernels: {launches_e}")
    check(satisfies(out_e, H_f, fresh), "a fresh osd_e osdw violates its syndrome")
    f_perm_e, f_synd_e = failing_rows(dec_e, fresh)
    n3 = f_perm_e.shape[0]
    work_e = elim_work(graph, f_perm_e, f_synd_e)
    k3_t, k3_bounds = {}, {}
    for o in (12, 16):  # the decode's OSD rows, held to the plain osd_e, then timed
        got = osd_e(graph, f_perm_e, f_synd_e, osd_order=o)
        want = osd_decode_plain(graph, f_perm_e, f_synd_e, method="osd_e", osd_order=o)
        check(same(got[0], want[0]) and same(got[1], want[1]),
              f"K3 differs from the plain osd_e on the decode's OSD rows at order {o}")
        k3_t[o] = cuda_ms(lambda: osd_e(graph, f_perm_e, f_synd_e, osd_order=o), 5)
        k3_bounds[o] = osd_e_bound(graph, f_perm_e, f_synd_e, o, work=work_e)
    k3_ms, k3_16_ms, k3_b, k3_16_b = k3_t[12], k3_t[16], k3_bounds[12], k3_bounds[16]
    reset_launches()
    dec_e.decode_batch(fresh, outputs="device")
    k3_per_decode = launch_counts()["osd_e"]
    k3_plain_ms = cuda_ms(lambda: osd_decode_plain(graph, f_perm_e, f_synd_e, method="osd_e",
                                                   osd_order=12), 3)
    print(f"phase 10 K3 vs plain: {B} corpus rows at osd_e orders 12 and 16 bit-identical; "
          f"aux corpus flagship_osd_e ({synd_e.shape[0]} rows) reproduced through K3; "
          f"{FRESH} fresh syndromes at osd_e 12, max_iter 100: all satisfied; "
          f"{FRESH / float(np.median(walls_e)):.1f} syndromes/s (median of walls "
          f"{[round(w, 4) for w in walls_e]} s); launches {launches_e}; K3 "
          f"B={f_perm_e.shape[0]}: {k3_ms:.3f} ms vs plain {k3_plain_ms:.3f} ms, "
          f"{bound_text(k3_b, k3_ms)}, {k3_per_decode} "
          f"launch(es) per decode; K3 at order 16 on the same rows {k3_16_ms:.3f} ms, "
          f"{bound_text(k3_16_b, k3_16_ms)}; plan: "
          f"{plan_line(osd_cs_plan(graph, n3, 12, method='osd_e'))} {tag}")

    # ---- phase 11: the device-memory routes ----
    report = []
    for L in (60, 100):
        qL = lifted_hgp(PROTO, lift=L)
        HL_f = torch.as_tensor(np.asarray(qL.hx.toarray(), np.float32), device=dev)
        dec_L = BpOsdDecoder(qL.hx, error_rate=0.05, max_iter=12, bp_method="minimum_sum",
                             ms_scaling_factor=0.625, osd_method="osd_e", osd_order=8,
                             proto=qL.hx_proto, lift=L)
        gL = dec_L.graph
        check(osd_route(gL, "osd_e", 8) == "k4" and k4_fits(gL) == (L == 60)
              and k4_placement(gL) == ("shared" if L == 60 else "global"),
              f"lift {L} osd_e is not routed to K4's block kernel as expected")
        rng = np.random.default_rng(SEED + L)
        errL = torch.as_tensor((rng.random((32, gL.n)) < 0.05).astype(np.float32), device=dev)
        sL = torch.remainder(errL @ HL_f.T, 2).to(torch.uint8)
        reset_launches()
        outL = dec_L.decode_batch(sL, outputs="device")
        launchesL = launch_counts()
        check(launchesL["eliminate"] > 0 and launchesL["eliminate_warp"] == 0
              and launchesL["osd_e"] == 0 and launchesL["osd_large"] == 0,
              f"lift {L} osd_e kernels: {launchesL}")
        p_fL, s_fL = failing_rows(dec_L, sL)
        fail = ~dec_L.converge_batch
        ref0, refw = osd_decode_plain(gL, p_fL, s_fL, method="osd_e", osd_order=8)
        check(same(outL[fail], refw) and same(dec_L.osd0_decoding_batch[fail], ref0),
              f"lift {L} osd_e through K4 differs from osd_decode_plain")
        check(satisfies(outL, HL_f, sL), f"a lift-{L} osd_e osdw violates its syndrome")
        if L == 60:
            forced = eliminate(gL, p_fL, s_fL, placement="global")
            check(all(same(a, b) for a, b in zip(forced, eliminate(gL, p_fL, s_fL))),
                  "K4 forced to device memory differs from shared memory at lift 60")
        ms = cuda_ms(lambda: eliminate(gL, p_fL, s_fL), 3)
        report.append(f"lift {L} ({gL.m}x{gL.n}, K4 in {'shared' if L == 60 else 'device'} "
                      f"memory): {int(fail.sum())}/32 rows failed BP, osd0/osdw == plain, "
                      f"K4 {ms:.3f} ms")
    dec_d = BpDecoder(qcode.hx, error_rate=LIFT_HEAVY_P, max_iter=100, bp_method="minimum_sum",
                      ms_scaling_factor=0.625)
    gd = dec_d.graph
    check(not k1_fits(gd), "K1 claims to hold the dense lift-400 code in shared memory")
    s64 = heavy_l[:64]
    reset_launches()
    hard_d = dec_d.decode_batch(s64, outputs="device")
    check(bp_flood.launches > 0, "the dense lift-400 BpDecoder did not launch K1")
    l0d = llr_from_channel(np.full(nl, LIFT_HEAVY_P)).to(dev).expand(64, nl)
    d_kw = dict(method="minimum_sum", max_iter=100, ms_scaling_factor=0.625)
    pd = bp_decode_plain(gd, s64, l0d, **d_kw)
    check(same(hard_d, pd[0]) and same(dec_d.log_prob_ratios_batch, pd[1])
          and same(dec_d.converge_batch, pd[2]) and same(dec_d.iter_batch, pd[3]),
          "K1 in device memory differs from bp_decode_plain at lift 400")
    k1g_ms = cuda_ms(lambda: bp_flood(gd, s64, l0d, **d_kw), 3)
    k1g_plain_ms = cuda_ms(lambda: bp_decode_plain(gd, s64, l0d, **d_kw), 1)
    for mm, nn, wr, wc in ((graph.m, graph.n, graph.wr, graph.wc), (720, 1500, 7, 4),
                           (1680, 3500, 7, 4), (1692, 3525, 7, 4), (ml, nl, gd.wr, gd.wc)):
        check(lib.bp_flood_smem_bytes(mm, nn, wr, wc) == bp_flood_smem_bytes(mm, nn, wr, wc)
              and lib.bp_flood_table_bytes(mm, nn, wr, wc) == bp_flood_table_bytes(mm, nn, wr, wc)
              and all(lib.bp_flood_team_bytes(mm, nn, wr, ps) == bp_flood_team_bytes(mm, nn, wr, ps)
                      for ps in (0, 1)),
              f"K1 shared-memory mirror differs from the library at m={mm} n={nn}")
        for g_ in (0, 1):
            check(lib.gf2_elim_smem_bytes(mm, -(-nn // 32), g_)
                  == gf2_elim_smem_bytes(mm, nn, bool(g_)),
                  f"K4 shared-memory mirror differs from the library at m={mm} n={nn}")
        for warps in (1, 19):
            check(lib.gf2_elim_warp_smem_bytes(nn, -(-mm // 32), warps)
                  == gf2_elim_warp_smem_bytes(mm, nn, warps),
                  f"K4 warp shared-memory mirror differs from the library at m={mm} n={nn}")
    print(f"phase 11 device-memory routes: osd_e order 8: " + "; ".join(report)
          + f"; dense lift-{LIFT} BpDecoder (no proto): K1 state in device memory, 64 rows x "
          f"max_iter 100 bit-identical to bp_decode_plain ({int(pd[2].sum())} converged), "
          f"K1 {k1g_ms:.3f} ms vs plain {k1g_plain_ms:.3f} ms; K1 and K4 (block and warp) "
          f"shared-memory mirrors == library {tag}")

    phase12(dev, hgp(mkmn_16_4_6()), tag)
    phase13(H, synd, dec, tag)
    phase14(qcode, tag)
    phase15(H, fresh, tag)
    model_parallel = phase16(tag, qcode)
    phase17(tag, qcode)
    phase18(tag, qcode)
    schedules = phase19(tag, graph, synd, fresh, H_f, consts)
    phase20(tag, H, fresh)
    k6_line = phase21(tag, qcode, fresh_l, heavy_l)
    k1_latency = phase22(tag)
    k5_cluster = phase23(tag)
    k1_wide = phase24(tag)

    def row(name, source, replaces, launches, per_decode, err, ms, plain, b, **extra):
        if not isinstance(b, Bound):  # an OSD kernel's two bounds (osd_bound)
            b, extra["bound_ms_all_columns"] = b[0], b[1].ms
        launcher = {"gf2_elim": "eliminate"}.get(name, name)  # the wrapper's name
        return {"name": name, "route": "cuda", "source": f"bp_osd_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "launches_per_decode": per_decode, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b.ms, "bound_by": b.by, "library_ms": None,
                "bound_bytes": b.nbytes, "bound_int_ops": b.int_ops,
                "bound_float_ops": b.float_ops,
                "launches_model_parallel": model_parallel[launcher], **extra}

    kernels = [
        row("bp_flood", "bp_flood.cu", "bp_osd_tpu/ops/pallas_bp.py:140", launches["bp_flood"],
            per_decode["bp_flood"], bp_err, bp_ms, bp_plain_ms, bp_bound,
            stage_ms=stage_ms, stage_plain_ms=stage_plain_ms,
            stage_bound_ms=[b.ms for b in stage_bound], stage_schedules=schedules,
            latency_plan=k1_latency, wide_plan=k1_wide),
        row("osd_cs", "osd_cs.cu", "bp_osd_tpu/ops/pallas_osd.py:135", launches["osd_cs"],
            per_decode["osd_cs"], osd_err, osd_ms, osd_plain_ms, osd_b),
        row("osd_e", "osd_cs.cu", "bp_osd_tpu/ops/pallas_osd.py:565", launches_e["osd_e"], k3_per_decode,
            k3_err, k3_ms, k3_plain_ms, k3_b, order16_ms=k3_16_ms, order16_bound_ms=k3_16_b[0].ms,
            design="a warp per sample, several a block sharing the column-packed H; "
                   "K2's elimination, then 2^lam / 32 Gray-code patterns a lane"),
        row("gf2_elim", "osd_cs.cu", "bp_osd_tpu/ops/pallas_gf2.py:57", launches0["eliminate_warp"],
            k4_per_decode, k4_err, k4_ms, k4_plain_ms, k4_b, block_ms=k4_block_ms,
            k2_order0_ms=k2_0_ms,
            block_source="bp_osd_tpu_torch/csrc/gf2_elim.cu", plan=k4_plan,
            design="a warp per sample, several a block sharing the column-packed H; K2's "
                   "elimination, then h_work by 32 x 32 bit-tile shuffle transposes through "
                   "an inverse perm; the block kernel (gf2_elim.cu) for codes above it"),
        row("osd_large", "osd_large.cu", "bp_osd_tpu/ops/pallas_osd_large.py:62", launches_l["osd_large"],
            k5_per_decode, k5_err, k5_ms, k5_plain_ms, k5_b, lone_row_ms=k5_one_ms,
            lone_row_bound_ms=k5_one_b[0].ms, heavy_ms=k5_all_ms, heavy_rows=n_fail_h,
            cluster_plan=k5_cluster,
            design="word-major scratch, a window of two panels in shared memory owned "
                   "by warp 0 (search, window XOR, dependent columns without a barrier), "
                   "warps 1-31 test and XOR the later columns; below SMs / 2 rows a "
                   "cluster of 2-8 blocks a sample, blocks 1.. making the far passes"),
        row("bp_lifted", "bp_lifted.cu", "bp_osd_tpu/decoder/lifted_bp.py:173",
            launches_l["bp_lifted"], k6_per_decode, k6_line["err"], k6_line["ms"],
            k6_line["plain_ms"], k6_line["bound"], p0005_ms=k6_line["p0005_ms"],
            p0005_plain_ms=k6_line["p0005_plain_ms"],
            p0005_bound_ms=k6_line["p0005_bound_ms"],
            device_route_ms=k6_line["device_route_ms"], plan=k6_line["plan"],
            lone_row_ms_per_iteration=k6_line["lone_row_ms_per_iteration"],
            team_sweep=k6_line["sweep"],
            replaces_kind="the XLA jax.lax.while_loop of bp_decode_lifted (no Pallas kernel)",
            design="K1's two-barrier order: the check update of t + 1 reads tot_t, takes "
                   "the stop parity of t and forms v2c_t from the check's compressed "
                   "min-sum message (m1a, m2a, sg), rewritten in place; a row's 3m + n words "
                   "in shared memory (device memory above lift 942); persistent blocks of "
                   "a team size chosen from the graph (k6_threads) take rows from a counter; "
                   "routes from the protograph's tables, slot and edge loops unrolled"),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                  sys.argv[6], int(sys.argv[7]), int(sys.argv[8]))
    else:
        main()
