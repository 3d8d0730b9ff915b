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
   syndrome) timed end to end; both kernels' launch counts must be > 0;
6. the README golden decode (surface code, errors on qubits 5 and 12).

It prints the card's name and power limit and a JSON line of per-kernel
results before the last line, ``{"ok": true, "device": {...}}``.  The JAX
package is not imported: the JAX reference enters only through the
committed corpus.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "tests", "data", "flagship_corpus.npz")
SEED = 20261016
FRESH = 16384


def check(ok, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.equal(a, b))


def satisfies(err: torch.Tensor, H_f: torch.Tensor, synd: torch.Tensor) -> bool:
    return same(torch.remainder(err.float() @ H_f.T, 2).to(torch.uint8), synd)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    from bp_osd_tpu_torch import BpOsdDecoder, bposd_decoder
    from bp_osd_tpu_torch.codes import hgp, mkmn_16_4_6, rep_code
    from bp_osd_tpu_torch.decoder.bp import bp_decode_plain, llr_from_channel
    from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode_plain
    from bp_osd_tpu_torch.decoder.tanner import TannerGraph
    from bp_osd_tpu_torch.ops import _build
    from bp_osd_tpu_torch.ops.cuda_bp import bp_flood
    from bp_osd_tpu_torch.ops.cuda_osd import osd_cs

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    print(f"phase 1 card: {card}; torch: {kind}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    so_path, log = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling entry" in ln]
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

    # kernel vs plain times at the main path's shapes: K1 at stage 1 of the
    # fresh batch (B=16384, 24 iterations, emit), K2 on its OSD rows
    fl0 = llr0[:1].expand(FRESH, n)
    bp_ms = cuda_ms(lambda: bp_flood(graph, fresh, fl0, max_iter=24, emit_state=True,
                                     **bp_kw), 5)
    bp_plain_ms = cuda_ms(lambda: bp_decode_plain(graph, fresh, fl0, max_iter=24,
                                                  emit_state=True, **bp_kw), 3)
    fail = ~dec.converge_batch
    f_synd = fresh[fail]
    f_perm = torch.argsort(dec.log_prob_ratios_batch[fail], dim=1, stable=True).to(torch.int32)
    osd_ms = cuda_ms(lambda: osd_cs(graph, f_perm, f_synd, osd_order=osd_order,
                                    pairs=consts.pairs), 5)
    osd_plain_ms = cuda_ms(lambda: osd_decode_plain(graph, f_perm, f_synd, method="osd_cs",
                                                    osd_order=osd_order, pairs=consts.pairs), 3)
    print(f"phase 5 times: K1 B={FRESH} x 24 it: {bp_ms:.3f} ms vs plain {bp_plain_ms:.3f} ms; "
          f"K2 B={int(fail.sum())} order {osd_order}: {osd_ms:.3f} ms vs plain "
          f"{osd_plain_ms:.3f} ms {tag}")

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

    kernels = [
        {"name": "bp_flood", "route": "cuda", "source": "bp_osd_tpu_torch/csrc/bp_flood.cu",
         "replaces": "bp_osd_tpu/ops/pallas_bp.py:140", "launches": launches["bp_flood"],
         "max_abs_err": bp_err, "ms": bp_ms, "plain_ms": bp_plain_ms},
        {"name": "osd_cs", "route": "cuda", "source": "bp_osd_tpu_torch/csrc/osd_cs.cu",
         "replaces": "bp_osd_tpu/ops/pallas_osd.py:135", "launches": launches["osd_cs"],
         "max_abs_err": osd_err, "ms": osd_ms, "plain_ms": osd_plain_ms},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
