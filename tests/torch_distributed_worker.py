"""Worker of the two-process test (tests/test_torch_distributed.py) of
bp_osd_tpu_torch.parallel: one gloo rank on the CPU, with a mesh of 2 CPU
shards, so the two ranks hold 4 shards together.  It imports torch and never
jax.

    python tests/torch_distributed_worker.py RANK WORLD PORT OUT_DIR

Each rank decodes its ``host_batch_slice`` of a batch that every rank makes
from the same seed, reduces its counts over the group, and checks them
against one process decoding the whole batch; then it runs the harness with
``use_mesh=1`` and prints its counters.
"""

import json
import os
import sys

import numpy as np
import torch

_COUNTERS = ("run_count", "bp_converge_count_x", "bp_converge_count_z", "bp_success_count",
             "osd0_success_count", "osdw_success_count", "min_logical_weight")


def main():
    pid, nproc, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)

    from bp_osd_tpu_torch.codes import hgp, rep_code
    from bp_osd_tpu_torch.decoder import TannerGraph, bp_decode, llr_from_channel
    from bp_osd_tpu_torch.decoder.osd import build_osd_consts
    from bp_osd_tpu_torch.decoder.pipeline import decode_pipeline
    from bp_osd_tpu_torch.parallel import (cpu_mesh, host_batch_slice, initialize,
                                           is_multi_host, sharded_decode_fn)
    from bp_osd_tpu_torch.parallel.distributed import process_count, reduce_batch_counts
    from bp_osd_tpu_torch.sim import css_decode_sim

    assert initialize(f"127.0.0.1:{port}", nproc, pid), "initialize failed"
    assert initialize() is True  # a second call finds the group up
    assert is_multi_host() and process_count() == nproc

    qcode = hgp(rep_code(3), rep_code(3))
    H = np.asarray(qcode.hx.toarray(), np.uint8)
    graph = TannerGraph(H, device="cpu")
    n, B, p = graph.n, 32, 0.1
    # the same seed on every rank: the same global batch
    rng = np.random.default_rng(7)
    errors = (rng.random((B, n)) < p).astype(np.uint8)
    synd = (errors @ H.T % 2).astype(np.uint8)
    llr0 = llr_from_channel(np.full(n, p)).expand(B, n)
    start, size = host_batch_slice(B)
    assert (start, size) == (pid * B // nproc, B // nproc), (start, size)
    rows = slice(start, start + size)
    bp_kw = dict(bp_method="minimum_sum", max_iter=13, ms_scaling_factor=0.625)

    # BP convergence, reduced over the ranks, against one process
    decode = sharded_decode_fn(graph, cpu_mesh(2), osd_method="osd_cs", osd_order=4, **bp_kw)
    osdw, _, _, conv = decode(synd[rows], llr0[rows])
    (got,), _ = reduce_batch_counts([int(conv.sum())], 0)
    expect = int(bp_decode(graph, synd, llr0, **bp_kw).converged.sum())
    assert got == expect, (got, expect)
    print(f"WORKER_OK pid={pid} converged={got}/{B}", flush=True)

    # BP+OSD and the logical statistics, each reduced over the ranks
    lz = torch.as_tensor(qcode.lz.toarray(), dtype=torch.float32)

    def stats(out, err):
        resid = (out.to(torch.float32) + torch.as_tensor(err, dtype=torch.float32)) % 2
        fails = ((resid @ lz.T) % 2 == 1).any(1)
        return [int(fails.sum()), int(out.sum())]

    local = stats(osdw, errors[rows]) + [int(conv.sum())]
    (fails, weight, conv2), lightest = reduce_batch_counts(local, int(osdw.sum(1).min()))
    ref = decode_pipeline(graph, synd, llr0, osd_method="osd_cs", osd_order=4,
                          consts=build_osd_consts(graph, "osd_cs", 4), **bp_kw)
    assert [fails, weight, conv2] == stats(ref.osdw, errors) + [int(ref.converged.sum())]
    assert lightest == int(ref.osdw.sum(1).min())
    print(f"WORKER_OK2 pid={pid} fails={fails}/{B} weight={weight}", flush=True)

    # the harness: every rank holds the reduced totals, rank 0 writes the file
    counters = {}
    for target in (64, 70):
        sim = css_decode_sim(
            hx=qcode.hx, hz=qcode.hz, error_rate=0.08, target_runs=target, batch_size=32,
            xyz_error_bias=[1, 1, 1], bp_method="ms", ms_scaling_factor=0.625,
            osd_method="osd_cs", osd_order=3, max_iter=10, seed=5, use_mesh=1,
            mesh=cpu_mesh(2), backend="torch", tqdm_disable=1,
            output_file=os.path.join(out_dir, f"sim_{target}_rank{pid}.json"))
        assert sim.batch_size == 32 and sim.use_mesh == 1
        counters[target] = {k: getattr(sim, k) for k in _COUNTERS}
    # with several processes use_mesh=-1 takes the mesh, each rank on its own device
    auto = css_decode_sim(hx=qcode.hx, hz=qcode.hz, error_rate=0.08, target_runs=64,
                          batch_size=31, run_sim=0, backend="torch", tqdm_disable=1)
    assert (auto.use_mesh, auto.batch_size, auto._device.type) == (1, 32, "cpu")
    assert "jax" not in sys.modules
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK3 pid={pid} {json.dumps(counters, sort_keys=True)}", flush=True)


if __name__ == "__main__":
    main()
