"""bp_osd_tpu_torch: import surface, one-way layering, backend selection, and no
fallbacks."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bp_osd_tpu_torch import BpOsdDecoder
from bp_osd_tpu_torch.codes import hamming_code, hgp, rep_code
from bp_osd_tpu_torch.decoder.bp import as_syndromes, bp_decode, llr_from_channel
from bp_osd_tpu_torch.decoder.lifted_bp import LiftedGraph
from bp_osd_tpu_torch.decoder.osd import build_osd_consts, osd_decode
from bp_osd_tpu_torch.decoder.tanner import TannerGraph, resolve_backend
from bp_osd_tpu_torch.ops import _build
from bp_osd_tpu_torch.utils.measure import wrappers

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "bp_osd_tpu_torch")


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import bp_osd_tpu_torch, bp_osd_tpu_torch.codes, bp_osd_tpu_torch.decoder\n"
        "import bp_osd_tpu_torch.ops.cuda_bp, bp_osd_tpu_torch.ops.cuda_osd\n"
        "import bp_osd_tpu_torch.sim, bp_osd_tpu_torch.decoder.layered, bp_osd_tpu_torch.utils\n"
        "from bp_osd_tpu_torch.examples import (large_hgp_ler, lifted_product_ler,\n"
        "                                       qldpc_decode_example, threshold_sweep)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'bp_osd_tpu.'))"
        " or m == 'bp_osd_tpu']\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import bp_osd_tpu\b|from bp_osd_tpu\b[^_])",
                     re.M)
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_ops_import_only_graph_types_from_decoder():
    """The layering is one-way: no module under ``ops/`` imports from
    ``decoder/`` anything but the graph types and the ``Elimination``
    record, at module level or inside a function, and none names a plain
    version."""
    allowed = {"TannerGraph", "LiftedGraph", "Elimination"}
    banned = re.compile(r"_plain$|^_bp_rows$|^normalize_bp_method$")
    ops = os.path.join(PKG, "ops")
    for f in sorted(os.listdir(ops)):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ops, f)) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert not any(".decoder" in a.name for a in node.names), f
            elif isinstance(node, ast.ImportFrom):
                names = {a.name for a in node.names}
                mod = node.module or ""
                if node.level == 2 and not mod:
                    assert "decoder" not in names, f
                if (node.level == 2 and mod.split(".")[0] == "decoder"
                        or mod.startswith("bp_osd_tpu_torch.decoder")):
                    assert names <= allowed, (f, names - allowed)
            name = (node.id if isinstance(node, ast.Name) else
                    node.attr if isinstance(node, ast.Attribute) else None)
            assert name is None or not banned.search(name), (f, name)


@pytest.mark.parametrize("name", ["bp_flood", "eliminate", "osd_cs", "osd_e", "osd_large",
                                  "bp_lifted"])
def test_wrappers_refuse_cpu_tensors(name, monkeypatch):
    """Each kernel wrapper takes CUDA tensors only: valid CPU inputs raise
    ``ValueError`` naming CUDA before anything is built, launched or
    counted (``decoder/`` runs the plain versions on them)."""
    g = TannerGraph(hgp(rep_code(3), rep_code(3)).hz.toarray(), device="cpu")
    lg = LiftedGraph([[(0,), (0,)], [(0,), (1,)]], 3, device="cpu")
    B = 4
    synd = torch.zeros(B, g.m, dtype=torch.uint8)
    perm = torch.arange(g.n, dtype=torch.int32).repeat(B, 1)
    pairs = build_osd_consts(g, "osd_cs", 3).pairs
    calls = {
        "bp_flood": lambda w: w(g, synd, torch.zeros(B, g.n), method="minimum_sum",
                                max_iter=5, ms_scaling_factor=0.625),
        "eliminate": lambda w: w(g, perm, synd),
        "osd_cs": lambda w: w(g, perm, synd, osd_order=3, pairs=pairs),
        "osd_e": lambda w: w(g, perm, synd, osd_order=3),
        "osd_large": lambda w: w(g, perm, synd, osd_order=3, pairs=pairs),
        "bp_lifted": lambda w: w(lg, torch.zeros(B, lg.m, dtype=torch.uint8),
                                 torch.zeros(B, lg.n), "minimum_sum", 5, 0.625),
    }

    def no_build():
        raise AssertionError("a wrapper built the kernels for CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    wrapper = wrappers()[name]
    before = (wrapper.launches, dict(wrapper.launches_on))
    with pytest.raises(ValueError, match="CUDA"):
        calls[name](wrapper)
    assert (wrapper.launches, dict(wrapper.launches_on)) == before
    if name == "eliminate":
        with pytest.raises(ValueError, match="placement"):
            wrapper(g, perm, synd, placement="l2")


@pytest.mark.parametrize("backend,device,want", [
    ("auto", "cpu", "torch"),
    ("torch", "cpu", "torch"),
    ("cuda", "cpu", RuntimeError),
    ("auto", "cuda", "cuda"),
    ("cuda", "cuda", "cuda"),
    ("torch", "cuda", ValueError),
    ("xla", "cpu", ValueError),
])
def test_resolve_backend(backend, device, want):
    if isinstance(want, str):
        assert resolve_backend(backend, device) == want
    else:
        with pytest.raises(want):
            resolve_backend(backend, device)


def test_backend_cuda_without_card_raises(monkeypatch):
    H = hgp(rep_code(3), rep_code(3)).hz.toarray()
    g = TannerGraph(H, device="cpu")
    synd = np.zeros((2, g.m), np.uint8)
    llr0 = llr_from_channel(np.full(g.n, 0.05))
    with pytest.raises(RuntimeError, match="cuda"):
        bp_decode(g, synd, llr0, backend="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        osd_decode(g, synd, np.zeros((2, g.n), np.float32), osd_method="osd_cs",
                   osd_order=2, backend="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        BpOsdDecoder(H, error_rate=0.05, backend="cuda")
    assert BpOsdDecoder(H, error_rate=0.05).device.type == "cpu"


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    _build.load.cache_clear()
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build()
    with pytest.raises(_build.KernelBuildError):
        _build.load()


def test_float_syndromes_rejected_not_truncated():
    H = hamming_code(3).toarray()
    with pytest.raises(ValueError, match="0 or 1"):
        as_syndromes(np.array([[0.9, 0.0, 1.0]]), 3, "cpu")
    with pytest.raises(ValueError, match="0 or 1"):
        as_syndromes(np.array([[2, 0, 1]]), 3, "cpu")
    exact = as_syndromes(np.array([[1.0, 0.0, 1.0]]), 3, "cpu")
    assert exact.dtype == torch.uint8 and exact.tolist() == [[1, 0, 1]]
    dec = BpOsdDecoder(H, error_rate=0.05, osd_method="osd_cs", osd_order=2)
    with pytest.raises(ValueError, match="0 or 1"):
        dec.decode(np.array([0.9, 0.0, 0.0]))
    e = np.zeros(7, np.uint8)
    e[3] = 1
    assert np.array_equal(dec.decode((H @ e % 2).astype(np.float32)), e)
