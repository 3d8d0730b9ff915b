"""The port's ``generate_hgp_codes`` example against the root script.

``examples/generate_hgp_codes.py`` (the JAX package's) is loaded by path,
and both generators write their four matrices for the same seeds into two
temporary directories: the files must be equal byte for byte, and so must
the line each prints but for the directory.
"""

import importlib.util
import os

import pytest

from bp_osd_tpu.codes import hamming_code as jhamming_code
from bp_osd_tpu.codes import mkmn_16_4_6 as jmkmn_16_4_6

from bp_osd_tpu_torch.codes import hamming_code
from bp_osd_tpu_torch.examples import generate_hgp_codes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("hx", "hz", "lx", "lz")


def _jax_example():
    path = os.path.join(ROOT, "examples", "generate_hgp_codes.py")
    spec = importlib.util.spec_from_file_location("jax_generate_hgp_codes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(out_dir, params):
    out = {}
    for name in FILES:
        with open(os.path.join(out_dir, f"hgp_{params}_{name}.txt"), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("seed", ["mkmn_16_4_6", "hamming_code(3)"])
def test_generate_writes_the_jax_files(seed, tmp_path, monkeypatch, capsys):
    """Both generators on one seed: the same code, the same four files and
    the same line.  The [[400,16,6]] seed goes through the port's command
    line with its default output directory, in the working directory."""
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jseed = jmkmn_16_4_6() if seed == "mkmn_16_4_6" else jhamming_code(3)
    ref = _jax_example().generate(jseed, out_dir=jax_dir)
    jax_line = capsys.readouterr().out
    if seed == "mkmn_16_4_6":
        os.mkdir(port_dir)
        monkeypatch.chdir(port_dir)
        mine = generate_hgp_codes.main([])
        out_dir = generate_hgp_codes.OUT_DIR
        port_dir = os.path.join(port_dir, out_dir)
        assert mine.code_params == "(4,7)-[[400,16,6]]"
    else:
        mine = generate_hgp_codes.generate(hamming_code(3), out_dir=port_dir)
        out_dir = port_dir
    assert mine.code_params == ref.code_params
    assert jax_line == f"saved {ref.code_params} to {jax_dir}\n"
    assert capsys.readouterr().out == f"saved {mine.code_params} to {out_dir}\n"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == sorted(
        f"hgp_{ref.code_params}_{name}.txt" for name in FILES)
    assert _files(port_dir, mine.code_params) == _files(jax_dir, ref.code_params)
