"""Build the CUDA kernels in ``bp_osd_tpu_torch/csrc`` and load them.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a`` (all
in parallel) and linked into one shared library with a plain C interface,
loaded with ``ctypes``.  The build
runs on first use, from the package's own sources only, into
``bp_osd_tpu_torch/_build/``, and is cached there by a hash of the sources,
the headers they share (``csrc/*.cuh``) and the flags.  ``nvcc`` is found through ``CUDA_HOME`` or ``PATH``.  A failed or
impossible build raises :class:`KernelBuildError` with the compiler's
output; nothing falls back to the plain torch versions.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["KernelBuildError", "NVCC_FLAGS", "build", "find_nvcc", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# shards on several cards may ask for the library at once, and one process
# compiles into one work directory
_BUILD_LOCK = threading.Lock()

# --fmad=false: no multiply-add contraction, so float results round exactly
# as the plain torch versions' separate multiplies and adds do
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the first on ``PATH``."""
    home = os.environ.get("CUDA_HOME")
    if home:
        path = os.path.join(home, "bin", "nvcc")
        if os.access(path, os.X_OK):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels cannot be built and nothing falls back to torch"
        )
    return path


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def build() -> tuple[str, str]:
    """Compile the kernels if no build of these sources exists yet.

    Each source is compiled by its own ``nvcc``, all started together, and
    the objects are linked into one shared library.  Returns ``(path of the
    shared library, compiler output)``; the output is empty when the cached
    library was reused.
    """
    with _BUILD_LOCK:
        return _build()


def _build() -> tuple[str, str]:
    nvcc = find_nvcc()
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + _headers():
        with open(src, "rb") as f:
            digest.update(f.read())
    so_path = os.path.join(BUILD_DIR, f"libbp_osd_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path, ""
    work = os.path.join(BUILD_DIR, f"objs.{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    jobs = []
    for src in sources:
        obj = os.path.join(work, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    log = []
    try:
        for cmd, _, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            log.append(out + err)
    finally:
        for _, _, proc in jobs:  # a failed build stops the other compilers
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp,
           *(obj for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so_path)
    shutil.rmtree(work, ignore_errors=True)
    return so_path, "".join(log)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built kernel library, with every entry point's ctypes signature."""
    so_path, _ = build()
    lib = ctypes.CDLL(so_path)
    P, I, LL, F, SZ = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_size_t)
    lib.bp_flood_launch.argtypes = [P, P, LL, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                                    I, I, I, I, I, I, I, I, F, I, P, ctypes.POINTER(I)]
    lib.bp_flood_launch.restype = I
    lib.bp_flood_smem_bytes.argtypes = [I, I, I, I]
    lib.bp_flood_smem_bytes.restype = SZ
    lib.bp_flood_scratch_words.argtypes = [I, I, I]
    lib.bp_flood_scratch_words.restype = SZ
    lib.bp_flood_table_bytes.argtypes = [I, I, I, I]
    lib.bp_flood_table_bytes.restype = SZ
    lib.bp_flood_team_bytes.argtypes = [I, I, I, I]
    lib.bp_flood_team_bytes.restype = SZ
    lib.bp_flood_plan.argtypes = [I, I, I, I, I, I, I, ctypes.POINTER(I)]
    lib.bp_flood_plan.restype = I
    lib.osd_cs_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
    lib.osd_cs_launch.restype = I
    lib.osd_e_launch.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
    lib.osd_e_launch.restype = I
    lib.gf2_elim_launch.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
    lib.gf2_elim_launch.restype = I
    lib.gf2_elim_smem_bytes.argtypes = [I, I, I]
    lib.gf2_elim_smem_bytes.restype = SZ
    lib.osd_cs_warp_smem_bytes.argtypes = [I, I, I, I]
    lib.osd_cs_warp_smem_bytes.restype = SZ
    lib.osd_cs_plan.argtypes = [I, I, I, I, I, ctypes.POINTER(I)]
    lib.osd_cs_plan.restype = I
    lib.gf2_elim_warp_launch.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, P]
    lib.gf2_elim_warp_launch.restype = I
    lib.gf2_elim_warp_smem_bytes.argtypes = [I, I, I]
    lib.gf2_elim_warp_smem_bytes.restype = SZ
    lib.osd_large_launch.argtypes = [P, P, P, P, P, P, P, P,
                                     I, I, I, I, I, I, I, I, I, I, I, P, P]
    lib.osd_large_launch.restype = I
    lib.osd_large_smem_bytes.argtypes = [I, I, I, I]
    lib.osd_large_smem_bytes.restype = SZ
    lib.osd_large_plan.argtypes = [I, I, I, I, ctypes.POINTER(I)]
    lib.osd_large_plan.restype = I
    lib.osd_large_clusters.argtypes = [I, I, I, I, I, ctypes.POINTER(I)]
    lib.osd_large_clusters.restype = I
    lib.bp_lifted_launch.argtypes = [P, P, LL, P, P, P, P, P, P, P, P,
                                     I, I, I, I, I, I, I, I, I, I, I, F, P]
    lib.bp_lifted_launch.restype = I
    lib.bp_lifted_smem_bytes.argtypes = [I, I, I, I, I, I, I]
    lib.bp_lifted_smem_bytes.restype = SZ
    lib.bp_lifted_plan.argtypes = [I, I, I, I, I, I, I, I, I, ctypes.POINTER(I)]
    lib.bp_lifted_plan.restype = I
    return lib
