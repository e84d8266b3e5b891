"""Build the port's CUDA sources into a shared library and load it.

The kernels in ``nlsh_tpu_torch/csrc`` have a plain C interface, so they
compile with ``nvcc`` alone (no PyTorch headers, a few seconds) and bind
with ``ctypes``.  :func:`load_library` builds on first use into
``build/nlsh_tpu_torch/`` next to the package, naming the library by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "nlsh_tpu_torch"
SOURCES = ("grouped_scores.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of each extern "C" entry point; all return cudaError_t
ENTRY_POINTS = {
    # dtype, qvecs, data, grp_block, grp_cnt, norms, scale, out_scores,
    # out_lanes, g_total, G, d_pad, br, n_blocks, kk, stream
    "nlsh_grouped_scores_topk": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _P],
    # dtype, qvecs, data, grp_window, grp_lo, grp_hi, norms, scale,
    # out_scores, out_lanes, g_total, G, d_pad, br, n_windows, kk, stream
    "nlsh_windowed_scores_topk": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P],
    # dtype, qvecs, data, grp_block, out, g_total, G, d_pad, br,
    # n_blocks, stream (K2, and K4 on a window table)
    "nlsh_grouped_scores": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last nvcc run
build_log: str = ""                 # nvcc's output (-Xptxas -v) of it


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnlsh_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' library, built if needed, with typed entry points."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
