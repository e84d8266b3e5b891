"""Build the port's CUDA sources into shared libraries and load them.

The kernels in ``nlsh_tpu_torch/csrc`` (and ``graph_cond.cu``, the
conditional nodes of a captured graph, and ``spans.cu``, a serve's layer
marks) have a plain C interface, so they
compile with ``nvcc`` alone (no PyTorch headers, a few seconds each) and
bind with ``ctypes``.  :func:`load_library` builds on first use into
``build/nlsh_tpu_torch/`` next to the package: one library per source,
all sources compiled at once by parallel ``nvcc`` processes, each named
by a hash of its source, the shared headers and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "nlsh_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# source -> {name: argtypes} of its extern "C" entry points; all return
# cudaError_t
SOURCES = {
    "grouped_topk.cu": {
        # dtype, qvecs, data, grp_block, grp_cnt, norms, scale, out_scores,
        # out_lanes, g_total, G, d_pad, br, n_blocks, kk, stream
        "nlsh_grouped_scores_topk": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _P],
        # dtype, qvecs, data, grp_window, grp_lo, grp_hi, norms, scale,
        # out_scores, out_lanes, g_total, G, d_pad, br, n_windows, kk, stream
        "nlsh_windowed_scores_topk": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _I, _I, _I, _I, _I, _I, _P],
        # dtype, windowed, d_pad, out int* (resident blocks per SM)
        "nlsh_topk_blocks_per_sm": [_I, _I, _I, _P],
    },
    "grouped_scores.cu": {
        # dtype, qvecs, data, grp_block, out, g_total, G, d_pad, br,
        # n_blocks, q_stride, stream (K2, K4 on a window table, K7 on int8
        # blocks with q_stride 0)
        "nlsh_grouped_scores": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P],
        # dtype, d_pad, out int* (resident blocks per SM)
        "nlsh_panel_blocks_per_sm": [_I, _I, _P],
    },
    "bucket_scores.cu": {
        # dtype, queries, data, order, first, counts, out, n_events,
        # n_probes, cap, d_pad, n_rows, stream (K5 and K6: the events
        # sorted by first row, and their first rows and counts so sorted)
        "nlsh_bucket_scores": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _P],
        # dtype, out int* (resident blocks per SM)
        "nlsh_bucket_blocks_per_sm": [_I, _P],
    },
    "graph_cond.cu": {
        # stream, pred (a device bool), out unsigned long long[2]: the
        # handles set to pred and to !pred
        "nlsh_cond_handles": [_P, _P, _P],
        # stream, handle, body stream: an IF node, body captured on body
        "nlsh_cond_begin": [_P, ctypes.c_ulonglong, _P],
        # body stream, out unsigned long long*: the body graph's nodes
        "nlsh_cond_end": [_P, _P],
        # out cudaStream_t*: a non-blocking stream for the bodies
        "nlsh_cond_stream": [_P],
        # stream, out unsigned long long*: the nodes of the graph the
        # stream captures into
        "nlsh_graph_nodes": [_P, _P],
    },
    "panel_topk.cu": {
        # scores, grp_block, grp_lo, grp_hi, norms, scale, out_scores,
        # out_lanes, g_total, G, br, n_blocks, kk, stream (K8)
        "nlsh_panel_topk": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _P],
    },
    "spans.cu": {
        # which (1 hash, 2 prep, 3 score, 4 merge, 5 end, 6 bound),
        # accumulator (int64[SPAN_SLOTS]), stream
        "nlsh_span": [_I, _P, _P],
    },
}

_lib: SimpleNamespace | None = None
build_seconds: float | None = None  # wall time of the last nvcc run
build_log: str = ""                 # nvcc's output (-Xptxas -v) of it


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library of the same hash is missing,
    one ``nvcc`` per source, all started together; returns each
    source's library."""
    global build_seconds, build_log
    out = {s: library_path(s) for s in SOURCES}
    todo = [s for s, path in out.items() if not path.exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    try:
        for s in todo:
            # compile to a private name, then rename: a concurrent process
            # never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((s, tmp, proc))
        logs, failed = [], []
        for s, tmp, proc in jobs:
            log = proc.communicate()[0]
            logs.append(f"== {s}\n{log}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {s} ({proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out[s])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return out


def load_library() -> SimpleNamespace:
    """The kernels' entry points, from libraries built if needed, with
    their argument types set."""
    global _lib
    if _lib is None:
        fns = {}
        for source, path in build().items():
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SOURCES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
        _lib = SimpleNamespace(**fns)
    return _lib
