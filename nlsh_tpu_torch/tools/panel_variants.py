"""Where the raw-panel kernel's time goes (K2, K4, K7).

    python3 -m nlsh_tpu_torch.tools.panel_variants   # from the repo root, one GPU

Builds ``csrc/grouped_scores.cu`` as it is and in variants that each
drop one part of the work: the ``cp.async`` copies (the loop multiplies
whatever shared memory holds), the stage barrier, the panel stores, the
query reads inside the 16-byte loop (hoisted out of it, so each stage
reuses one query float4 per slot), or the FMA loop itself.  Each variant
is a fixed edit of the source text, checked to apply, so an edit of the
kernel that breaks one fails here.  At the single table's K2 group table
(f32, as ``chip_smoke.py`` times it) it prints one JSON line per variant
with its time and f32 FMA rate (the padded d_pad counted, as the kernel
multiplies it; a variant's output is not the panel), then a
register-only FMA probe with the loop's operand pattern (16 slots x 4
rows of accumulators, 2 blocks of 128 threads per SM) and the SM clock
and power under the kernel.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

_ROWS = ("      cp_async16(dst + r * kRowStride + 16 * u, "
         "src + r * row_bytes + 16 * u);\n")
_QUERIES = ("      cp_async16(qdst + q * S::kFeat + 4 * u,\n"
            "                 qsrc + static_cast<size_t>(q) * d_pad + 4 * u);\n")
_NO_COPIES = [(_ROWS, ""), (_QUERIES, "")]
_NO_BARRIER = [
    ("    cp_async_wait<kStages - 2>();  // stage s has landed (this thread's)\n",
     ""),
    ("    __syncthreads();               // ... everyone's; stage s - 1 is free\n",
     "")]
_NO_STORES = [("__stcs(o + static_cast<size_t>(i) * br + r_step * j,\n"
                "                       acc[i][j]);",
               "if (acc[i][j] == -1.f) o[0] = 0.f;")]
_NO_QUERY_READS = [("qrow + i * kFeat + k);", "qrow + i * kFeat + 4 * sub);")]
VARIANTS = {
    "kernel": [],
    "no_fma": [("  for (int u = 0; u < kChunks; ++u) {",
                "  for (int u = 0; u < 0; ++u) {")],
    "no_copies": _NO_COPIES,
    "no_copies_barrier": _NO_COPIES + _NO_BARRIER,
    "no_copies_barrier_stores": _NO_COPIES + _NO_BARRIER + _NO_STORES,
    "no_copies_barrier_query_reads": _NO_COPIES + _NO_BARRIER
    + _NO_QUERY_READS,
}

_PROBE = r"""
extern "C" __global__ void probe(float* out, int n) {
  float acc[16][4], a[16], b[4];
  for (int i = 0; i < 16; ++i) a[i] = threadIdx.x * 1e-3f + i;
  for (int j = 0; j < 4; ++j) b[j] = 0.5f + j * 1e-3f;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_probe(float* out, int blocks, int n) {
  probe<<<blocks, 128>>>(out, n);
  return (int)cudaGetLastError();
}
"""


def build_variant(name: str, workdir: Path) -> ctypes.CDLL:
    """``grouped_scores.cu`` with ``VARIANTS[name]``'s edits, built with
    the port's flags in ``workdir``."""
    from nlsh_tpu_torch.ops.cuda import build

    src = (build.CSRC / "grouped_scores.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: the kernel no longer has "
                               f"{old.strip()!r}")
        src = src.replace(old, new)
    for hdr in build.CSRC.glob("*.cuh"):
        shutil.copy(hdr, workdir)
    cu = workdir / f"{name}.cu"
    cu.write_text(src)
    so = workdir / f"lib{name}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in build.SOURCES["grouped_scores.cu"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def probe_tflops(workdir: Path) -> float:
    """f32 rate of the register-only probe: 2 blocks of 128 threads per
    SM, 64 accumulators each, 20,000 sweeps."""
    import torch

    import chip_smoke as cs
    from nlsh_tpu_torch.ops.cuda import build

    cu = workdir / "probe.cu"
    cu.write_text(_PROBE)
    so = workdir / "libprobe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.run_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 128, device="cuda")
    n = 20000
    ms = cs.cuda_ms(lambda: lib.run_probe(out.data_ptr(), 2 * sms, n), 5)
    return 2.0 * 64 * n * 2 * sms * 128 / ms / 1e9


def smi_under(fn, seconds: float = 2.0) -> str:
    """``nvidia-smi``'s SM clock, power and temperature while ``fn`` runs
    in a loop."""
    import torch

    stop = threading.Event()

    def loop():
        while not stop.is_set():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()

    th = threading.Thread(target=loop)
    th.start()
    time.sleep(seconds)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    stop.set()
    th.join()
    return out


def main() -> int:
    import numpy as np
    import torch

    import bench
    import chip_smoke as cs
    from nlsh_tpu_torch.ops.cuda import build
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    if not torch.cuda.is_available():
        raise SystemExit("panel_variants: needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    corpus, queries = bench.glove100_workload(np.random.default_rng(bench.SEED))
    idx = cs.phase_index(corpus)
    lay = idx.layout
    q, pid, pv = cs._probes(idx, queries)
    g_total = qk._round_up(qk.grouped_static_bound(
        pid.numel(), lay.cap // lay.br, lay.total_blocks, 32), qk._GROUP_EB)
    grp_block, grp_qvecs, *_ = qk._grouped_prep_v2(
        lay.starts, lay.counts, pid, pv, qk.extend_queries(lay, q), lay.cap,
        g_total=g_total, max_blocks=lay.cap // lay.br, group_q=32,
        block_rows=lay.br)
    data, br = lay.data, lay.br
    G, d_pad = grp_qvecs.shape[1:]
    flops = 2.0 * g_total * G * br * d_pad
    out = torch.empty(g_total, G, br, device="cuda")

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        workdir = Path(tmp)
        for name in VARIANTS:
            lib = build_variant(name, workdir)

            def launch():
                with torch.cuda.device(data.device):
                    err = lib.nlsh_grouped_scores(
                        qk._DTYPE_CODE[data.dtype], qk._ptr(grp_qvecs),
                        qk._ptr(data), qk._ptr(grp_block), qk._ptr(out),
                        g_total, G, d_pad, br, data.shape[0] // br,
                        G * d_pad, qk._stream(data.device))
                qk._raise_on(err, name)

            ms = cs.cuda_ms(launch, 20)
            row = {"variant": name, "g_total": g_total, "ms": ms,
                   "f32_tflops": flops / ms / 1e9}
            if name == "kernel":
                row["smi_under_load"] = smi_under(launch)
            print(json.dumps(row), flush=True)
        print(json.dumps({"probe": "register-only 16 x 4 FMA tile",
                          "f32_tflops": probe_tflops(workdir)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
