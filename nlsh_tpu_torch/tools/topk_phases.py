"""Where the fused top-k kernel's time goes (K1 and K3).

    python3 -m nlsh_tpu_torch.tools.topk_phases   # from the repo root, one GPU

Builds ``csrc/grouped_topk.cu`` once more with ``-DNLSH_TOPK_PHASES``:
``clock64`` counters around the kernel's phases, which the port's own
build compiles out.  At the main path's shapes (K1 at the single table's
grouped prep, K3 at the L=8 ensemble's calibrated windowed prep, f32,
k = 10, as ``chip_smoke.py`` times them) it prints one JSON line per
kernel: the port's kernel time, the instrumented kernel's time with and
without the per-tile selection (without it the output is not the top-k;
only the time counts), and each phase's share of all warps' cycles
(``wait``: the stage barrier; ``issue``: queueing the next stage's
copies; ``compute``: the FMA loop; ``select``: the tile's scale, norms,
mask and selection; ``final``: the group's ranked output; ``head``: a
group's start, its barriers included; ``other``: the rest).  Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

PHASES = ("wait", "issue", "compute", "select", "final", "head")


def build_library() -> ctypes.CDLL:
    """``grouped_topk.cu`` with its phase counters, built next to the
    port's libraries (rebuilt when the source's hash changes)."""
    from nlsh_tpu_torch.ops.cuda import build

    path = build.library_path("grouped_topk.cu")
    path = path.with_name(path.name.replace("grouped_topk",
                                            "grouped_topk_phases"))
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-DNLSH_TOPK_PHASES", "-o",
             str(tmp), str(build.CSRC / "grouped_topk.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the phase build:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in build.SOURCES["grouped_topk.cu"].items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.nlsh_topk_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nlsh_topk_phases.restype = ctypes.c_int
    return lib


def launch(lib, data, qvecs, block, lo, hi, kk: int, br: int, norms=None,
           scale_rows=None):
    """K1 (``lo`` None, ``hi`` the counts) or K3 from the phase build, on
    CUDA tensors the port's wrappers take; returns ``(scores, lanes)``."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    g_total, G, d_pad = qvecs.shape
    with torch.cuda.device(data.device):  # the launch's device is current
        scores = torch.empty(g_total, G, kk, device=data.device)
        lanes = torch.empty(g_total, G, kk, dtype=torch.int32,
                            device=data.device)
        tail = (qk._ptr(norms), qk._ptr(scale_rows), qk._ptr(scores),
                qk._ptr(lanes), g_total, G, d_pad, br, data.shape[0] // br,
                kk, qk._stream(data.device))
        head = (qk._DTYPE_CODE[data.dtype], qk._ptr(qvecs), qk._ptr(data),
                qk._ptr(block))
        if lo is None:
            err = lib.nlsh_grouped_scores_topk(*head, qk._ptr(hi), *tail)
        else:
            err = lib.nlsh_windowed_scores_topk(*head, qk._ptr(lo),
                                                qk._ptr(hi), *tail)
    qk._raise_on(err, "the phase build's launch")
    return scores, lanes


def read_phases(lib, skip_select: bool = False) -> dict:
    """The cycle sums since the last read (zeroed by reading), by phase,
    with ``all`` the warps' whole time; sets whether later launches skip
    the selection."""
    import torch

    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    err = lib.nlsh_topk_phases(out, int(skip_select))
    if err:
        raise RuntimeError(f"reading the phase counters: CUDA error {err}")
    return dict(zip(PHASES + ("all",), (int(v) for v in out)))


def shares(cycles: dict) -> dict:
    """Each phase's share of all warps' cycles, and ``other`` the rest."""
    out = {k: cycles[k] / cycles["all"] for k in PHASES}
    out["other"] = 1.0 - sum(out.values())
    return out


def main() -> int:
    import numpy as np
    import torch

    import bench
    import chip_smoke as cs
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk
    from nlsh_tpu_torch.parallel import MultiTableIndexer

    if not torch.cuda.is_available():
        raise SystemExit("topk_phases: needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = build_library()

    corpus, queries = bench.glove100_workload(np.random.default_rng(bench.SEED))
    idx = cs.phase_index(corpus)
    lay = idx.layout
    q, pid, pv = cs._probes(idx, queries)
    g1 = qk._round_up(qk.grouped_static_bound(
        pid.numel(), lay.cap // lay.br, lay.total_blocks, 32), qk._GROUP_EB)
    gb, gq, gc, *_ = qk._grouped_prep_v2(
        lay.starts, lay.counts, pid, pv, qk.extend_queries(lay, q), lay.cap,
        g_total=g1, max_blocks=lay.cap // lay.br, group_q=32,
        block_rows=lay.br)
    k1 = (lay.data, gq, gb, None, gc), lay.br
    del idx
    midx = MultiTableIndexer(cs.load_ensemble(), corpus, metric="cosine",
                             device="cuda")
    midx.calibrate(queries, hash_times=cs.MT_HASH_TIMES, probe_mode="flip")
    el = midx._serving_layout()
    gp, gv = cs._flat_probes(midx, queries)
    gw, gq3, glo, ghi, *_ = qk._windowed_prep(
        el.starts, el.counts, gp, gv,
        qk.extend_queries(el, torch.as_tensor(queries, device="cuda")),
        el.cap, g_total=midx._g_cal, max_sub=el.cap // el.br + 1,
        group_q=qk.GROUP_W, block_rows=el.br)
    k3 = (el.data, gq3, gw, glo, ghi), el.br

    for name, (args, br), kernel in (
            ("grouped_scores_topk", k1, qk.grouped_scores_topk),
            ("windowed_scores_topk", k3, qk.windowed_scores_topk)):
        data, qv, blk, lo, hi = args
        extra = (hi,) if lo is None else (lo, hi)
        out = {"kernel": name, "g_total": int(qv.shape[0]),
               "ms": cs.cuda_ms(lambda: kernel(data, qv, blk, *extra, cs.K,
                                               block_rows=br), 20)}
        read_phases(lib)
        out["instrumented_ms"] = cs.cuda_ms(
            lambda: launch(lib, *args, cs.K, br), 20)
        read_phases(lib, skip_select=True)
        out["no_select_ms"] = cs.cuda_ms(
            lambda: launch(lib, *args, cs.K, br), 20)
        read_phases(lib)  # clears, selection back on
        launch(lib, *args, cs.K, br)
        out["phase_share"] = shares(read_phases(lib))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
