#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths once on one GPU and check them.

    python3 chip_smoke.py            # from the repo root, on a CUDA machine
    python3 chip_smoke.py --profile  # also profile the fixed-cap and the
                                     # ensemble serve, 3 passes each

Phases, one JSON line each: the device (and the ``nvidia-smi`` name and
power limit line), the kernel build (one ``nvcc`` per source, in
parallel), K1-K4 and K5/K6 against their plain PyTorch versions on
synthetic operands (f32, bf16 and int8 corpora), K7 (the int8 block
probe) on the probe's own operands, then two paths on the bench workload
(1,183,514 x 100 from ``bench.glove100_workload`` with seed 0, 10,000
queries, recall@10 against the committed exact ground truth):

* the single table (the committed trained params, 16 flip probes, cap
  512): index build, the serve through ``Indexer.query`` on the grouped
  engine (K1 at k=10, K2 at k=20; QPS), kernel times, engine parity, the
  same serve on the windowed engine (K3 at k=10, K4 at k=20), on the
  fixed-cap engine (K5; QPS, with K5/K6 times on the serve's own
  events: the whole wrapper call, of which ``grouping_ms`` sorts the
  events and ``kernel_ms`` is the launch; K5's live lanes bitwise equal
  to K2's panel; and K5 at a table of 16 random distinct buckets per
  query), and on the per-row int8 layout (grouped K1, fixed-cap K5,
  windowed K3, then one global-scale grouped serve; QPS and the int8
  times of K1-K4);
* the L=8 ensemble (the committed 8-table params, 4 flip probes per
  table): ``MultiTableIndexer`` build, ``calibrate`` and the serve on the
  windowed engine (K3; recall, summed and exact candidates, QPS, all
  with the batch's own calibration), K3/K4 times at the ensemble's group
  tables, parity against the plain scorer and the grouped and gather
  engines, and the guard: after a starved calibration the same batch
  takes the static group bound and answers exactly as before.

Then the serving process, on the same workload, each phase one line:

* ``artifact``: the committed params written as model artifacts with the
  port's ``save_model`` (single table, and 8 tables with ``n_tables``)
  and loaded back: the loaded modules hash the corpus to the same ids;
* ``persist``: ``Indexer.save`` / ``load`` and ``MultiTableIndexer.save``
  / ``load``: CSR arrays bitwise, no ``hash_corpus`` call on the load,
  ids and candidates equal to the first serve's, recall in its window,
  ``build_s`` beside ``load_s`` and the file's bytes; a corpus with one
  tail row changed is refused;
* ``host_layout``: ``layout_mode="host"`` (numpy) against the layout
  built on the card, f32 and per-row int8, with both build times;
* ``ensemble_fixed`` and ``ensemble_int8``: the ensemble on the fixed-cap
  engine (K5 from a new caller) and on the per-row int8 stacked layout
  (K3), with the layouts' GiB;
* ``updates``: 10,000 rows held back and added, 1,000 ids removed (the
  serve then fetches k + 1,024 per query and runs K2, not K1), the
  answers held to the plain serve and the gather engine, then
  ``compact`` against an index built from scratch; pass times with the
  buffer, with tombstones and after ``compact``;
* ``heads``: a Categorical and a product-quantisation head with seeded
  weights at the bench width over the first 262,144 rows, grouped
  against gather; PQ flip probes distinct at 16 and 256 probes;
* ``serve_cli``: ``nlsh_tpu_torch.cli.serve.main`` on the synthetic
  dataset (build and save, then restore: the same answers), and
  ``serve_loop`` on the restored full-size index with 200 requests and a
  malformed line; its ``stats`` (QPS, latency p50 / p95 / max).

Each path's launch counts are set to 0 just before it and read just
after; every kernel must have launched on the path that runs it (K1, K2:
the grouped serve; K3: the ensemble serve; K4: the windowed serve at
k=20; K5: the fixed-cap serve; K6: the serve's events scored by row
offset, since the JAX package has no caller of it; K7: the int8 probe).
The serving-process phases reset and read the counts the same way; what
they launched is each kernel's ``new_callers`` in the ``kernels`` line.

Every kernel time comes with its plain version's, its bound and its
yardstick: ``bound_ms`` is the larger of the bytes the call must move
(each corpus row a live lane keeps, each query row and table once, each
output once) over 3.35 TB/s and its f32 operations over 67 TFLOP/s
(``nlsh_tpu_torch.ops.cuda.bounds``, counted from the call's own
inputs over the rows' real width: 100 features, not the 128 of the
padded layout), ``bound_by`` says which, ``bound_share`` is bound over
time; ``library_ms`` times one PyTorch call computing the same function
where there is one (``torch.bmm``/``matmul`` on blocks gathered
beforehand, for K2, K4 and K7), else it is null and ``library_note``
says why.  K7's row also carries its own and ``matmul``'s device time
(``torch.profiler`` device events), since at its size the event times
are the host's.  The resident blocks per SM of the fused top-k kernel
and of the raw-panel kernel are in ``kernel_times`` and
``ensemble_kernel_times``, where f32 K2's panel must also equal K1's
kept scores bit for bit at K1's lanes (and K4's K3's).  Then one
``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is non-zero and no result line is printed.  Needs no
network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "benchmarks", "artifacts", "bench_cache")
PARAMS = os.path.join(
    CACHE, "params_s0_n1183514_d100_q10000_k10_ts131072_v2_4da04f430c.msgpack")
GT = os.path.join(CACHE, "gt_s0_n1183514_d100_q10000_k10_ts131072_v2.npz")
PARAMS_T8 = os.path.join(
    CACHE, "cfgparams_mthr_glove100_b12_s600_b2048_t8_v2.msgpack")

K = 10
HASH_TIMES = 16
CAP = 512
RECALL_RANGE = (0.7416, 0.7436)      # exact-f32 JAX on the CPU: 0.74264
N_CAND_RANGE = (4665.0, 4676.0)      # exact-f32 JAX on the CPU: 4670.30
SCORE_TOL = 1e-5                     # kernel vs plain, unit-scale scores
TIE_TOL = 1e-6                       # lanes compared only off such ties
SLICE_ROWS, SLICE_QUERIES = 65_536, 512
DEVICE = "cuda"
# the L=8 ensemble at 4 flip probes per table; exact-f32 JAX on the CPU:
# recall@10 0.99211, summed candidates 9539.69, exact query_size 8881.76
MT_HASH_TIMES = 4
MT_RECALL_RANGE = (0.9911, 0.9931)
MT_N_CAND_RANGE = (9535.0, 9545.0)
MT_QUERY_SIZE_RANGE = (8877.0, 8887.0)
MT_GATHER_QUERIES = 1000
# the single table on the per-row int8 layout, grouped engine: the port's
# plain serve on the CPU gives 0.72406 (tests/test_torch_full.py)
INT8_RECALL_RANGE = (0.7231, 0.7251)
TOPK_SRC = "nlsh_tpu_torch/csrc/grouped_topk.cu"
GROUPED_SRC = "nlsh_tpu_torch/csrc/grouped_scores.cu"
BUCKET_SRC = "nlsh_tpu_torch/csrc/bucket_scores.cu"
REPLACES = {  # the TPU kernel each CUDA kernel replaces, and its source
    "grouped_scores_topk": ("nlsh_tpu/ops/pallas/query_kernel.py:879",
                            TOPK_SRC),
    "grouped_scores": ("nlsh_tpu/ops/pallas/query_kernel.py:766",
                       GROUPED_SRC),
    "windowed_scores_topk": ("nlsh_tpu/ops/pallas/query_kernel.py:1372",
                             TOPK_SRC),
    "windowed_scores": ("nlsh_tpu/ops/pallas/query_kernel.py:1453",
                        GROUPED_SRC),
    "bucket_scores_auto": ("nlsh_tpu/ops/pallas/query_kernel.py:634",
                           BUCKET_SRC),
    "bucket_scores_impl": ("nlsh_tpu/ops/pallas/query_kernel.py:569",
                           BUCKET_SRC),
    "int8_block_scores": ("benchmarks/int8_probe.py:66", GROUPED_SRC),
}
# the yardstick of each kernel: one PyTorch call computing the same
# function on the same inputs (timed here, never called by the port)
NO_LIBRARY_TOPK = ("none: no one PyTorch call computes a per-lane mask and "
                   "a per-row top-k with the lowest-lane tie rule")
NO_LIBRARY_BUCKET = ("none: no one PyTorch call masks each event's lanes; a "
                     "batched product would first gather every event's cap "
                     "rows (42 GB at the serve's events)")
# K5 of the commit before its redesign (one thread block per event), timed
# by `python3 -m nlsh_tpu_torch.tools.fixed_events` in a checkout of that
# commit, at the random-bucket table of `_fixed_times`
PREVIOUS_K5_RANDOM_MS = {"torch.float32": 8.12, "torch.int8": 3.41}
PREVIOUS_K5_NOTE = ("a constant, not of this run: NVIDIA H100 80GB HBM3, "
                    "700 W, in one call with the redesigned kernel")
LIBRARY_BMM = ("torch.bmm(grp_qvecs, blocks^T) on f32 blocks gathered before "
               "the timed region: the gather is left out, which flatters the "
               "library")
LIBRARY_K7 = ("torch.matmul(queries, blocks^T) on the upcast blocks gathered "
              "before the timed region: the gather is left out")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def id_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-query overlap of two top-k id sets (``-1`` = no id),
    over the ids ``a`` holds (as ``bench._id_agreement``)."""
    return float(np.mean([
        len(set(ra[ra >= 0]) & set(rb[rb >= 0])) / max((ra >= 0).sum(), 1)
        for ra, rb in zip(a, b)
    ]))


def reset_launches() -> None:
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    for name in qk.KERNEL_LAUNCHES:
        qk.KERNEL_LAUNCHES[name] = 0


def read_launches(*names: str) -> dict:
    """The launch counts of ``names`` since :func:`reset_launches`;
    fails unless each launched."""
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    got = {name: qk.KERNEL_LAUNCHES[name] for name in names}
    check(all(v > 0 for v in got.values()),
          f"every kernel of the path must launch: {got}")
    return got


def kernel_entry(err: float, ms: float, plain_ms: float, counts,
                 library_ms: float | None, library_note: str) -> dict:
    """A kernel's numbers: its error against the plain version, its time,
    the plain version's, the library call's (None where there is none,
    with the reason), and its bound from ``counts`` with the share of it
    the kernel reaches (bound over time)."""
    from nlsh_tpu_torch.ops.cuda import bounds

    b = bounds.bound(counts)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_note": library_note,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "bound_share": b["bound_ms"] / ms, "bytes": b["bytes"],
            "flops": b["flops"]}


def bmm_ms(data, grp_qvecs, grp_block, br: int, reps: int) -> float:
    """The raw panels' yardstick: ``torch.bmm`` on the groups' blocks,
    gathered (and upcast to f32) before the timed region."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    blocks = qk._group_blocks(data, grp_block, br).transpose(1, 2)
    ms = cuda_ms(lambda: torch.bmm(grp_qvecs, blocks), reps)
    del blocks
    return ms


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs, after one
    warm-up, timed with CUDA events."""
    import torch

    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls,
    after one warm-up: the device-side events of ``torch.profiler``
    (kernels and copies), without the host's launch time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type != torch.autograd.DeviceType.CPU)
    check(us > 0, "the profile saw no device time")
    return us / reps / 1e3


def _panel_is_topk(name: str, panel, topk, lay) -> bool | None:
    """On an f32 layout with no norms or scales, the raw panel at the
    fused kernel's kept lanes must equal its kept scores bit for bit
    (one FMA chain per pair in both); True once checked, None where the
    fused kernel's scores are scaled or biased and so not compared."""
    import torch

    if lay.data.dtype != torch.float32 or lay.norms is not None \
            or lay.scale is not None:
        return None
    scores, lanes = topk
    fin = torch.isfinite(scores)
    check(bool(fin.any()) and bool(torch.equal(
        panel.gather(2, lanes.long())[fin], scores[fin])),
        f"{name}'s panel differs from the fused kernel's kept scores")
    return True


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs on a CUDA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    check(tf32 is False and prec == "highest",
          f"f32 matmuls must be exact (allow_tf32={tf32}, precision={prec})")
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         allow_tf32=tf32, float32_matmul_precision=prec, **info)
    return info


def phase_build() -> None:
    from nlsh_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    paths = build.build()
    build.load_library()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "smem" in ln or "entry function" in ln
             or "spill" in ln or ln.startswith("==")]
    emit("build", build_s=time.perf_counter() - t0, nvcc_s=build.build_seconds,
         libraries=[os.path.relpath(p, ROOT) for p in paths.values()],
         ptxas=ptxas)


def _unit_rows(rng, shape) -> np.ndarray:
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _compare_topk(scores, lanes, ref_panel, kk: int, name: str = "K1") -> float:
    """Hold K1's or K3's ``(scores, lanes)`` to the masked plain panel: scores
    within SCORE_TOL, -inf at the same places, lanes equal wherever the
    score is finite and not tied within TIE_TOL, and exact ties in the
    kernel's own output ordered lowest lane first.  Returns the max
    score error."""
    import torch

    ref_v, ref_i = torch.sort(ref_panel, dim=2, descending=True, stable=True)
    ref_v, ref_i = ref_v[..., : kk + 1], ref_i[..., : kk + 1]
    fin = torch.isfinite(ref_v[..., :kk])
    check(bool((torch.isfinite(scores) == fin).all()),
          f"{name} -inf pattern differs from the plain version")
    err = float((scores - ref_v[..., :kk])[fin].abs().max()) if fin.any() else 0.0
    check(err <= SCORE_TOL, f"{name} score error {err} > {SCORE_TOL}")
    gap_prev = torch.full_like(ref_v[..., :kk], torch.inf)
    gap_prev[..., 1:] = ref_v[..., 1:kk] - ref_v[..., : kk - 1]
    gap_next = ref_v[..., :kk] - ref_v[..., 1: kk + 1]
    untied = fin & (gap_prev.abs() > TIE_TOL) & (gap_next.abs() > TIE_TOL)
    check(bool((lanes.long() == ref_i[..., :kk])[untied].all()),
          f"{name} lanes differ from the plain version off ties")
    same = (scores[..., 1:] == scores[..., :-1]) & torch.isfinite(scores[..., 1:])
    check(bool((lanes[..., 1:] > lanes[..., :-1])[same].all()),
          f"{name} broke an exact tie other than lowest lane first")
    return err


def phase_kernels() -> dict:
    """K1-K4 vs their plain versions on synthetic groups: G=32, br=512,
    d_pad=128, kk 10 and 16, f32 and bf16 corpora, with and without norms
    and scale, exact ties; for K1 empty groups and counts below kk, for
    K3 empty slots (lo = hi = 0), ranges narrower than kk, ranges with
    lo > 0 and a dead group."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)
    G, br, d, n_blocks, g_total = 32, 512, 128, 48, 256
    data = _unit_rows(rng, (n_blocks * br, d))
    dup = rng.integers(0, n_blocks * br, 2048)  # forced exact ties
    data[dup] = data[(dup // br) * br]           # copies of each block's row 0
    qvecs = _unit_rows(rng, (g_total, G, d))
    qvecs[:, 5] = data[0]                        # a query that ties exactly
    grp_block = np.sort(rng.integers(0, n_blocks, g_total)).astype(np.int32)
    grp_cnt = rng.integers(0, br + 1, (g_total, G)).astype(np.int32)
    grp_cnt[::7] = 0                                          # empty groups
    grp_cnt[1::5, :8] = rng.integers(0, 10, (len(grp_cnt[1::5]), 8))  # < kk
    norms = rng.uniform(0.5, 1.5, n_blocks * br).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n_blocks * br).astype(np.float32)
    t = {n: torch.from_numpy(v).to(dev) for n, v in (
        ("qvecs", qvecs), ("grp_block", grp_block), ("grp_cnt", grp_cnt),
        ("norms", norms), ("scale", scale))}
    lane = torch.arange(br, device=dev)
    worst = {"grouped_scores_topk": 0.0, "grouped_scores": 0.0}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        dd = torch.from_numpy(data).to(dev).to(dtype)
        raw = qk.grouped_scores(dd, t["qvecs"], t["grp_block"], block_rows=br)
        ref_raw = qk.grouped_scores_plain(dd, t["qvecs"], t["grp_block"],
                                          block_rows=br)
        torch.cuda.synchronize()
        err = float((raw - ref_raw).abs().max())
        check(err <= SCORE_TOL, f"K2 {dtype} error {err} > {SCORE_TOL}")
        worst["grouped_scores"] = max(worst["grouped_scores"], err)
        blk = t["grp_block"].long()
        for kk in (10, 16):
            for use_norms in (False, True):
                for use_scale in (False, True):
                    nrm = t["norms"] if use_norms else None
                    scl = t["scale"] if use_scale else None
                    scores, lanes = qk.grouped_scores_topk(
                        dd, t["qvecs"], t["grp_block"], t["grp_cnt"], kk,
                        block_rows=br, norms=nrm, scale_rows=scl)
                    torch.cuda.synchronize()
                    ref = ref_raw.clone()
                    if scl is not None:
                        ref = ref * scl.view(-1, br)[blk][:, None, :]
                    if nrm is not None:
                        ref = ref - nrm.view(-1, br)[blk][:, None, :]
                    ref = torch.where(lane < t["grp_cnt"][:, :, None], ref,
                                      -torch.inf)
                    err = _compare_topk(scores, lanes, ref, kk)
                    worst["grouped_scores_topk"] = max(
                        worst["grouped_scores_topk"], err)
                    cases += 1
    cases += _windowed_kernel_cases(rng, data, qvecs, t, worst)
    emit("kernels", cases=cases, max_abs_err=worst, score_tol=SCORE_TOL,
         tie_tol=TIE_TOL)
    return worst


def _windowed_kernel_cases(rng, data, qvecs, t, worst) -> int:
    """K3 and K4 on windowed groups over the same corpus and queries."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    dev = torch.device(DEVICE)
    g_total, G = qvecs.shape[:2]
    br = 512
    n_windows = data.shape[0] // br
    win = np.sort(rng.integers(0, n_windows, g_total)).astype(np.int32)
    lo = rng.integers(0, br, (g_total, G)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, br, (g_total, G)), br).astype(np.int32)
    lo[::3, ::2] = hi[::3, ::2] = 0                              # empty slots
    hi[1::4, :6] = np.minimum(lo[1::4, :6] + rng.integers(1, 8, 6), br)  # < kk
    lo[2::9] = 0                                   # ranges from the window start
    lo[-1] = hi[-1] = 0                                          # a dead group
    tw = {n: torch.from_numpy(v).to(dev) for n, v in (
        ("win", win), ("lo", lo), ("hi", hi))}
    lane = torch.arange(br, device=dev)
    keep = (lane >= tw["lo"][:, :, None]) & (lane < tw["hi"][:, :, None])
    wblk = tw["win"].long()
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        dd = torch.from_numpy(data).to(dev).to(dtype)
        raw = qk.windowed_scores(dd, t["qvecs"], tw["win"], block_rows=br)
        ref_raw = qk.windowed_scores_plain(dd, t["qvecs"], tw["win"],
                                           block_rows=br)
        torch.cuda.synchronize()
        err = float((raw - ref_raw).abs().max())
        check(err <= SCORE_TOL, f"K4 {dtype} error {err} > {SCORE_TOL}")
        worst["windowed_scores"] = max(worst.get("windowed_scores", 0.0), err)
        for kk in (10, 16):
            for use_norms in (False, True):
                for use_scale in (False, True):
                    nrm = t["norms"] if use_norms else None
                    scl = t["scale"] if use_scale else None
                    scores, lanes = qk.windowed_scores_topk(
                        dd, t["qvecs"], tw["win"], tw["lo"], tw["hi"], kk,
                        block_rows=br, norms=nrm, scale_rows=scl)
                    torch.cuda.synchronize()
                    ref = ref_raw.clone()
                    if scl is not None:
                        ref = ref * scl.view(-1, br)[wblk][:, None, :]
                    if nrm is not None:
                        ref = ref - nrm.view(-1, br)[wblk][:, None, :]
                    ref = torch.where(keep, ref, -torch.inf)
                    err = _compare_topk(scores, lanes, ref, kk, "K3")
                    fin = torch.isfinite(scores)
                    inside = ((lanes >= tw["lo"][..., None])
                              & (lanes < tw["hi"][..., None]))
                    check(bool(inside[fin].all()), "K3 lane outside [lo, hi)")
                    worst["windowed_scores_topk"] = max(
                        worst.get("windowed_scores_topk", 0.0), err)
                    cases += 1
    return cases


def _masked_err(name: str, got, want, exact: bool) -> float:
    """Masked per-event scores against their plain version: the same
    -inf pattern, then bitwise (``exact``) or within SCORE_TOL."""
    import torch

    fin = torch.isfinite(want)
    check(bool((torch.isfinite(got) == fin).all()), f"{name} -inf pattern")
    err = float((got - want)[fin].abs().max()) if fin.any() else 0.0
    check(err == 0.0 if exact else err <= SCORE_TOL,
          f"{name} error {err} (exact: {exact})")
    return err


def _quantised(rng, data: np.ndarray, nq: int):
    """Per-row int8 rows of ``data`` and small dyadic queries: every sum
    is exact in f32, so kernel and plain version compare bitwise."""
    scale = np.abs(data).max(axis=1, keepdims=True) / 127.0
    data = np.clip(np.round(data / scale), -127, 127).astype(np.int8)
    q = (rng.integers(-16, 17, (nq, data.shape[1])) / 64.0).astype(np.float32)
    return data, q


def _schedule_cases(rng, dd, cap: int, exact: bool, worst: dict) -> int:
    """K5 and K6 on the hard cases of the sorted-chunk schedule
    (``nlsh_tpu_torch.tools.fixed_events.synthetic_events``: duplicate
    events, one key across several chunks with different counts, nothing
    to score, one event, a ragged last chunk, indices clamped at both
    ends, K6 ranges that overlap without being equal) against their plain
    versions; two launches must give identical bytes, and K6 must equal
    K5 bitwise at block-exact starts.  Returns the number of cases."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk
    from nlsh_tpu_torch.tools.fixed_events import synthetic_events

    dev, d = dd.device, dd.shape[1]
    cases = synthetic_events(3, dd.shape[0] // cap, cap)
    for case in cases:
        index, cnt = (torch.from_numpy(case[n]).to(dev)
                      for n in ("index", "counts"))
        nq = index.shape[0]
        q = (rng.integers(-16, 17, (nq, d)) / 64.0).astype(np.float32) \
            if exact else _unit_rows(rng, (nq, d))
        tq = torch.from_numpy(q).to(dev)
        k6 = case["stride"] == 1
        name = "bucket_scores_impl" if k6 else "bucket_scores_auto"
        kernel = qk.bucket_scores_impl if k6 else qk.bucket_scores_auto
        plain = qk.bucket_scores_impl_plain if k6 else \
            qk.bucket_scores_auto_plain
        got = kernel(dd, tq, index, cnt, cap)
        label = f"{'K6' if k6 else 'K5'} {case['name']} cap {cap} {dd.dtype}"
        worst[name] = max(worst[name], _masked_err(
            label, got, plain(dd, tq, index, cnt, cap), exact))
        again = kernel(dd, tq, index, cnt, cap)
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"{label}: two launches differ")
        if case["name"] == "block_exact":
            check(torch.equal(
                qk.bucket_scores_auto(dd, tq, index // cap, cnt, cap), got),
                f"{label}: K6 differs from K5 on the same rows")
    return len(cases)


def phase_fixed_kernels() -> dict:
    """K5 and K6 vs their plain versions on synthetic events (cap 512,
    d_pad 128, 256 queries x 16 probes over 64 blocks) for f32, bf16
    and int8 corpora: counts of 0 (invalid probes), of cap and between,
    every query probing the layout's last block (one key across 8 work
    items), K6 at starts that are multiples of 8 but not of cap, and
    K6 = K5 bitwise at block-exact starts; then the schedule's hard cases
    (:func:`_schedule_cases`) at cap 512, d_pad 128 and at cap 200, d_pad
    384.  The int8 cases dot small dyadic queries, so every sum is exact
    and they compare bitwise."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(2)
    cap, d, n_blocks, nq, n_probes = 512, 128, 64, 256, 16
    worst = {"bucket_scores_auto": 0.0, "bucket_scores_impl": 0.0}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        data = _unit_rows(rng, (n_blocks * cap, d))
        q = _unit_rows(rng, (nq, d))
        exact = dtype is torch.int8
        if exact:
            data, q = _quantised(rng, data, nq)
        bidx = rng.integers(0, n_blocks, (nq, n_probes)).astype(np.int32)
        bidx[:, 0] = n_blocks - 1                    # the layout's tail
        cnt = rng.integers(1, cap, (nq, n_probes)).astype(np.int32)
        cnt[::5] = cap                               # full buckets
        cnt[1::7, 3:] = 0                            # invalid probes
        dd = torch.from_numpy(data).to(dev).to(dtype)
        tq, tb, tc = (torch.from_numpy(a).to(dev) for a in (q, bidx, cnt))
        k5 = qk.bucket_scores_auto(dd, tq, tb, tc, cap)
        worst["bucket_scores_auto"] = max(worst["bucket_scores_auto"], _masked_err(
            "K5", k5, qk.bucket_scores_auto_plain(dd, tq, tb, tc, cap), exact))
        check(torch.equal(qk.bucket_scores_impl(dd, tq, tb * cap, tc, cap), k5),
              "K6 differs from K5 at block-exact starts")
        starts = torch.clamp(tb * cap + 8 * (tb % 7 + 1), max=dd.shape[0] - cap)
        worst["bucket_scores_impl"] = max(worst["bucket_scores_impl"], _masked_err(
            "K6", qk.bucket_scores_impl(dd, tq, starts, tc, cap),
            qk.bucket_scores_impl_plain(dd, tq, starts, tc, cap), exact))
        cases += 1 + _schedule_cases(rng, dd, cap, exact, worst)
        wide = _unit_rows(rng, (9 * 200, 384))
        if exact:
            wide, _ = _quantised(rng, wide, 1)
        cases += _schedule_cases(
            rng, torch.from_numpy(wide).to(dev).to(dtype), 200, exact, worst)
    torch.cuda.synchronize()
    emit("fixed_kernels", cases=cases, max_abs_err=worst, score_tol=SCORE_TOL,
         int8="bitwise", two_launches="identical bytes")
    return worst


def phase_int8_probe():
    """K7 at ``benchmarks/int8_probe.py``'s own operands (64 int8 blocks of
    (128, 128), 8 integer queries in [-16, 16], a permuted block order,
    seed 0): bitwise equal to its plain version (every partial sum is an
    exact f32 integer), and the probe's top-10 agreement of int8 against
    f32 scores on 256 unit queries (host math, as the probe does it).
    Returns the launch count of the probe's run and the times."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    br, lane, nq, n_blocks = 128, 128, 8, 64
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(n_blocks * br, lane)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    scale = np.abs(corpus).max() / 127.0
    corpus_q = np.clip(np.round(corpus / scale), -127, 127).astype(np.int8)
    queries = rng.integers(-16, 17, size=(nq, lane)).astype(np.float32)
    block_ids = rng.permutation(n_blocks).astype(np.int32)
    t = [torch.from_numpy(a).to(DEVICE)
         for a in (corpus_q, queries, block_ids)]
    reset_launches()
    out = qk.int8_block_scores(*t, br)
    launches = read_launches("int8_block_scores")
    ref = qk.int8_block_scores_plain(*t, br)
    check(out.shape == (n_blocks, nq, br) and torch.equal(out, ref),
          "K7 differs from its plain version")
    fq = rng.normal(size=(256, lane)).astype(np.float32)
    fq /= np.linalg.norm(fq, axis=1, keepdims=True)
    exact = fq @ corpus.T
    quant = (fq @ corpus_q.astype(np.float32).T) * scale
    agree = float(np.mean([
        len(set(np.argsort(-exact[i])[:10]) & set(np.argsort(-quant[i])[:10]))
        / 10 for i in range(fq.shape[0])]))
    from nlsh_tpu_torch.ops.cuda import bounds

    blocks = t[0].view(-1, br, lane)[t[2].long()].to(torch.float32)
    blocks = blocks.transpose(1, 2)
    times = kernel_entry(
        float((out - ref).abs().max()),
        cuda_ms(lambda: qk.int8_block_scores(*t, br), 20),
        cuda_ms(lambda: qk.int8_block_scores_plain(*t, br), 20),
        bounds.panel_counts(t[0], t[1], t[2], nq, br, lane),
        cuda_ms(lambda: torch.matmul(t[1], blocks), 20), LIBRARY_K7)
    # at this size the event times above are the host's launch time; the
    # profiler's device events give the kernels' own
    times["device_ms"] = device_ms(lambda: qk.int8_block_scores(*t, br), 20)
    times["library_device_ms"] = device_ms(
        lambda: torch.matmul(t[1], blocks), 20)
    times["ms_note"] = ("ms, plain_ms and library_ms are CUDA-event times "
                        "of 20 calls, host launch included; device_ms and "
                        "library_device_ms are torch.profiler device time")
    emit("int8_probe", n_blocks=n_blocks, block_rows=br, nq=nq, bitwise=True,
         top10_agreement_int8_vs_f32=agree, launches=launches, **times)
    return launches, times


def load_hashing():
    from nlsh_tpu_torch.models import get_encoder, get_hashing
    from nlsh_tpu_torch.utils.checkpoint import params_from_jax, read_msgpack

    hashing = get_hashing("MultivariateBernoulli",
                          get_encoder("siren", 100, [256, 256]), 12)
    return params_from_jax(hashing, read_msgpack(PARAMS))


def phase_index(corpus: np.ndarray):
    import torch

    from nlsh_tpu_torch.index import Indexer

    t0 = time.perf_counter()
    idx = Indexer(load_hashing(), corpus, device=DEVICE, metric="cosine",
                  probe_budget=CAP)
    layout = idx.layout
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emit("index", build_s=build_s, n_rows=int(corpus.shape[0]),
         max_bucket=idx.table.max_count(), buckets_used=idx.n_buckets_used(),
         n_buckets=idx.table.n_buckets, layout_rows=layout.n_rows,
         cap=layout.cap, block_rows=layout.br)
    return idx, build_s


def phase_serve(idx, queries: np.ndarray, gt: np.ndarray):
    """The single table's grouped run: every query at k=10 (K1), then
    every query at k=20 (above ROW_TOPK, so K2), through Indexer.query.
    Returns the k=10 ids and candidates, and the launch counts of the
    run."""
    import torch

    from nlsh_tpu_torch.utils.metrics import calculate_recall

    def serve(k):
        return idx.query(queries, k=k, hash_times=HASH_TIMES,
                         probe_mode="flip")

    reset_launches()
    ids, n_cand = serve(K)
    ids20, _ = serve(2 * K)
    launches = read_launches("grouped_scores_topk", "grouped_scores")
    check(ids.shape == (queries.shape[0], K) and ids20.shape[1] == 2 * K,
          "result shapes")
    check(bool(((ids >= -1) & (ids < idx.corpus.shape[0])).all()), "id range")
    recall = float(calculate_recall(gt[:, :K], ids, np.mean))
    mean_cand = float(n_cand.mean())
    check(RECALL_RANGE[0] <= recall <= RECALL_RANGE[1],
          f"recall@10 {recall} outside {RECALL_RANGE}")
    check(N_CAND_RANGE[0] <= mean_cand <= N_CAND_RANGE[1],
          f"mean n_candidates {mean_cand} outside {N_CAND_RANGE}")
    head20 = id_agreement(ids, ids20[:, :K])
    check(head20 >= 0.999, f"k=20 head vs k=10 agreement {head20} < 0.999")

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        serve(K)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    emit("serve", n_queries=int(queries.shape[0]), k=K,
         hash_times=HASH_TIMES, recall_at_10=recall,
         mean_n_candidates=mean_cand, k20_head_agreement=head20,
         launches=launches, pass_s=times, median_s=med,
         qps=queries.shape[0] / med)
    return ids, n_cand, launches


def _probes(idx, queries: np.ndarray):
    """The single table's queries on the card and their flip probes."""
    import torch

    q = torch.as_tensor(queries, device=idx.device)
    with torch.no_grad():
        pid, pv = idx.hashing.hash(q, n_probes=HASH_TIMES, probe_mode="flip")
    return q, pid, pv


def _row_scale(lay):
    """The per-row int8 scales of a layout, or None."""
    return lay.scale if lay.scale is not None and lay.scale.ndim == 1 else None


def _topk_check(name: str, got, want) -> float:
    """A fused kernel's (scores, lanes) against its plain version's: the
    same -inf pattern, scores within SCORE_TOL, lanes equal on >= 0.999
    of the finite slots (near-ties may swap).  Returns the max error."""
    import torch

    fin = torch.isfinite(want[0])
    check(bool((torch.isfinite(got[0]) == fin).all()), f"{name} -inf pattern")
    check(bool((got[1] == want[1])[fin].float().mean() >= 0.999),
          f"{name} lanes vs plain at the main path's shapes")
    err = float((got[0] - want[0])[fin].abs().max())
    check(err <= SCORE_TOL, f"{name} error {err} at the main path's shapes")
    return err


def _panel_err(name: str, got, want, lay, blk) -> float:
    """Max |kernel - plain| of raw panels, in dequantised units on a
    per-row int8 layout (the raw dots there are ~1/scale times larger)."""
    scale = _row_scale(lay)
    if scale is not None:
        w = scale.view(-1, lay.br)[blk.long()][:, None, :]
        got, want = got * w, want * w
    err = float((got - want).abs().max())
    check(err <= SCORE_TOL, f"{name} error {err} at the main path's shapes")
    return err


def _grouped_times(lay, q, pid, pv) -> dict:
    """K1/K2 and their plain versions at the grouped prep of all the
    queries on ``lay``: CUDA-event times and max score error.  Bounds
    count the queries' own width (the metric-extended one, cosine and
    euclidean alike), not the layout's padded ``d_pad``."""
    import torch

    from nlsh_tpu_torch.ops.cuda import bounds
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    max_blocks = lay.cap // lay.br
    g_total = qk._round_up(qk.grouped_static_bound(
        pid.numel(), max_blocks, lay.total_blocks, 32), qk._GROUP_EB)
    grp_block, grp_qvecs, grp_cnt, *_ = qk._grouped_prep_v2(
        lay.starts, lay.counts, pid, pv, qk.extend_queries(lay, q), lay.cap,
        g_total=g_total, max_blocks=max_blocks, group_q=32, block_rows=lay.br)
    args = (lay.data, grp_qvecs, grp_block)
    kw = dict(block_rows=lay.br, norms=lay.norms, scale_rows=_row_scale(lay))
    out = {}
    k1 = qk.grouped_scores_topk(*args, grp_cnt, K, **kw)
    err = _topk_check("K1", k1,
                      qk.grouped_scores_topk_plain(*args, grp_cnt, K, **kw))
    out["grouped_scores_topk"] = kernel_entry(
        err, cuda_ms(lambda: qk.grouped_scores_topk(*args, grp_cnt, K, **kw), 20),
        cuda_ms(lambda: qk.grouped_scores_topk_plain(*args, grp_cnt, K, **kw), 3),
        bounds.topk_counts(*args, None, grp_cnt, K, lay.br, q.shape[1],
                           kw["norms"], kw["scale_rows"]),
        None, NO_LIBRARY_TOPK)
    panel = qk.grouped_scores(*args, block_rows=lay.br)
    k2_is_k1 = _panel_is_topk("K2", panel, k1, lay)
    err = _panel_err("K2", panel,
                     qk.grouped_scores_plain(*args, block_rows=lay.br), lay,
                     grp_block)
    del panel, k1
    out["grouped_scores"] = kernel_entry(
        err, cuda_ms(lambda: qk.grouped_scores(*args, block_rows=lay.br), 20),
        cuda_ms(lambda: qk.grouped_scores_plain(*args, block_rows=lay.br), 3),
        bounds.panel_counts(lay.data, grp_qvecs, grp_block, 32, lay.br,
                            q.shape[1]),
        bmm_ms(*args, lay.br, 5), LIBRARY_BMM)
    torch.cuda.synchronize()
    return {"g_total": g_total, "group_q": 32, "block_rows": lay.br,
            "d_pad": lay.d_pad,
            "live_groups": int((grp_cnt.max(dim=1).values > 0).sum()),
            "live_slots": int((grp_cnt > 0).sum()),
            "topk_blocks_per_sm": qk.topk_blocks_per_sm(
                lay.data.dtype, lay.d_pad, windowed=False),
            "panel_blocks_per_sm": qk.panel_blocks_per_sm(lay.data.dtype,
                                                          lay.d_pad),
            "k2_panel_is_k1_scores_bitwise": k2_is_k1,
            "kernels": out}


def _windowed_times(lay, q, pid, pv, g_total: int, panel_reps: int) -> dict:
    """K3/K4 and their plain versions at the windowed prep of the probes
    ``(pid, pv)`` on ``lay`` with ``g_total`` groups: CUDA-event times
    and max score error (bounds over the queries' own width, as in
    :func:`_grouped_times`)."""
    import torch

    from nlsh_tpu_torch.ops.cuda import bounds
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    grp_window, grp_qvecs, grp_lo, grp_hi, *_ = qk._windowed_prep(
        lay.starts, lay.counts, pid, pv, qk.extend_queries(lay, q), lay.cap,
        g_total=g_total, max_sub=lay.cap // lay.br + 1, group_q=qk.GROUP_W,
        block_rows=lay.br)
    args = (lay.data, grp_qvecs, grp_window)
    topk = (grp_lo, grp_hi, K)
    kw = dict(block_rows=lay.br, norms=lay.norms, scale_rows=_row_scale(lay))
    out = {}
    k3 = qk.windowed_scores_topk(*args, *topk, **kw)
    err = _topk_check("K3", k3,
                      qk.windowed_scores_topk_plain(*args, *topk, **kw))
    out["windowed_scores_topk"] = kernel_entry(
        err, cuda_ms(lambda: qk.windowed_scores_topk(*args, *topk, **kw), 20),
        cuda_ms(lambda: qk.windowed_scores_topk_plain(*args, *topk, **kw), 3),
        bounds.topk_counts(*args, *topk, lay.br, q.shape[1], kw["norms"],
                           kw["scale_rows"]), None, NO_LIBRARY_TOPK)
    panel = qk.windowed_scores(*args, block_rows=lay.br)
    k4_is_k3 = _panel_is_topk("K4", panel, k3, lay)
    err = _panel_err("K4", panel,
                     qk.windowed_scores_plain(*args, block_rows=lay.br), lay,
                     grp_window)
    del panel, k3
    out["windowed_scores"] = kernel_entry(
        err, cuda_ms(lambda: qk.windowed_scores(*args, block_rows=lay.br),
                     panel_reps),
        cuda_ms(lambda: qk.windowed_scores_plain(*args, block_rows=lay.br), 3),
        bounds.panel_counts(lay.data, grp_qvecs, grp_window, qk.GROUP_W,
                            lay.br, q.shape[1]),
        bmm_ms(*args, lay.br, panel_reps), LIBRARY_BMM)
    torch.cuda.synchronize()
    live = grp_hi > grp_lo
    return {"g_total": g_total, "group_q": qk.GROUP_W, "block_rows": lay.br,
            "d_pad": lay.d_pad, "live_groups": int(live.any(dim=1).sum()),
            "live_slots": int(live.sum()),
            "topk_blocks_per_sm": qk.topk_blocks_per_sm(
                lay.data.dtype, lay.d_pad, windowed=True),
            "panel_blocks_per_sm": qk.panel_blocks_per_sm(lay.data.dtype,
                                                          lay.d_pad),
            "k4_panel_is_k3_scores_bitwise": k4_is_k3,
            "kernels": out}


def phase_kernel_times(idx, queries: np.ndarray) -> dict:
    """K1/K2 and their plain versions at the main path's own shapes (the
    grouped prep of all queries): CUDA-event times and max score error."""
    res = _grouped_times(idx.layout, *_probes(idx, queries))
    out = res.pop("kernels")
    emit("kernel_times", **res, **out)
    return out


def phase_parity(corpus, queries, idx, ids_k1) -> dict:
    """Grouped vs gather on a 65,536-row slice (cosine, euclidean; the
    bench's 0.98 gate), and the full serve with K1 vs the plain scorer."""
    from nlsh_tpu_torch.index import Indexer

    out = {}
    hashing = idx.hashing
    for metric in ("cosine", "euclidean"):
        small = Indexer(hashing, corpus[:SLICE_ROWS], device=DEVICE,
                        metric=metric, engine="gather")
        qs = queries[:SLICE_QUERIES]
        g_ids, g_cand = small.query(qs, k=K, hash_times=HASH_TIMES,
                                    probe_mode="flip")
        small.engine = "grouped"
        s_ids, s_cand = small.query(qs, k=K, hash_times=HASH_TIMES,
                                    probe_mode="flip")
        check(bool((g_cand == s_cand).all()), f"{metric}: n_candidates differ")
        agree = id_agreement(g_ids, s_ids)
        check(agree >= 0.98, f"{metric}: grouped vs gather {agree} < 0.98")
        out[f"{metric}:grouped:gather"] = agree
    p_ids, _ = idx.query(queries, k=K, hash_times=HASH_TIMES,
                         probe_mode="flip", plain=True)
    agree = id_agreement(p_ids, ids_k1)
    check(agree >= 0.999, f"K1 vs plain serve agreement {agree} < 0.999")
    out["full:k1:plain"] = agree
    emit("parity", **out)
    return out


def phase_windowed(idx, queries: np.ndarray, gt: np.ndarray, grouped_ids,
                   grouped_cand) -> dict:
    """The single table on the windowed engine (dense layout, K3 at
    k=10, K4 at k=20): recall, candidates query by query and ids against
    the grouped engine's run.  Returns the launch counts of the run."""
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    idx.engine = "windowed"
    layout = idx.layout  # the dense layout's build is not part of the run
    reset_launches()
    ids, n_cand = idx.query(queries, k=K, hash_times=HASH_TIMES,
                            probe_mode="flip")
    ids20, n_cand20 = idx.query(queries, k=2 * K, hash_times=HASH_TIMES,
                                probe_mode="flip")
    launches = read_launches("windowed_scores_topk", "windowed_scores")
    recall = float(calculate_recall(gt[:, :K], ids, np.mean))
    check(RECALL_RANGE[0] <= recall <= RECALL_RANGE[1],
          f"windowed recall@10 {recall} outside {RECALL_RANGE}")
    check(bool((n_cand == grouped_cand).all() and (n_cand20 == n_cand).all()),
          "windowed n_candidates differ from the grouped engine's")
    agree = id_agreement(grouped_ids, ids)
    check(agree >= 0.999, f"windowed vs grouped agreement {agree} < 0.999")
    head20 = id_agreement(ids, ids20[:, :K])
    check(head20 >= 0.999, f"windowed k=20 head vs k=10 {head20} < 0.999")
    emit("windowed", n_queries=int(queries.shape[0]), k=[K, 2 * K],
         hash_times=HASH_TIMES, recall_at_10=recall,
         mean_n_candidates=float(n_cand.mean()),
         windowed_vs_grouped=agree, k20_head_agreement=head20,
         layout_rows=layout.n_rows, align=layout.align, launches=launches)
    idx.engine = "grouped"
    return launches


def _timed_passes(serve, n: int) -> dict:
    import torch

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return {"pass_s": times, "median_s": med}


def phase_fixed(idx, queries: np.ndarray, gt: np.ndarray, grouped_ids,
                grouped_cand) -> dict:
    """The single table on the fixed-cap engine (K5), on the cap-aligned
    f32 layout the grouped engine built: recall and candidates in the
    f32 windows, candidates per query and ids against the grouped
    engine's run, QPS.  Returns the launch counts of the run."""
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    layout = idx.layout
    idx.engine = "fixed"
    check(idx.layout is layout and layout.align == layout.cap,
          "the fixed-cap engine serves the grouped engine's layout")

    def serve():
        return idx.query(queries, k=K, hash_times=HASH_TIMES,
                         probe_mode="flip")

    reset_launches()
    ids, n_cand = serve()
    launches = read_launches("bucket_scores_auto")
    recall = float(calculate_recall(gt[:, :K], ids, np.mean))
    mean_cand = float(n_cand.mean())
    check(RECALL_RANGE[0] <= recall <= RECALL_RANGE[1],
          f"fixed-cap recall@10 {recall} outside {RECALL_RANGE}")
    check(N_CAND_RANGE[0] <= mean_cand <= N_CAND_RANGE[1],
          f"fixed-cap mean n_candidates {mean_cand} outside {N_CAND_RANGE}")
    check(bool((n_cand == grouped_cand).all()),
          "fixed-cap n_candidates differ from the grouped engine's")
    agree = id_agreement(grouped_ids, ids)
    check(agree >= 0.999, f"fixed-cap vs grouped agreement {agree} < 0.999")
    timed = _timed_passes(serve, 5)
    emit("fixed", n_queries=int(queries.shape[0]), k=K, hash_times=HASH_TIMES,
         recall_at_10=recall, mean_n_candidates=mean_cand,
         fixed_vs_grouped=agree, layout_rows=layout.n_rows, cap=layout.cap,
         launches=launches, **timed,
         qps=queries.shape[0] / timed["median_s"])
    idx.engine = "grouped"
    return launches


def _k5_is_k2_panel(lay, qe, pid, pv, k5, counts) -> bool:
    """K5's live lanes against K2's raw panel of the grouped prep of the
    same probes on the same cap-aligned layout (cap = block_rows, one
    block per event): the same (query, row) pairs, one fmaf chain over
    the features in order in both kernels, so they must agree bit for
    bit however the two kernels group the events."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    check(lay.cap == lay.br, "K5 = K2 is compared where cap = block_rows")
    g_total = qk._round_up(qk.grouped_static_bound(
        pid.numel(), 1, lay.total_blocks, 32), qk._GROUP_EB)
    grp_block, grp_qvecs, _, ev_row, _, ev_valid = qk._grouped_prep_v2(
        lay.starts, lay.counts, pid, pv, qe, lay.cap, g_total=g_total,
        max_blocks=1, group_q=32, block_rows=lay.br)
    panel = qk.grouped_scores(lay.data, grp_qvecs, grp_block,
                              block_rows=lay.br)
    rows = panel.view(-1, lay.br)[ev_row[:, 0].long()]
    keep = torch.arange(lay.cap, device=k5.device) < counts.reshape(-1, 1)
    check(bool((keep.any(dim=1) == ev_valid[:, 0]).all()),
          "the grouped prep and the fixed-cap events disagree on live events")
    check(bool(torch.equal(k5.reshape(-1, lay.cap)[keep], rows[keep])),
          "K5's live lanes differ from K2's panel on the serve's events")
    return True


def _fixed_times(lay, q, pid, pv):
    """K5 and K6 and their plain versions on the fixed-cap events of the
    probes ``(pid, pv)`` on the cap-aligned ``lay``: K6 runs first, on the
    events by row offset (starts = block_idx * cap), and must equal K5
    bitwise; K5's live lanes must equal K2's panel bitwise; scores are
    compared with the plain version in dequantised units on a per-row
    int8 layout.  A kernel's ``ms`` is the whole wrapper call (what the
    serve pays): ``grouping_ms`` of it is the events' sort
    (``_bucket_event_order``) and ``kernel_ms`` the launch alone.  Then
    K5 at a table without hot buckets: every query probing 16 distinct
    random buckets (seed 0).  Returns K6's launch count, the times and
    the live rows."""
    import torch

    from nlsh_tpu_torch.ops.cuda import bounds
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk
    from nlsh_tpu_torch.tools.fixed_events import (fixed_events,
                                                   random_bucket_probes)

    qe = qk.extend_queries(lay, q)
    block_idx, starts, counts = fixed_events(lay, pid, pv)
    five = (lay.data, qe, block_idx, counts, lay.cap)
    six = (lay.data, qe, starts, counts, lay.cap)
    reset_launches()
    k6 = qk.bucket_scores_impl(*six)
    launches = read_launches("bucket_scores_impl")
    k5 = qk.bucket_scores_auto(*five)
    check(bool(torch.equal(k5, k6)), "K6 differs from K5 on the serve's events")
    del k6
    is_k2 = _k5_is_k2_panel(lay, qe, pid, pv, k5, counts)
    p5 = qk.bucket_scores_auto_plain(*five)
    scale = _row_scale(lay)
    if scale is not None:
        w = scale.view(-1, lay.cap)[block_idx.long()]
        k5, p5 = k5 * w, p5 * w
    err = _masked_err("K5", k5, p5, False)
    del k5, p5
    counts5 = bounds.bucket_counts(lay.data, qe, starts, counts, lay.cap,
                                   q.shape[1])
    out = {
        "bucket_scores_auto": kernel_entry(
            err, cuda_ms(lambda: qk.bucket_scores_auto(*five), 20),
            cuda_ms(lambda: qk.bucket_scores_auto_plain(*five), 3), counts5,
            None, NO_LIBRARY_BUCKET),
        "bucket_scores_impl": kernel_entry(
            err, cuda_ms(lambda: qk.bucket_scores_impl(*six), 20),
            cuda_ms(lambda: qk.bucket_scores_impl_plain(*six), 3), counts5,
            None, NO_LIBRARY_BUCKET),
    }
    for name, index, stride in (("bucket_scores_auto", block_idx, lay.cap),
                                ("bucket_scores_impl", starts, 1)):
        order_args = (index, counts, lay.cap, stride, lay.n_rows)
        ordered = qk._bucket_event_order(*order_args)
        out[name]["grouping_ms"] = cuda_ms(
            lambda: qk._bucket_event_order(*order_args), 20)
        out[name]["kernel_ms"] = cuda_ms(lambda: qk._launch_bucket_sorted(
            lay.data, qe, *ordered, lay.cap, name), 20)
        out[name]["k5_is_k2_panel_bitwise"] = is_k2
    rid, rv = (torch.from_numpy(a).to(pid.device) for a in random_bucket_probes(
        lay.counts.shape[0], pid.shape[0], pid.shape[1], 0))
    r_block, r_starts, r_counts = fixed_events(lay, rid, rv)
    out["bucket_scores_auto"]["random_buckets"] = {
        "ms": cuda_ms(lambda: qk.bucket_scores_auto(
            lay.data, qe, r_block, r_counts, lay.cap), 20),
        "live_rows": int(r_counts.sum()),
        "bound_ms": bounds.bound(bounds.bucket_counts(
            lay.data, qe, r_starts, r_counts, lay.cap, q.shape[1]))["bound_ms"],
        "previous_kernel_ms": PREVIOUS_K5_RANDOM_MS.get(str(lay.data.dtype)),
        "previous_kernel_note": PREVIOUS_K5_NOTE}
    return launches, out, int(counts.sum())


def phase_fixed_kernel_times(idx, queries: np.ndarray):
    """K5 and K6 and their plain versions on the fixed-cap serve's own
    events (the probes of all queries on the cap-aligned f32 layout).
    K6 has no caller in the JAX package: its path here is these events
    scored by row offset.  Returns the times and K6's launch count."""
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    lay = idx.layout
    q, pid, pv = _probes(idx, queries)
    launches, out, live_rows = _fixed_times(lay, q, pid, pv)
    emit("fixed_kernel_times", n_events=pid.numel(), cap=lay.cap,
         d_pad=lay.d_pad, live_rows=live_rows,
         work_items=qk.bucket_work_items(pid.numel()),
         bucket_blocks_per_sm=qk.bucket_blocks_per_sm(lay.data.dtype),
         k6_path="no caller in the JAX package; the serve's events by row "
                 "offset, bitwise equal to K5",
         k6_launches=launches, **out)
    return out, launches


def phase_int8(idx, queries: np.ndarray, gt: np.ndarray, f32_cand):
    """The single table on the per-row int8 layout (the bench's int8 row):
    the grouped serve (K1 on int8 rows with per-row scales; recall in
    INT8_RECALL_RANGE, candidates equal to the f32 serve's per query,
    QPS), the fixed-cap (K5) and windowed (K3, dense layout) serves of
    the same table (ids >= 0.999 against the grouped one, candidates
    equal), K1-K4 on int8 against their plain versions with times, and
    one global-scale grouped serve; K5/K6 on int8 at the fixed-cap
    serve's events.  Returns the launch counts and the int8 kernel
    times."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    def serve():
        return idx.query(queries, k=K, hash_times=HASH_TIMES,
                         probe_mode="flip")

    idx.engine, idx.serving_dtype, idx.int8_scale = \
        "grouped", torch.int8, "per_row"
    t0 = time.perf_counter()
    layout = idx.layout
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(layout.data.dtype == torch.int8 and layout.scale.ndim == 1,
          "per-row int8 layout")
    reset_launches()
    ids, n_cand = serve()
    launches = {"grouped": read_launches("grouped_scores_topk")}
    recall = float(calculate_recall(gt[:, :K], ids, np.mean))
    check(INT8_RECALL_RANGE[0] <= recall <= INT8_RECALL_RANGE[1],
          f"int8 recall@10 {recall} outside {INT8_RECALL_RANGE}")
    check(bool((n_cand == f32_cand).all()),
          "int8 n_candidates differ from the f32 serve's")
    res = {"recall_at_10": recall, "layout_rows": layout.n_rows,
           "layout_gib": layout.data.numel() / 2 ** 30, "build_s": build_s}
    timed = _timed_passes(serve, 5)
    res["grouped"] = {**timed, "qps": queries.shape[0] / timed["median_s"]}
    q, pid, pv = _probes(idx, queries)
    k12 = _grouped_times(layout, q, pid, pv)
    times = k12.pop("kernels")
    times.update(_fixed_times(layout, q, pid, pv)[1])

    for engine, kernel in (("fixed", "bucket_scores_auto"),
                           ("windowed", "windowed_scores_topk")):
        idx.engine = engine
        lay = idx.layout  # the windowed engine's dense layout: built here
        reset_launches()
        e_ids, e_cand = serve()
        launches[engine] = read_launches(kernel)
        agree = id_agreement(ids, e_ids)
        check(agree >= 0.999, f"int8 {engine} vs grouped {agree} < 0.999")
        check(bool((e_cand == n_cand).all()),
              f"int8 {engine} n_candidates differ from the grouped serve's")
        timed = _timed_passes(serve, 3)
        res[engine] = {"vs_grouped": agree, "layout_rows": lay.n_rows,
                       **timed, "qps": queries.shape[0] / timed["median_s"]}
    g_total = qk._round_up(qk.windowed_static_bound(
        pid.numel(), lay.cap // lay.br + 1, lay.n_rows // lay.br, qk.GROUP_W),
        qk._GROUP_EB)
    k34 = _windowed_times(lay, q, pid, pv, g_total, panel_reps=5)
    times.update(k34.pop("kernels"))

    idx.engine, idx.int8_scale = "grouped", "global"
    g_ids, g_cand = serve()
    check(bool((g_cand == n_cand).all()),
          "global-scale int8 n_candidates differ")
    check(idx.layout.scale.ndim == 0, "global-scale int8 layout")
    res["global"] = {
        "recall_at_10": float(calculate_recall(gt[:, :K], g_ids, np.mean)),
        "vs_per_row": id_agreement(ids, g_ids)}
    idx.serving_dtype, idx.int8_scale = torch.float32, "per_row"
    emit("int8", n_queries=int(queries.shape[0]), k=K, hash_times=HASH_TIMES,
         scale_mode="per_row", **res, launches=launches,
         grouped_table=k12, windowed_table=k34, kernel_times=times)
    return launches, times


def load_ensemble():
    from nlsh_tpu_torch.models import get_encoder, get_hashing
    from nlsh_tpu_torch.utils.checkpoint import read_msgpack, stacked_params_from_jax

    def make():
        return get_hashing("MultivariateBernoulli",
                           get_encoder("siren", 100, [256, 256]), 12)

    return stacked_params_from_jax(make, read_msgpack(PARAMS_T8)["hashing"])


def phase_ensemble_index(corpus: np.ndarray):
    import torch

    from nlsh_tpu_torch.parallel import MultiTableIndexer

    hashings = load_ensemble()
    t0 = time.perf_counter()
    midx = MultiTableIndexer(hashings, corpus, metric="cosine", device=DEVICE)
    layout = midx._serving_layout()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = midx.counts.cpu().numpy()
    gib = (layout.data.numel() * layout.data.element_size()) / 2 ** 30
    check(midx.engine == "windowed", f"auto engine is {midx.engine}")
    emit("ensemble_index", build_s=build_s, n_tables=midx.n_tables,
         n_rows=int(corpus.shape[0]),
         max_bucket=[int(c.max()) for c in counts],
         buckets_used=[int((c > 0).sum()) for c in counts],
         probe_budget=midx.probe_budget, cap=layout.cap, align=layout.align,
         block_rows=layout.br, layout_rows=layout.n_rows, layout_gib=gib,
         engine=midx.engine)
    return midx, build_s


def _flat_probes(midx, queries: np.ndarray):
    import torch

    q = torch.as_tensor(queries, device=midx.device)
    with torch.no_grad():
        return midx._flat_probes(*midx._probes(q, MT_HASH_TIMES,
                                               probe_mode="flip"))


def _static_groups(layout, gp) -> int:
    """The windowed static group bound of the flat probes ``gp``."""
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    return qk.windowed_static_bound(gp.numel(), layout.cap // layout.br + 1,
                                    layout.n_rows // layout.br, qk.GROUP_W)


def phase_ensemble_serve(midx, queries: np.ndarray, gt: np.ndarray):
    """The ensemble's run: ``calibrate`` on the queries themselves, then
    all 10,000 through ``MultiTableIndexer.query`` on the windowed engine
    (K3), so the batch fits its calibration by construction (the static
    bound is :func:`phase_ensemble_guard`'s).  Returns the ids, summed
    candidates and the launch counts."""
    import torch

    from nlsh_tpu_torch.utils.metrics import calculate_recall

    kw = dict(hash_times=MT_HASH_TIMES, probe_mode="flip")
    g_cal = midx.calibrate(queries, **kw)
    layout = midx._serving_layout()
    gp, gv = _flat_probes(midx, queries)
    override, needed = midx.windowed_group_bound(layout, gp, gv)
    static = _static_groups(layout, gp)
    check(override == g_cal, f"the batch ({needed} groups) does not fit its "
          f"own calibration ({g_cal})")

    reset_launches()
    ids, n_cand = midx.query(queries, k=K, **kw)
    launches = read_launches("windowed_scores_topk")
    check(ids.shape == (queries.shape[0], K), "ensemble result shape")
    check(bool(((ids >= -1) & (ids < midx.corpus.shape[0])).all()),
          "ensemble id range")
    for row in ids[:200]:
        real = row[row >= 0]
        check(len(set(real)) == len(real), "duplicate ids after the dedupe")
    recall = float(calculate_recall(gt[:, :K], ids, np.mean))
    mean_cand = float(n_cand.mean())
    size = float(midx.exact_query_size(queries, **kw).mean())
    check(MT_RECALL_RANGE[0] <= recall <= MT_RECALL_RANGE[1],
          f"ensemble recall@10 {recall} outside {MT_RECALL_RANGE}")
    check(MT_N_CAND_RANGE[0] <= mean_cand <= MT_N_CAND_RANGE[1],
          f"ensemble mean n_candidates {mean_cand} outside {MT_N_CAND_RANGE}")
    check(MT_QUERY_SIZE_RANGE[0] <= size <= MT_QUERY_SIZE_RANGE[1],
          f"ensemble exact query_size {size} outside {MT_QUERY_SIZE_RANGE}")

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        midx.query(queries, k=K, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    emit("ensemble_serve", n_queries=int(queries.shape[0]), k=K,
         hash_times=MT_HASH_TIMES, probe_mode="flip", engine=midx.engine,
         recall_at_10=recall, mean_n_candidates=mean_cand,
         mean_exact_query_size=size, groups_calibrated=g_cal,
         groups_static=static, groups_live=needed, launches=launches,
         pass_s=times, median_s=med, qps=queries.shape[0] / med)
    return ids, n_cand, launches


def phase_ensemble_kernel_times(midx, queries: np.ndarray) -> dict:
    """K3 and K4 and their plain versions at the ensemble's own group
    table (the calibrated one the serve used): CUDA-event times and max
    score error."""
    import torch

    gp, gv = _flat_probes(midx, queries)
    res = _windowed_times(midx._serving_layout(),
                          torch.as_tensor(queries, device=midx.device), gp,
                          gv, midx._g_cal, panel_reps=5)
    out = res.pop("kernels")
    emit("ensemble_kernel_times", **res, **out)
    return out


def _profile_passes(phase: str, serve, top: int) -> None:
    """``torch.profiler`` over 3 passes of ``serve``: the unprofiled and
    the profiled wall time per pass, the device time per pass, the
    device's idle share of the profiled pass, and the costliest kernels
    and copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def passes():
        t0 = time.perf_counter()
        for _ in range(3):
            serve()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3 * 1e3

    passes()
    wall_ms = passes()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = passes()
    # device-side events only: an operator's own entry repeats the time
    # of the kernels it launched
    ops = [e for e in prof.key_averages()
           if e.device_type != torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in ops) / 3e3
    check(device_ms > 0, "the profile saw no device time")
    emit(phase, passes=3, wall_ms_per_pass=wall_ms,
         profiled_wall_ms_per_pass=profiled_ms, device_ms_per_pass=device_ms,
         device_idle_share=1.0 - device_ms / profiled_ms,
         device_events_per_pass=sum(e.count for e in ops) / 3,
         top=[{"op": e.key[:80], "ms_per_pass": e.self_device_time_total / 3e3,
               "calls_per_pass": e.count / 3} for e in ops[:top]])


def phase_fixed_profile(idx, queries: np.ndarray) -> None:
    """``--profile``: 3 fixed-cap serve passes of the single table (f32)
    under ``torch.profiler``: K5 (``bucket_kernel``), its grouping (the
    160,000-key sort and the small ops before it), the flat stable sort
    of the (10,000, 8,192) scores and the rest, by kernel name."""
    idx.engine = "fixed"
    _profile_passes("fixed_profile", lambda: idx.query(
        queries, k=K, hash_times=HASH_TIMES, probe_mode="flip"), top=25)
    idx.engine = "grouped"


def phase_ensemble_profile(midx, queries: np.ndarray) -> None:
    """``--profile``: 3 ensemble serve passes under ``torch.profiler``."""
    _profile_passes("ensemble_profile", lambda: midx.query(
        queries, k=K, hash_times=MT_HASH_TIMES, probe_mode="flip"), top=15)


def phase_ensemble_parity(midx, queries: np.ndarray, ids, n_cand) -> dict:
    """Windowed with K3 vs its plain scorer (all queries, >= 0.999), vs
    the grouped engine (all queries, >= 0.999, equal candidates), and vs
    the gather engine (the first 1,000 queries, the bench's 0.98 gate)."""
    kw = dict(k=K, hash_times=MT_HASH_TIMES, probe_mode="flip")
    out = {}
    p_ids, p_cand = midx.query(queries, plain=True, **kw)
    check(bool((p_cand == n_cand).all()), "K3 vs plain: n_candidates differ")
    out["windowed:k3:plain"] = id_agreement(p_ids, ids)
    check(out["windowed:k3:plain"] >= 0.999,
          f"ensemble K3 vs plain {out['windowed:k3:plain']} < 0.999")
    midx.engine = "grouped"
    g_ids, g_cand = midx.query(queries, **kw)
    check(bool((g_cand == n_cand).all()),
          "ensemble grouped vs windowed: n_candidates differ")
    out["windowed:grouped"] = id_agreement(g_ids, ids)
    check(out["windowed:grouped"] >= 0.999,
          f"ensemble windowed vs grouped {out['windowed:grouped']} < 0.999")
    midx.engine = "gather"
    head = queries[:MT_GATHER_QUERIES]
    x_ids, x_cand = midx.query(head, **kw)
    out["windowed:gather"] = id_agreement(x_ids, ids[:MT_GATHER_QUERIES])
    check(out["windowed:gather"] >= 0.98,
          f"ensemble windowed vs gather {out['windowed:gather']} < 0.98")
    check(bool((x_cand <= n_cand[:MT_GATHER_QUERIES]).all()),
          "distinct candidates above the summed occupancy")
    emit("ensemble_parity", gather_queries=MT_GATHER_QUERIES,
         gather_mean_distinct=float(x_cand.mean()), **out)
    midx.engine = "windowed"
    return out


def phase_ensemble_guard(midx, queries: np.ndarray, ids, n_cand) -> dict:
    """A starved calibration (4 queries, one probe per table): the full
    batch's exact need exceeds it, so the serve must take the static
    group bound and give the calibrated serve's ids and candidates."""
    import torch

    g_starved = midx.calibrate(queries[:4], hash_times=1, probe_mode="flip")
    layout = midx._serving_layout()
    gp, gv = _flat_probes(midx, queries)
    override, needed = midx.windowed_group_bound(layout, gp, gv)
    check(override is None and needed > g_starved,
          f"a batch of {needed} groups was served on a starved calibration "
          f"of {g_starved}")
    kw = dict(k=K, hash_times=MT_HASH_TIMES, probe_mode="flip")
    s_ids, s_cand = midx.query(queries, **kw)
    check(bool(np.array_equal(s_cand, n_cand)),
          "static-bound serve: n_candidates differ from the calibrated serve")
    check(bool(np.array_equal(s_ids, ids)),
          "static-bound serve: ids differ from the calibrated serve")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        midx.query(queries, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    static = _static_groups(layout, gp)
    emit("ensemble_guard", groups_calibrated=g_starved, groups_needed=needed,
         groups_static=static, ids_equal=True, n_candidates_equal=True,
         pass_s=times, median_s=med, qps=queries.shape[0] / med)
    return {"groups_calibrated": g_starved, "groups_needed": needed}


# ---------------------------------------------------------------------------
# the serving process: artifacts, persistence, updates, the other heads,
# the CLI
# ---------------------------------------------------------------------------

# the L=8 ensemble on the per-row int8 stacked layout, windowed engine: the
# port's plain serve on the CPU gives 0.93833 (tests/test_torch_full.py)
MT_INT8_RECALL_RANGE = (0.9373, 0.9393)
UPDATE_HELD_BACK = 10_000     # corpus rows added after the build
UPDATE_REMOVED = 1_000        # ids tombstoned: k_eff = 10 + 1,024
UPDATE_SAMPLE = 1_000         # queries held to the plain and gather serves
HEAD_ROWS, HEAD_QUERIES, HEAD_PROBES = 262_144, 2_000, 4
LOOP_REQUESTS, LOOP_MAX_BATCH = 200, 512


class _CountedHashes:
    """Counts the ``hash_corpus`` calls of both indexers inside a ``with``
    block (a restored index must make none)."""

    def __enter__(self):
        from nlsh_tpu_torch.index import indexer
        from nlsh_tpu_torch.parallel import multitable

        self.calls, self._saved = 0, []
        for mod in (indexer, multitable):
            real = mod.hash_corpus
            self._saved.append((mod, real))

            def counted(*a, _real=real, **kw):
                self.calls += 1
                return _real(*a, **kw)

            mod.hash_corpus = counted
        return self

    def __exit__(self, *exc):
        for mod, real in self._saved:
            mod.hash_corpus = real


def _codes(hashing, corpus_t):
    from nlsh_tpu_torch.index import hash_corpus

    return hash_corpus(hashing.to(DEVICE).eval(), corpus_t)


def phase_artifact(corpus: np.ndarray, tmp: str) -> None:
    """The committed params as model artifacts of the port
    (``save_model`` / ``load_model``, single table and ``n_tables`` = 8):
    the loaded modules hash the corpus to the very same bucket ids."""
    import torch

    from nlsh_tpu_torch.utils.checkpoint import (
        load_model, model_config, save_model,
    )

    corpus_t = torch.as_tensor(corpus, device=DEVICE)
    out = {}
    for name, loaded in (("single", load_hashing()), ("t8", load_ensemble())):
        base = os.path.join(tmp, f"model_{name}")
        t0 = time.perf_counter()
        save_model(base, loaded)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_model(base, device=DEVICE)
        load_s = time.perf_counter() - t0
        many = isinstance(loaded, list)
        check(isinstance(back, list) == many, f"{name}: one module or a list")
        check(model_config(base).get("n_tables") == (8 if many else None),
              f"{name}: n_tables in the JSON")
        pairs = list(zip(loaded, back)) if many else [(loaded, back)]
        for want, got in pairs:
            check(bool(torch.equal(_codes(want, corpus_t),
                                   _codes(got, corpus_t))),
                  f"{name}: the loaded model hashes the corpus differently")
        out[name] = {"tables": len(pairs), "save_s": save_s, "load_s": load_s,
                     "json_bytes": os.path.getsize(base + ".json"),
                     "msgpack_bytes": os.path.getsize(base + ".msgpack"),
                     "bucket_ids_equal": True}
    emit("artifact", n_rows=int(corpus.shape[0]), **out)


def _refuses_changed_tail(load, corpus: np.ndarray) -> bool:
    changed = corpus.copy()
    changed[-1] += 0.5
    try:
        load(changed)
    except ValueError as e:
        return "different corpus" in str(e)
    return False


def phase_persist(idx, midx, corpus, queries, gt, single, ensemble,
                  tmp: str):
    """``save`` then ``load`` of the single table and of the ensemble with
    the same corpus: CSR arrays bitwise, no ``hash_corpus`` call, the
    serve's ids and candidates equal to the first serve's, recall in its
    window, a corpus with one tail row changed refused.  ``single`` and
    ``ensemble`` are ``(ids, n_candidates, build_s)`` of the built
    indexes.  Returns the restored single-table ``Indexer`` and the
    launch counts of the two restored serves."""
    import torch

    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.parallel import MultiTableIndexer
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    out = {}
    # -- the single table
    path = os.path.join(tmp, "index")          # np.savez appends .npz
    t0 = time.perf_counter()
    idx.save(path)
    save_s = time.perf_counter() - t0
    check(os.path.exists(path + ".npz"), "save appends .npz")
    hashing = load_hashing()
    with _CountedHashes() as hashes:
        t0 = time.perf_counter()
        back = Indexer.load(path + ".npz", hashing, corpus, device=DEVICE)
        _ = back.layout
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    check(hashes.calls == 0, f"load hashed the corpus {hashes.calls} times")
    for name in ("row_ids", "starts", "counts"):
        check(bool(torch.equal(getattr(back.table, name),
                               getattr(idx.table, name))), f"restored {name}")
    check((back.engine, back.probe_budget, back.metric) ==
          (idx.engine, idx.probe_budget, idx.metric), "restored knobs")
    reset_launches()
    ids, n_cand = back.query(queries, k=K, hash_times=HASH_TIMES,
                             probe_mode="flip")
    launches = read_launches("grouped_scores_topk")
    check(bool(np.array_equal(ids, single[0])), "restored serve: ids differ")
    check(bool(np.array_equal(n_cand, single[1])),
          "restored serve: n_candidates differ")
    recall = float(calculate_recall(gt[:, :K], ids, np.mean))
    check(RECALL_RANGE[0] <= recall <= RECALL_RANGE[1],
          f"restored recall@10 {recall} outside {RECALL_RANGE}")
    check(_refuses_changed_tail(
        lambda c: Indexer.load(path + ".npz", hashing, c, device=DEVICE),
        corpus), "a corpus with one tail row changed was not refused")
    out["single"] = {"build_s": single[2], "save_s": save_s, "load_s": load_s,
                     "file_bytes": os.path.getsize(path + ".npz"),
                     "hash_corpus_calls_on_load": 0, "csr_bitwise": True,
                     "ids_equal": True, "n_candidates_equal": True,
                     "recall_at_10": recall, "changed_tail_refused": True,
                     "launches": launches}

    # -- the ensemble
    path = os.path.join(tmp, "ensemble")
    t0 = time.perf_counter()
    midx.save(path)
    save_s = time.perf_counter() - t0
    hashings = load_ensemble()
    kw = dict(hash_times=MT_HASH_TIMES, probe_mode="flip")
    with _CountedHashes() as hashes:
        t0 = time.perf_counter()
        mback = MultiTableIndexer.load(path + ".npz", hashings, corpus,
                                       device=DEVICE)
        mback._serving_layout()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    check(hashes.calls == 0, f"load hashed the corpus {hashes.calls} times")
    for name in ("row_ids", "starts", "counts"):
        check(bool(torch.equal(getattr(mback, name), getattr(midx, name))),
              f"restored ensemble {name}")
    check(mback.engine == "windowed" and mback.n_tables == midx.n_tables,
          "restored ensemble knobs")
    mback.calibrate(queries, **kw)
    reset_launches()
    ids, n_cand = mback.query(queries, k=K, **kw)
    launches = read_launches("windowed_scores_topk")
    check(bool(np.array_equal(ids, ensemble[0])),
          "restored ensemble serve: ids differ")
    check(bool(np.array_equal(n_cand, ensemble[1])),
          "restored ensemble serve: n_candidates differ")
    recall = float(calculate_recall(gt[:, :K], ids, np.mean))
    mean_cand = float(n_cand.mean())
    size = float(mback.exact_query_size(queries, **kw).mean())
    check(MT_RECALL_RANGE[0] <= recall <= MT_RECALL_RANGE[1],
          f"restored ensemble recall@10 {recall} outside {MT_RECALL_RANGE}")
    check(MT_N_CAND_RANGE[0] <= mean_cand <= MT_N_CAND_RANGE[1]
          and MT_QUERY_SIZE_RANGE[0] <= size <= MT_QUERY_SIZE_RANGE[1],
          f"restored ensemble candidates {mean_cand} / {size}")
    check(_refuses_changed_tail(
        lambda c: MultiTableIndexer.load(path + ".npz", hashings, c,
                                         device=DEVICE), corpus),
        "ensemble: a corpus with one tail row changed was not refused")
    out["ensemble"] = {"build_s": ensemble[2], "save_s": save_s,
                       "load_s": load_s,
                       "file_bytes": os.path.getsize(path + ".npz"),
                       "hash_corpus_calls_on_load": 0, "csr_bitwise": True,
                       "ids_equal": True, "n_candidates_equal": True,
                       "recall_at_10": recall, "mean_n_candidates": mean_cand,
                       "mean_exact_query_size": size,
                       "changed_tail_refused": True, "launches": launches}
    del mback
    emit("persist", **out)
    return back, {**out["single"]["launches"], **out["ensemble"]["launches"]}


def phase_host_layout(idx, queries: np.ndarray, ids, n_cand) -> None:
    """``layout_mode="host"`` (numpy on the host, finished arrays
    shipped) against the layout built on the card, f32 and per-row int8:
    the integer arrays bitwise; the rows bitwise, or, where the host's
    and the card's f32 row norms round differently, within one f32 step
    (one int8 step) on the share of elements printed; the serve's
    candidates equal and ids >= 0.999."""
    import torch

    from nlsh_tpu_torch.index import Indexer

    out = {}
    for name, dtype in (("f32", torch.float32), ("int8", torch.int8)):
        built = {}
        for mode in ("device", "host"):
            one = Indexer(idx.hashing, idx.corpus, device=DEVICE,
                          metric=idx.metric, probe_budget=CAP,
                          serving_dtype=dtype, layout_mode=mode,
                          table=idx.table)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lay = one.layout
            torch.cuda.synchronize()
            built[mode] = (one, lay, time.perf_counter() - t0)
        dev, host = built["device"][1], built["host"][1]
        for field in ("row_map", "starts", "counts"):
            check(bool(torch.equal(getattr(host, field), getattr(dev, field))),
                  f"host layout {name}: {field}")
        check((host.cap, host.align, host.d_pad, host.total_blocks, host.br)
              == (dev.cap, dev.align, dev.d_pad, dev.total_blocks, dev.br),
              f"host layout {name}: geometry")
        check(host.data.dtype == dev.data.dtype == dtype
              and host.data.device == dev.data.device,
              f"host layout {name}: dtype and device")
        a, b = host.data, dev.data
        differ = float((a != b).float().mean())
        if dtype == torch.int8:
            step = int((a.to(torch.int16) - b.to(torch.int16)).abs().max())
            check(step <= 1 and differ < 1e-3,
                  f"host int8 layout: {differ} of bytes differ, by {step}")
            s_err = float((host.scale - dev.scale).abs().max()
                          / dev.scale.abs().max())
            check(s_err <= 1e-6, f"host int8 scales differ by {s_err}")
        else:
            step = float((a - b).abs().max())
            check(step <= 2.0 ** -23, f"host f32 layout differs by {step}")
        h_ids, h_cand = built["host"][0].query(
            queries, k=K, hash_times=HASH_TIMES, probe_mode="flip")
        check(bool(np.array_equal(h_cand, n_cand)),
              f"host layout {name}: n_candidates differ")
        want = ids if dtype == torch.float32 else built["device"][0].query(
            queries, k=K, hash_times=HASH_TIMES, probe_mode="flip")[0]
        agree = id_agreement(want, h_ids)
        check(agree >= 0.999, f"host layout {name}: ids {agree} < 0.999")
        out[name] = {"device_build_s": built["device"][2],
                     "host_build_s": built["host"][2],
                     "rows_bitwise": differ == 0.0,
                     "differing_share": differ, "max_step": step,
                     "ids_vs_device_layout": agree,
                     "layout_gib": a.numel() * a.element_size() / 2 ** 30}
        del built
    emit("host_layout", layout_rows=idx.layout.n_rows, **out)


def phase_updates(corpus, queries, gt, serve_median_s: float) -> dict:
    """Inserts and deletes on the running index: the last 10,000 corpus
    rows held back at build and then added, 1,000 ids removed (half of
    them among the queries' current answers, some in the buffer).  With
    1,000 tombstones the engine fetches k + 1,024 per query, so the
    grouped serve leaves K1 for the raw panels: K2 must launch.  On 1,000
    queries the answers are held to the plain serve and to the gather
    engine (an exact rerank of the probed rows and the buffer).  After
    ``compact`` the answers equal an index built from scratch over the
    full corpus with the removed rows' codes set to the sentinel."""
    import torch

    from nlsh_tpu_torch.index import Indexer, build_bucket_table, hash_corpus
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    n0 = corpus.shape[0] - UPDATE_HELD_BACK
    idx = Indexer(load_hashing(), corpus[:n0], device=DEVICE, metric="cosine",
                  probe_budget=CAP)
    _ = idx.layout
    kw = dict(k=K, hash_times=HASH_TIMES, probe_mode="flip")

    def serve():
        return idx.query(queries, **kw)

    base_ids, base_cand = serve()
    idx.add(corpus[n0:n0 + 4_000])
    idx.add(corpus[n0 + 4_000:])
    check(idx.n_fresh == UPDATE_HELD_BACK, "n_fresh")
    ids_a, cand_a = serve()
    check(bool((cand_a == base_cand + UPDATE_HELD_BACK).all()),
          "n_candidates grows by the buffer's length")
    fresh_share = float((ids_a >= n0).mean())
    check(fresh_share > 0, "no buffered row is among the answers")
    recall_a = float(calculate_recall(gt[:, :K], ids_a, np.mean))
    check(recall_a >= RECALL_RANGE[0], f"recall with the buffer {recall_a}")
    with_buffer = _timed_passes(serve, 3)

    rng = np.random.default_rng(7)
    answered = np.unique(ids_a[ids_a >= 0])
    dead = np.unique(np.concatenate([
        rng.choice(answered, UPDATE_REMOVED // 2, replace=False),
        rng.choice(n0, UPDATE_REMOVED * 2 // 5, replace=False),
        n0 + rng.choice(UPDATE_HELD_BACK, UPDATE_REMOVED // 10,
                        replace=False)]))
    while dead.size < UPDATE_REMOVED:
        dead = np.unique(np.concatenate(
            [dead, rng.choice(n0, UPDATE_REMOVED - dead.size)]))
    dead = dead.astype(np.int32)
    idx.remove(dead[:UPDATE_REMOVED * 3 // 5])
    idx.remove(dead[UPDATE_REMOVED // 2:])       # overlapping calls: a union
    check(idx.n_deleted == UPDATE_REMOVED, "n_deleted")
    k_eff = K + (1 << (UPDATE_REMOVED - 1).bit_length())

    reset_launches()
    ids_r, cand_r = serve()
    launches = read_launches("grouped_scores")
    check(qk.KERNEL_LAUNCHES["grouped_scores_topk"] == 0,
          "the tombstone serve fetches k_eff > 16 per block: K2, not K1")
    check(ids_r.shape == (queries.shape[0], K), "tombstone serve shape")
    check(not bool(np.isin(ids_r, dead).any()), "a removed id was answered")
    check(bool((cand_r == cand_a).all()),
          "n_candidates counts tombstoned candidates until compact")
    in_answers = int(np.isin(dead, answered).sum())
    in_buffer = int((dead >= n0).sum())
    changed = float((ids_r != ids_a).any(axis=1).mean())
    with_tombstones = _timed_passes(serve, 3)

    sample = rng.choice(queries.shape[0], UPDATE_SAMPLE, replace=False)
    qs = queries[sample]
    k_ids, k_cand = idx.query(qs, **kw)
    p_ids, p_cand = idx.query(qs, plain=True, **kw)
    check(bool(np.array_equal(k_cand, p_cand))
          and bool(np.array_equal(k_cand, cand_r[sample])),
          "tombstone serve: n_candidates vs the plain serve")
    vs_plain = id_agreement(p_ids, k_ids)
    check(vs_plain >= 0.999, f"tombstone serve vs plain {vs_plain} < 0.999")
    vs_full = id_agreement(ids_r[sample], k_ids)
    check(vs_full >= 0.999, f"the sample served alone {vs_full} < 0.999")
    idx.engine = "gather"
    g_ids, g_cand = idx.query(qs, **kw)
    idx.engine = "grouped"
    check(bool(np.array_equal(g_cand, k_cand)), "gather n_candidates")
    vs_gather = id_agreement(g_ids, k_ids)
    check(vs_gather >= 0.98, f"tombstone serve vs gather {vs_gather} < 0.98")
    check(not bool(np.isin(g_ids, dead).any())
          and not bool(np.isin(p_ids, dead).any()), "references hold dead ids")

    t0 = time.perf_counter()
    idx.compact()
    _ = idx.layout
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    check(idx.n_fresh == 0 and idx.n_deleted == 0
          and idx.corpus.shape[0] == corpus.shape[0]
          and idx.probe_budget == CAP, "state after compact")
    check(int(idx.table.counts.sum()) == corpus.shape[0] - UPDATE_REMOVED,
          "compact drops exactly the removed rows")
    reset_launches()
    ids_c, cand_c = serve()
    launches_c = read_launches("grouped_scores_topk")
    check(not bool(np.isin(ids_c, dead).any()),
          "a removed id was answered after compact")
    codes = hash_corpus(idx.hashing, idx.corpus)
    codes[torch.from_numpy(dead).to(DEVICE).long()] = idx.hashing.n_buckets
    scratch = Indexer(idx.hashing, corpus, device=DEVICE, metric="cosine",
                      probe_budget=CAP,
                      table=build_bucket_table(codes, idx.hashing.n_buckets))
    s_ids, s_cand = scratch.query(queries, **kw)
    check(bool(np.array_equal(s_ids, ids_c))
          and bool(np.array_equal(s_cand, cand_c)),
          "after compact: not the index built from scratch")
    # not a check: the buffer was scanned whole, the table is only probed
    vs_tomb = id_agreement(ids_r, ids_c)
    recall_c = float(calculate_recall(gt[:, :K], ids_c, np.mean))
    after_compact = _timed_passes(serve, 3)
    emit("updates", n_rows_at_build=n0, added=UPDATE_HELD_BACK,
         removed=UPDATE_REMOVED, removed_among_answers=in_answers,
         removed_in_buffer=in_buffer, k_eff=k_eff,
         answers_from_buffer_share=fresh_share,
         queries_changed_by_removes=changed,
         recall_with_buffer=recall_a, recall_after_compact=recall_c,
         sample_queries=UPDATE_SAMPLE, vs_plain=vs_plain,
         vs_gather=vs_gather, sample_vs_full_batch=vs_full,
         compact_vs_tombstones=vs_tomb, compact_equals_scratch=True,
         launches_tombstones=launches, launches_after_compact=launches_c,
         compact_s=compact_s, serve_median_s=serve_median_s,
         with_buffer=with_buffer, with_tombstones=with_tombstones,
         after_compact=after_compact)
    return launches


def phase_ensemble_engines(midx, queries, gt, mt_ids, mt_cand):
    """The L=8 ensemble on the fixed-cap engine (K5; ids >= 0.999 against
    the windowed serve, summed candidates equal), then on the per-row
    int8 stacked layout, windowed engine (K3; recall in the window of the
    port's plain serve on the CPU).  Returns the launch counts of the
    two serves."""
    import torch

    from nlsh_tpu_torch.utils.metrics import calculate_recall

    kw = dict(hash_times=MT_HASH_TIMES, probe_mode="flip")

    def serve():
        return midx.query(queries, k=K, **kw)

    def layout_of():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lay = midx._serving_layout()
        torch.cuda.synchronize()
        gib = lay.data.numel() * lay.data.element_size() / 2 ** 30
        return lay, time.perf_counter() - t0, gib

    f32_gib = layout_of()[2]                      # the windowed f32 layout
    midx.engine = "fixed"
    lay, build_s, gib = layout_of()
    check(lay.align == lay.cap, "the fixed-cap layout is cap-aligned")
    reset_launches()
    ids, n_cand = serve()
    launches = read_launches("bucket_scores_auto")
    check(bool(np.array_equal(n_cand, mt_cand)),
          "ensemble fixed-cap: summed n_candidates differ")
    agree = id_agreement(mt_ids, ids)
    check(agree >= 0.999, f"ensemble fixed-cap vs windowed {agree} < 0.999")
    recall = float(calculate_recall(gt[:, :K], ids, np.mean))
    check(MT_RECALL_RANGE[0] <= recall <= MT_RECALL_RANGE[1],
          f"ensemble fixed-cap recall@10 {recall} outside {MT_RECALL_RANGE}")
    timed = _timed_passes(serve, 3)
    emit("ensemble_fixed", n_queries=int(queries.shape[0]), k=K,
         hash_times=MT_HASH_TIMES, recall_at_10=recall,
         mean_n_candidates=float(n_cand.mean()), fixed_vs_windowed=agree,
         cap=lay.cap, layout_rows=lay.n_rows, layout_gib=gib,
         layout_build_s=build_s, launches=launches, **timed,
         qps=queries.shape[0] / timed["median_s"])
    fixed_launches = launches

    midx.engine = "windowed"
    midx.serving_dtype = torch.int8
    lay, build_s, gib = layout_of()
    check(lay.data.dtype == torch.int8 and lay.scale.shape == (lay.n_rows,),
          "the int8 stacked layout has one scale per stored row")
    g_cal = midx.calibrate(queries, **kw)
    reset_launches()
    ids, n_cand = serve()
    launches = read_launches("windowed_scores_topk")
    check(bool(np.array_equal(n_cand, mt_cand)),
          "ensemble int8: summed n_candidates differ from f32")
    for row in ids[:200]:
        real = row[row >= 0]
        check(len(set(real)) == len(real), "int8: duplicate ids after dedupe")
    recall = float(calculate_recall(gt[:, :K], ids, np.mean))
    check(MT_INT8_RECALL_RANGE[0] <= recall <= MT_INT8_RECALL_RANGE[1],
          f"ensemble int8 recall@10 {recall} outside {MT_INT8_RECALL_RANGE}")
    p_ids, _ = midx.query(queries[:MT_GATHER_QUERIES], k=K, plain=True, **kw)
    vs_plain = id_agreement(p_ids, ids[:MT_GATHER_QUERIES])
    check(vs_plain >= 0.999, f"ensemble int8 K3 vs plain {vs_plain} < 0.999")
    timed = _timed_passes(serve, 3)
    emit("ensemble_int8", n_queries=int(queries.shape[0]), k=K,
         hash_times=MT_HASH_TIMES, scale_mode=midx.int8_scale,
         recall_at_10=recall, mean_n_candidates=float(n_cand.mean()),
         int8_vs_f32_ids=id_agreement(mt_ids, ids), k3_vs_plain=vs_plain,
         groups_calibrated=g_cal, layout_rows=lay.n_rows,
         layout_gib_f32=f32_gib, layout_gib_int8=gib, layout_build_s=build_s,
         launches=launches, **timed, qps=queries.shape[0] / timed["median_s"])
    midx.serving_dtype = torch.float32
    return fixed_launches, launches


def _seeded_head(kind: str, hash_size: int, seed: int, dim: int = 100,
                 hidden=(256, 256)):
    """A head with weights drawn from a seeded ``torch.Generator``: the
    SIREN trunk's own bounds, ``1/sqrt(fan_in)`` for the output layer."""
    import math

    import torch

    from nlsh_tpu_torch.models import get_encoder, get_hashing

    gen = torch.Generator().manual_seed(seed)
    head = get_hashing(kind, get_encoder("siren", dim, list(hidden)),
                       hash_size)

    def draw(t, bound):
        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)

    with torch.no_grad():
        for i, layer in enumerate(head.encoder.layers):
            bound = 1.0 / layer.in_features if i == 0 else \
                math.sqrt(6.0 / layer.in_features) / head.encoder.w0
            draw(layer.weight, bound)
            draw(layer.bias, bound)
        bound = 1.0 / math.sqrt(head.out.in_features)
        draw(head.out.weight, bound)
        draw(head.out.bias, bound)
    return head.eval()


def phase_heads(corpus: np.ndarray, queries: np.ndarray) -> dict:
    """The other two heads at the bench width (SIREN 100-256-256;
    Categorical over 4,096 buckets; product quantisation, 3 bands of 4
    bits), seeded weights: each indexes the first 262,144 rows and the
    grouped serve (K1) is held to the gather engine; the PQ flip probes
    are pairwise distinct at 16 and 256 probes."""
    import torch

    from nlsh_tpu_torch.index import Indexer

    rows, qs = corpus[:HEAD_ROWS], queries[:HEAD_QUERIES]
    kw = dict(k=K, hash_times=HEAD_PROBES, probe_mode="flip")
    out = {}
    for kind, seed in (("Categorical", 11), ("ProductQuantization", 12)):
        head = _seeded_head(kind, 4096 if kind == "Categorical" else 12, seed)
        check(head.n_buckets == 4096, f"{kind}: n_buckets")
        idx = Indexer(head, rows, device=DEVICE, metric="cosine",
                      probe_budget=CAP, engine="gather")
        x_ids, x_cand = idx.query(qs, **kw)
        idx.engine = "grouped"
        _ = idx.layout
        reset_launches()
        g_ids, g_cand = idx.query(qs, **kw)
        launches = read_launches("grouped_scores_topk")
        check(bool(np.array_equal(g_cand, x_cand)),
              f"{kind}: n_candidates differ between the engines")
        has = (x_ids >= 0).any(axis=1)       # probed a non-empty bucket
        check(bool(np.array_equal(has, (g_ids >= 0).any(axis=1)))
              and has.mean() >= 0.9, f"{kind}: queries without candidates")
        agree = id_agreement(x_ids[has], g_ids[has])
        check(agree >= 0.98, f"{kind}: grouped vs gather {agree} < 0.98")
        out[kind] = {"buckets_used": idx.n_buckets_used(),
                     "queries_with_candidates": float(has.mean()),
                     "max_bucket": idx.table.max_count(),
                     "mean_n_candidates": float(g_cand.mean()),
                     "grouped_vs_gather": agree, "launches": launches}
        if kind == "ProductQuantization":
            check((head.n_bands, head.bits_per_band) == (3, 4), "PQ bands")
            q = torch.as_tensor(qs, device=DEVICE)
            for n_probes in (16, 256):
                with torch.no_grad():
                    pid, pv = head.hash(q, n_probes=n_probes,
                                        probe_mode="flip")
                s = torch.sort(pid, dim=1).values
                check(pid.shape == (qs.shape[0], n_probes) and bool(pv.all())
                      and bool((s[:, 1:] != s[:, :-1]).all()),
                      f"PQ flip probes repeat at {n_probes} probes")
            out[kind]["flip_probes_distinct_at"] = [16, 256]
        del idx
    emit("heads", n_rows=HEAD_ROWS, n_queries=HEAD_QUERIES,
         hash_times=HEAD_PROBES, probe_budget=CAP, **out)
    return {"grouped_scores_topk": sum(
        o["launches"]["grouped_scores_topk"] for o in out.values())}


def phase_serve_cli(restored, queries: np.ndarray, tmp: str) -> dict:
    """The serving CLI: ``cli.serve.main`` on the synthetic dataset with a
    small head's artifact, twice with one ``--index_path`` (build and
    save, then restore: the same answers); then ``serve_loop`` on the
    full-size restored index with an in-memory stream of 200 requests of
    1 to 512 queries and one malformed line: answers in order, the error
    in its place, each answer held to ``Indexer.query`` on the same rows."""
    import contextlib
    import io

    from nlsh_tpu_torch.cli import serve as cli
    from nlsh_tpu_torch.utils.checkpoint import save_model

    os.environ["NLSH_SYNTH_CACHE_DIR"] = os.path.join(tmp, "synth_cache")
    base = os.path.join(tmp, "small_head")
    save_model(base, _seeded_head("MultivariateBernoulli", 8, 13, dim=32,
                                  hidden=(64, 64)))
    index_path = os.path.join(tmp, "small_index.npz")
    runs = []
    for name in ("built", "restored"):
        check(os.path.exists(index_path) == (name == "restored"),
              "the first run builds the index file, the second finds it")
        out_path = os.path.join(tmp, f"answers_{name}.npz")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            result = cli.main(["--model_path", base, "--data_id", "synthetic",
                               "--index_path", index_path, "--probe_mode",
                               "flip", "--batch", "64", "--output", out_path])
        lines = printed.getvalue().strip().splitlines()
        check(len(lines) == 1 and json.loads(lines[0]) == result,
              "the CLI prints its result as one JSON line")
        check({"n_queries", "qps", "query_size", "build_s", "engine", "k",
               "hash_times", "recall_at_k"} <= set(result), "result keys")
        with np.load(out_path) as z:
            runs.append((result, z["topk_ids"], z["n_candidates"]))
    (r1, ids1, cand1), (r2, ids2, cand2) = runs
    check(bool(np.array_equal(ids1, ids2))
          and bool(np.array_equal(cand1, cand2)),
          "the restored index answers differently")
    check(r1["engine"] == r2["engine"] == "auto"
          and 0.0 < r1["recall_at_k"] == r2["recall_at_k"] <= 1.0, "CLI result")

    # the request loop on the full-size restored index
    rng = np.random.default_rng(21)
    requests, lines = [], []
    for rid in range(LOOP_REQUESTS):
        rows = np.round(queries[rng.choice(
            queries.shape[0], int(rng.integers(1, LOOP_MAX_BATCH + 1)),
            replace=False)
        ].astype(np.float64), 4)
        requests.append(rows.astype(np.float32))
        lines.append(json.dumps({"id": rid, "queries": rows.tolist()}))
    bad_at = 57
    lines.insert(bad_at, '{"id": "bad", "queries": [[1.0, 2.0]]')
    args = cli.nlsh_serve_argparse().parse_args(
        ["--model_path", base, "--data_id", "synthetic", "-k", str(K),
         "--hash_times", str(HASH_TIMES), "--probe_mode", "flip"])
    check(args.device == "cuda", "the CLI defaults to the card")
    kw = dict(k=K, hash_times=HASH_TIMES, probe_mode="flip")
    restored.query(requests[0], **kw)
    out = io.StringIO()
    reset_launches()
    stats = cli.serve_loop(args, restored, {"probe_mode": "flip"},
                           queries.shape[1],
                           stdin=io.StringIO("\n".join(lines) + "\n"),
                           stdout=out)
    launches = read_launches("grouped_scores_topk")
    answers = [json.loads(line) for line in out.getvalue().splitlines()]
    check(len(answers) == LOOP_REQUESTS + 2 and answers[-1] == {"stats": stats},
          "one answer per line, then the stats line")
    check(set(answers[bad_at]) == {"id", "error"}
          and answers[bad_at]["id"] is None, "the error answer's place")
    got = answers[:bad_at] + answers[bad_at + 1:-1]
    check([a["id"] for a in got] == list(range(LOOP_REQUESTS)),
          "answers out of order")
    exact, worst = 0, 1.0
    for answer, rows in zip(got, requests):
        ids = np.asarray(answer["topk_ids"], np.int32)
        want_ids, want_cand = restored.query(rows, **kw)
        check(ids.shape == (rows.shape[0], K)
              and answer["n_candidates"] == want_cand.tolist(),
              "loop answer: shape or n_candidates")
        exact += bool(np.array_equal(ids, want_ids))
        worst = min(worst, id_agreement(want_ids, ids))
    check(worst >= 0.999, f"a loop answer differs from Indexer.query: {worst}")
    check(stats["n_queries"] == sum(r.shape[0] for r in requests)
          and stats["batches"] == LOOP_REQUESTS, "loop stats")
    emit("serve_cli", cli_built=r1, cli_restored=r2, cli_answers_equal=True,
         loop_requests=LOOP_REQUESTS, loop_malformed_at=bad_at,
         loop_answers_bitwise=exact, loop_worst_agreement=worst,
         loop_launches=launches, stats=stats)
    return launches


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile 3 fixed-cap and 3 ensemble serve "
                             "passes")
    args = parser.parse_args()
    import bench  # fails, before any output, outside a checkout of the repo
    import nlsh_tpu_torch  # noqa: F401

    info = phase_device()
    phase_build()
    phase_kernels()
    phase_fixed_kernels()
    launches, times = {}, {}
    k7_launches, times["int8_block_scores"] = phase_int8_probe()
    launches.update(k7_launches)

    corpus, queries = bench.glove100_workload(np.random.default_rng(bench.SEED))
    with np.load(GT) as z:
        gt = z["gt"]
    idx, build_s = phase_index(corpus)
    ids, n_cand, serve_launches = phase_serve(idx, queries, gt)
    launches.update(serve_launches)
    times.update(phase_kernel_times(idx, queries))
    phase_parity(corpus, queries, idx, ids)
    launches.update(phase_windowed(idx, queries, gt, ids, n_cand))
    launches.update(phase_fixed(idx, queries, gt, ids, n_cand))
    if args.profile:
        phase_fixed_profile(idx, queries)
    fixed_times, k6_launches = phase_fixed_kernel_times(idx, queries)
    times.update(fixed_times)
    launches.update(k6_launches)
    phase_int8(idx, queries, gt, n_cand)

    midx, mt_build_s = phase_ensemble_index(corpus)
    mt_ids, mt_cand, mt_launches = phase_ensemble_serve(midx, queries, gt)
    launches.update(mt_launches)
    if args.profile:
        phase_ensemble_profile(midx, queries)
    times.update(phase_ensemble_kernel_times(midx, queries))
    phase_ensemble_parity(midx, queries, mt_ids, mt_cand)
    phase_ensemble_guard(midx, queries, mt_ids, mt_cand)

    # the serving process: every path below runs kernels launched above
    # from new callers, with the counts set to 0 just before each
    new_callers = {}
    with tempfile.TemporaryDirectory() as tmp:
        phase_artifact(corpus, tmp)
        restored, new_callers["persist"] = phase_persist(
            idx, midx, corpus, queries, gt, (ids, n_cand, build_s),
            (mt_ids, mt_cand, mt_build_s), tmp)
        phase_host_layout(idx, queries, ids, n_cand)
        del idx
        new_callers["ensemble_fixed"], new_callers["ensemble_int8"] = \
            phase_ensemble_engines(midx, queries, gt, mt_ids, mt_cand)
        del midx
        serve_s = float(np.median(_timed_passes(lambda: restored.query(
            queries, k=K, hash_times=HASH_TIMES, probe_mode="flip"),
            3)["pass_s"]))
        new_callers["updates"] = phase_updates(corpus, queries, gt, serve_s)
        new_callers["heads"] = phase_heads(corpus, queries)
        new_callers["serve_cli"] = phase_serve_cli(restored, queries, tmp)
        del restored

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_share", "library_ms", "library_note")
    extra = ("device_ms", "library_device_ms", "ms_note")  # K7's
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name],
         "new_callers": {phase: got[name] for phase, got
                         in new_callers.items() if name in got},
         **{k: times[name][k] for k in keys},
         **{k: times[name][k] for k in extra if k in times[name]}}
        for name, (replaces, src) in REPLACES.items()
    ]}), flush=True)
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
