#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths once on one GPU and check them.

    python3 chip_smoke.py            # from the repo root, on a CUDA machine
    python3 chip_smoke.py --profile  # also profile 3 ensemble serve passes

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
  events), and on the per-row int8 layout (grouped K1, fixed-cap K5,
  windowed K3, then one global-scale grouped serve; QPS and the int8
  times of K1-K4);
* the L=8 ensemble (the committed 8-table params, 4 flip probes per
  table): ``MultiTableIndexer`` build, ``calibrate`` and the serve on the
  windowed engine (K3; recall, summed and exact candidates, QPS, all
  with the batch's own calibration), K3/K4 times at the ensemble's group
  tables, parity against the plain scorer and the grouped and gather
  engines, and the guard: after a starved calibration the same batch
  takes the static group bound and answers exactly as before.

Each path's launch counts are set to 0 just before it and read just
after; every kernel must have launched on the path that runs it (K1, K2:
the grouped serve; K3: the ensemble serve; K4: the windowed serve at
k=20; K5: the fixed-cap serve; K6: the serve's events scored by row
offset, since the JAX package has no caller of it; K7: the int8 probe).
Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``.  Any failed check raises, so the exit code is
non-zero and no result line is printed.  Needs no network and imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
GROUPED_SRC = "nlsh_tpu_torch/csrc/grouped_scores.cu"
BUCKET_SRC = "nlsh_tpu_torch/csrc/bucket_scores.cu"
REPLACES = {  # the TPU kernel each CUDA kernel replaces, and its source
    "grouped_scores_topk": ("nlsh_tpu/ops/pallas/query_kernel.py:879",
                            GROUPED_SRC),
    "grouped_scores": ("nlsh_tpu/ops/pallas/query_kernel.py:766",
                       GROUPED_SRC),
    "windowed_scores_topk": ("nlsh_tpu/ops/pallas/query_kernel.py:1372",
                             GROUPED_SRC),
    "windowed_scores": ("nlsh_tpu/ops/pallas/query_kernel.py:1453",
                        GROUPED_SRC),
    "bucket_scores_auto": ("nlsh_tpu/ops/pallas/query_kernel.py:634",
                           BUCKET_SRC),
    "bucket_scores_impl": ("nlsh_tpu/ops/pallas/query_kernel.py:569",
                           BUCKET_SRC),
    "int8_block_scores": ("benchmarks/int8_probe.py:66", GROUPED_SRC),
}


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
             if "registers" in ln or "smem" in ln or ln.startswith("==")]
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


def phase_fixed_kernels() -> dict:
    """K5 and K6 vs their plain versions on synthetic events (cap 512,
    d_pad 128, 256 queries x 16 probes over 64 blocks) for f32, bf16
    and int8 corpora: counts of 0 (invalid probes), of cap and between,
    every query probing the layout's last block, K6 at starts that are
    multiples of 8 but not of cap, and K6 = K5 bitwise at block-exact
    starts.  The int8 cases dot small dyadic queries, so every sum is
    exact and they compare bitwise."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(2)
    cap, d, n_blocks, nq, n_probes = 512, 128, 64, 256, 16
    worst = {"bucket_scores_auto": 0.0, "bucket_scores_impl": 0.0}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        data = _unit_rows(rng, (n_blocks * cap, d))
        q = _unit_rows(rng, (nq, d))
        exact = dtype is torch.int8
        if exact:
            scale = np.abs(data).max(axis=1, keepdims=True) / 127.0
            data = np.clip(np.round(data / scale), -127, 127).astype(np.int8)
            q = (rng.integers(-16, 17, (nq, d)) / 64.0).astype(np.float32)
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
    torch.cuda.synchronize()
    emit("fixed_kernels", cases=3, max_abs_err=worst, score_tol=SCORE_TOL,
         int8="bitwise")
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
    times = {"max_abs_err": float((out - ref).abs().max()),
             "ms": cuda_ms(lambda: qk.int8_block_scores(*t, br), 20),
             "plain_ms": cuda_ms(lambda: qk.int8_block_scores_plain(*t, br), 20)}
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
    return idx


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
    queries on ``lay``: CUDA-event times and max score error."""
    import torch

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
    err = _topk_check("K1", qk.grouped_scores_topk(*args, grp_cnt, K, **kw),
                      qk.grouped_scores_topk_plain(*args, grp_cnt, K, **kw))
    out["grouped_scores_topk"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: qk.grouped_scores_topk(
            *args, grp_cnt, K, **kw), 20),
        "plain_ms": cuda_ms(lambda: qk.grouped_scores_topk_plain(
            *args, grp_cnt, K, **kw), 3),
    }
    err = _panel_err("K2", qk.grouped_scores(*args, block_rows=lay.br),
                     qk.grouped_scores_plain(*args, block_rows=lay.br), lay,
                     grp_block)
    out["grouped_scores"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: qk.grouped_scores(*args, block_rows=lay.br), 20),
        "plain_ms": cuda_ms(lambda: qk.grouped_scores_plain(
            *args, block_rows=lay.br), 3),
    }
    torch.cuda.synchronize()
    return {"g_total": g_total, "group_q": 32, "block_rows": lay.br,
            "d_pad": lay.d_pad,
            "live_groups": int((grp_cnt.max(dim=1).values > 0).sum()),
            "kernels": out}


def _windowed_times(lay, q, pid, pv, g_total: int, panel_reps: int) -> dict:
    """K3/K4 and their plain versions at the windowed prep of the probes
    ``(pid, pv)`` on ``lay`` with ``g_total`` groups: CUDA-event times
    and max score error."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    grp_window, grp_qvecs, grp_lo, grp_hi, *_ = qk._windowed_prep(
        lay.starts, lay.counts, pid, pv, qk.extend_queries(lay, q), lay.cap,
        g_total=g_total, max_sub=lay.cap // lay.br + 1, group_q=qk.GROUP_W,
        block_rows=lay.br)
    args = (lay.data, grp_qvecs, grp_window)
    topk = (grp_lo, grp_hi, K)
    kw = dict(block_rows=lay.br, norms=lay.norms, scale_rows=_row_scale(lay))
    out = {}
    err = _topk_check("K3", qk.windowed_scores_topk(*args, *topk, **kw),
                      qk.windowed_scores_topk_plain(*args, *topk, **kw))
    out["windowed_scores_topk"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: qk.windowed_scores_topk(*args, *topk, **kw), 20),
        "plain_ms": cuda_ms(lambda: qk.windowed_scores_topk_plain(
            *args, *topk, **kw), 3),
    }
    err = _panel_err("K4", qk.windowed_scores(*args, block_rows=lay.br),
                     qk.windowed_scores_plain(*args, block_rows=lay.br), lay,
                     grp_window)
    out["windowed_scores"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: qk.windowed_scores(*args, block_rows=lay.br),
                      panel_reps),
        "plain_ms": cuda_ms(lambda: qk.windowed_scores_plain(
            *args, block_rows=lay.br), 3),
    }
    torch.cuda.synchronize()
    live = grp_hi > grp_lo
    return {"g_total": g_total, "group_q": qk.GROUP_W, "block_rows": lay.br,
            "d_pad": lay.d_pad, "live_groups": int(live.any(dim=1).sum()),
            "live_slots": int(live.sum()), "kernels": out}


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


def _fixed_times(lay, q, pid, pv):
    """K5 and K6 and their plain versions on the fixed-cap events of the
    probes ``(pid, pv)`` on the cap-aligned ``lay``: K6 runs first, on the
    events by row offset (starts = block_idx * cap), and must equal K5
    bitwise; scores are compared in dequantised units on a per-row int8
    layout.  Returns K6's launch count, the times and the live rows."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    qe = qk.extend_queries(lay, q)
    safe, counts = qk._probe_counts(lay.counts, pid, pv, lay.cap)
    counts = counts.to(torch.int32)
    starts = torch.clamp(lay.starts[safe], max=lay.n_rows - lay.cap)
    starts = starts.to(torch.int32)
    block_idx = starts // lay.cap
    five = (lay.data, qe, block_idx, counts, lay.cap)
    six = (lay.data, qe, starts, counts, lay.cap)
    reset_launches()
    k6 = qk.bucket_scores_impl(*six)
    launches = read_launches("bucket_scores_impl")
    k5 = qk.bucket_scores_auto(*five)
    check(bool(torch.equal(k5, k6)), "K6 differs from K5 on the serve's events")
    del k6
    p5 = qk.bucket_scores_auto_plain(*five)
    scale = _row_scale(lay)
    if scale is not None:
        w = scale.view(-1, lay.cap)[block_idx.long()]
        k5, p5 = k5 * w, p5 * w
    err = _masked_err("K5", k5, p5, False)
    del k5, p5
    out = {
        "bucket_scores_auto": {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: qk.bucket_scores_auto(*five), 20),
            "plain_ms": cuda_ms(lambda: qk.bucket_scores_auto_plain(*five), 3)},
        "bucket_scores_impl": {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: qk.bucket_scores_impl(*six), 20),
            "plain_ms": cuda_ms(lambda: qk.bucket_scores_impl_plain(*six), 3)},
    }
    return launches, out, int(counts.sum())


def phase_fixed_kernel_times(idx, queries: np.ndarray):
    """K5 and K6 and their plain versions on the fixed-cap serve's own
    events (the probes of all queries on the cap-aligned f32 layout).
    K6 has no caller in the JAX package: its path here is these events
    scored by row offset.  Returns the times and K6's launch count."""
    lay = idx.layout
    q, pid, pv = _probes(idx, queries)
    launches, out, live_rows = _fixed_times(lay, q, pid, pv)
    gbs = {n: live_rows * lay.d_pad * lay.data.element_size() / v["ms"] / 1e6
           for n, v in out.items()}
    emit("fixed_kernel_times", n_events=pid.numel(), cap=lay.cap,
         d_pad=lay.d_pad, live_rows=live_rows, live_row_gb_per_s=gbs,
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
    return midx


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


def phase_ensemble_profile(midx, queries: np.ndarray) -> None:
    """``torch.profiler`` over 3 ensemble serve passes (``--profile``):
    the unprofiled wall time per pass, the device time per pass, and the
    costliest kernels and copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kw = dict(k=K, hash_times=MT_HASH_TIMES, probe_mode="flip")
    t0 = time.perf_counter()
    for _ in range(3):
        midx.query(queries, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            midx.query(queries, **kw)
        torch.cuda.synchronize()
    # device-side events only: an operator's own entry repeats the time
    # of the kernels it launched
    ops = [e for e in prof.key_averages()
           if e.device_type != torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in ops) / 3e3
    check(device_ms > 0, "the profile saw no device time")
    emit("ensemble_profile", passes=3, wall_ms_per_pass=wall_ms,
         device_ms_per_pass=device_ms,
         device_events_per_pass=sum(e.count for e in ops) / 3,
         top=[{"op": e.key[:80], "ms_per_pass": e.self_device_time_total / 3e3,
               "calls_per_pass": e.count / 3} for e in ops[:15]])


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


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile 3 ensemble serve passes")
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
    idx = phase_index(corpus)
    ids, n_cand, serve_launches = phase_serve(idx, queries, gt)
    launches.update(serve_launches)
    times.update(phase_kernel_times(idx, queries))
    phase_parity(corpus, queries, idx, ids)
    launches.update(phase_windowed(idx, queries, gt, ids, n_cand))
    launches.update(phase_fixed(idx, queries, gt, ids, n_cand))
    fixed_times, k6_launches = phase_fixed_kernel_times(idx, queries)
    times.update(fixed_times)
    launches.update(k6_launches)
    phase_int8(idx, queries, gt, n_cand)
    del idx

    midx = phase_ensemble_index(corpus)
    mt_ids, mt_cand, mt_launches = phase_ensemble_serve(midx, queries, gt)
    launches.update(mt_launches)
    if args.profile:
        phase_ensemble_profile(midx, queries)
    times.update(phase_ensemble_kernel_times(midx, queries))
    phase_ensemble_parity(midx, queries, mt_ids, mt_cand)
    phase_ensemble_guard(midx, queries, mt_ids, mt_cand)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **times[name]}
        for name, (replaces, src) in REPLACES.items()
    ]}), flush=True)
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
