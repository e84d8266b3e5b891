#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one GPU and check it.

    python3 chip_smoke.py          # from the repo root, on a CUDA machine

Phases, one JSON line each: the device (and the ``nvidia-smi`` name and
power limit line), the kernel build, K1/K2 against their plain PyTorch
versions on the card, the index build on the bench workload
(1,183,514 x 100 from ``bench.glove100_workload`` with seed 0, the
committed trained params), the serve of all 10,000 queries through
``Indexer.query`` (recall@10 against the committed exact ground truth,
QPS), and engine parity.  Then one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no result line is printed.  Needs no network and
imports nothing of JAX.
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

K = 10
HASH_TIMES = 16
CAP = 512
RECALL_RANGE = (0.7416, 0.7436)      # exact-f32 JAX on the CPU: 0.74264
N_CAND_RANGE = (4665.0, 4676.0)      # exact-f32 JAX on the CPU: 4670.30
SCORE_TOL = 1e-5                     # kernel vs plain, unit-scale scores
TIE_TOL = 1e-6                       # lanes compared only off such ties
SLICE_ROWS, SLICE_QUERIES = 65_536, 512
DEVICE = "cuda"


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
    path = build.build()
    build.load_library()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "smem" in ln]
    emit("build", build_s=time.perf_counter() - t0, nvcc_s=build.build_seconds,
         library=os.path.relpath(path, ROOT), ptxas=ptxas)


def _unit_rows(rng, shape) -> np.ndarray:
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _compare_topk(scores, lanes, ref_panel, kk: int) -> float:
    """Hold K1's ``(scores, lanes)`` to the masked plain panel: scores
    within SCORE_TOL, -inf at the same places, lanes equal wherever the
    score is finite and not tied within TIE_TOL, and exact ties in the
    kernel's own output ordered lowest lane first.  Returns the max
    score error."""
    import torch

    ref_v, ref_i = torch.sort(ref_panel, dim=2, descending=True, stable=True)
    ref_v, ref_i = ref_v[..., : kk + 1], ref_i[..., : kk + 1]
    fin = torch.isfinite(ref_v[..., :kk])
    check(bool((torch.isfinite(scores) == fin).all()),
          "K1 -inf pattern differs from the plain version")
    err = float((scores - ref_v[..., :kk])[fin].abs().max()) if fin.any() else 0.0
    check(err <= SCORE_TOL, f"K1 score error {err} > {SCORE_TOL}")
    gap_prev = torch.full_like(ref_v[..., :kk], torch.inf)
    gap_prev[..., 1:] = ref_v[..., 1:kk] - ref_v[..., : kk - 1]
    gap_next = ref_v[..., :kk] - ref_v[..., 1: kk + 1]
    untied = fin & (gap_prev.abs() > TIE_TOL) & (gap_next.abs() > TIE_TOL)
    check(bool((lanes.long() == ref_i[..., :kk])[untied].all()),
          "K1 lanes differ from the plain version off ties")
    same = (scores[..., 1:] == scores[..., :-1]) & torch.isfinite(scores[..., 1:])
    check(bool((lanes[..., 1:] > lanes[..., :-1])[same].all()),
          "K1 broke an exact tie other than lowest lane first")
    return err


def phase_kernels() -> dict:
    """K1 and K2 vs their plain versions on synthetic groups: G=32,
    br=512, d_pad=128, kk 10 and 16, f32 and bf16 corpora, with and
    without norms and scale, empty groups, counts below kk, exact ties."""
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
    emit("kernels", cases=cases, max_abs_err=worst, score_tol=SCORE_TOL,
         tie_tol=TIE_TOL)
    return worst


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
    """The main path's run: every query at k=10 (K1), then every query at
    k=20 (above ROW_TOPK, so K2), through Indexer.query.  Returns the
    k=10 ids and the launch counts of the run."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    def serve(k):
        return idx.query(queries, k=k, hash_times=HASH_TIMES,
                         probe_mode="flip")

    for name in qk.KERNEL_LAUNCHES:
        qk.KERNEL_LAUNCHES[name] = 0
    ids, n_cand = serve(K)
    ids20, _ = serve(2 * K)
    launches = dict(qk.KERNEL_LAUNCHES)
    check(ids.shape == (queries.shape[0], K) and ids20.shape[1] == 2 * K,
          "result shapes")
    check(bool(((ids >= -1) & (ids < idx.corpus.shape[0])).all()), "id range")
    check(all(v > 0 for v in launches.values()),
          f"every kernel of the path must launch: {launches}")
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
    return ids, launches


def phase_kernel_times(idx, queries: np.ndarray) -> dict:
    """K1/K2 and their plain versions at the main path's own shapes (the
    grouped prep of all queries): CUDA-event times and max score error."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    lay = idx.layout
    q = torch.as_tensor(queries, device=idx.device)
    with torch.no_grad():
        pid, pv = idx.hashing.hash(q, n_probes=HASH_TIMES, probe_mode="flip")
    max_blocks = lay.cap // lay.br
    g_total = qk._round_up(qk.grouped_static_bound(
        pid.numel(), max_blocks, lay.total_blocks, 32), qk._GROUP_EB)
    grp_block, grp_qvecs, grp_cnt, *_ = qk._grouped_prep_v2(
        lay.starts, lay.counts, pid, pv, qk.extend_queries(lay, q), lay.cap,
        g_total=g_total, max_blocks=max_blocks, group_q=32, block_rows=lay.br)
    args = (lay.data, grp_qvecs, grp_block)
    out = {}
    k1 = qk.grouped_scores_topk(*args, grp_cnt, K, block_rows=lay.br)
    p1 = qk.grouped_scores_topk_plain(*args, grp_cnt, K, block_rows=lay.br)
    fin = torch.isfinite(p1[0])
    check(bool((torch.isfinite(k1[0]) == fin).all()), "K1 -inf pattern")
    out["grouped_scores_topk"] = {
        "max_abs_err": float((k1[0] - p1[0])[fin].abs().max()),
        "ms": cuda_ms(lambda: qk.grouped_scores_topk(
            *args, grp_cnt, K, block_rows=lay.br), 20),
        "plain_ms": cuda_ms(lambda: qk.grouped_scores_topk_plain(
            *args, grp_cnt, K, block_rows=lay.br), 3),
    }
    k2 = qk.grouped_scores(*args, block_rows=lay.br)
    p2 = qk.grouped_scores_plain(*args, block_rows=lay.br)
    out["grouped_scores"] = {
        "max_abs_err": float((k2 - p2).abs().max()),
        "ms": cuda_ms(lambda: qk.grouped_scores(*args, block_rows=lay.br), 20),
        "plain_ms": cuda_ms(lambda: qk.grouped_scores_plain(
            *args, block_rows=lay.br), 3),
    }
    for name, v in out.items():
        check(v["max_abs_err"] <= SCORE_TOL,
              f"{name} error {v['max_abs_err']} at the main path's shapes")
    emit("kernel_times", g_total=g_total, group_q=32,
         block_rows=lay.br, d_pad=lay.d_pad,
         live_groups=int((grp_cnt.max(dim=1).values > 0).sum()), **out)
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


def main() -> int:
    import bench  # fails, before any output, outside a checkout of the repo
    import nlsh_tpu_torch  # noqa: F401

    info = phase_device()
    phase_build()
    phase_kernels()

    corpus, queries = bench.glove100_workload(np.random.default_rng(bench.SEED))
    with np.load(GT) as z:
        gt = z["gt"]
    idx = phase_index(corpus)
    ids, launches = phase_serve(idx, queries, gt)
    times = phase_kernel_times(idx, queries)
    phase_parity(corpus, queries, idx, ids)

    replaces = {"grouped_scores_topk": "nlsh_tpu/ops/pallas/query_kernel.py:879",
                "grouped_scores": "nlsh_tpu/ops/pallas/query_kernel.py:766"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "nlsh_tpu_torch/csrc/grouped_scores.cu",
         "replaces": replaces[name], "launches": launches[name],
         **times[name]}
        for name in replaces
    ]}), flush=True)
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
