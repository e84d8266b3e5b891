#!/usr/bin/env python3
"""Drive the port's serving and training paths once on one GPU and check them.

    python3 chip_smoke.py            # from the repo root, on a CUDA machine
    python3 chip_smoke.py --profile  # also profile the fixed-cap and the
                                     # ensemble serve, 3 passes each, and
                                     # the training step, eager and
                                     # replayed

Phases, one JSON line each: the device (and the ``nvidia-smi`` name and
power limit line), the kernel build (one ``nvcc`` per source, in
parallel), K1-K4 and K5/K6 against their plain PyTorch versions on
synthetic operands (f32, bf16 and int8 corpora), K7 (the int8 block
probe) on the probe's own operands, then two paths on the bench workload
(1,183,514 x 100 from ``nlsh_tpu_torch.data.workloads``'s
``glove100_workload`` with seed 0, 10,000
queries, recall@10 against the committed exact ground truth):

* the single table (the committed trained params, 16 flip probes, cap
  512): index build, the serve through ``Indexer.query`` on the grouped
  engine (K1 at k=10, K2 and K8 at k=20; QPS), kernel times (K8 on K2's
  panel of every query at kk 100, the k = 100 serve's shapes: bit for bit
  its plain version, and ``torch.topk`` on composite keys giving its
  lanes), engine parity, the same serve on the windowed engine (K3 at
  k=10, K4 and K8 at k=20), on the fixed-cap engine (K5; QPS, with K5/K6
  times on the serve's own events: the whole wrapper call, of which
  ``grouping_ms`` sorts the events and ``kernel_ms`` is the launch; K5's
  live lanes bitwise equal to K2's panel; and K5 at a table of 16 random
  distinct buckets per query), and on the per-row int8 layout (grouped K1,
  fixed-cap K5, windowed K3, then one global-scale grouped serve; QPS and
  the int8 times of K1-K4), and on the bf16 layout (``bf16``: the grouped
  serve, K1 on bf16 rows, recall within 0.001 of the port's plain CPU
  serve, candidates, the layout's GiB, QPS);
* the L=8 ensemble (the committed 8-table params, 4 flip probes per
  table): ``MultiTableIndexer`` build, ``calibrate`` and the serve on the
  windowed engine (K3; recall, summed and exact candidates, QPS, all
  with the batch's own calibration), K3/K4 times at the ensemble's group
  tables, parity against the plain scorer and the grouped and gather
  engines, and the guard: after a starved calibration the same batch
  takes the static group bound and answers exactly as before;
* the one-dispatch serves (every ``Indexer.query`` and the ensemble's
  windowed and fixed-cap ``query`` on the card replay a captured CUDA
  graph, ``nlsh_tpu_torch.utils.graphs``): ``fused`` (after ``int8``)
  holds ``_fused_serve``'s replay to the eager body of the same batch
  bit for bit on the grouped, windowed and fixed-cap engines (f32; k =
  10 and, for K2 / K4, k = 20) and the per-row int8 grouped engine,
  recall and candidates in their windows, and times the eager and the
  replayed pass, each one's device busy share (``torch.profiler``),
  ``_fused_serve_batched``'s QPS over ``workloads.glove100_fresh_pool(16)``
  (16 x 10,000 fresh queries in one replay) and each graph's memory
  pool; ``ensemble_fused`` (after ``ensemble_guard``) does the same for
  ``_fused_mt_serve`` on the windowed engine at the batch's calibration
  and on the fixed-cap engine, and forces the guard: at a starved
  calibration ONE replay, whose conditional node takes the static-bound
  branch on the card with no host sync, gives the calibrated serve's
  answer (the two-branch graph's pool beside the static graph's).
  The gather engine serves in one replayed graph per batch too:
  ``parity`` (the single table, full size, and the 65,536-row slice),
  ``ensemble_parity``, ``updates`` and ``sharded`` hold each replay to
  its eager body bit for bit, with eager and replayed passes, busy
  shares, the graph's pool and capture seconds.

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
  serve then fetches k + 1,024 per query and runs K2 and K8, not K1), the
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

Then offline evaluation, each phase one line, timed with
``utils.profiling.PhaseTimer``:

* ``eval_flip``: ``cli.evaluate.run_sweep`` on the grouped engine (K1),
  flip probes 1..16 at the largest bucket's probe budget (no bucket
  cut): every (candidates, recall) pair within 0.01 / 0.001 of the JAX
  package's exact-f32 CPU values (``eval_anchor.py``); the sweep replays
  one graph for every value (``sweep_step``), held to its eager body
  (``sweep_body``) at every value, with ms per value of each;
* ``eval_sample``: the reference's own sweep, sampled probes 1..100 (seed
  0) on the grouped engine: the curve, ``sweep_s`` and ms per value; one
  probe equals ``eval_flip``'s, candidates never fall, recall(100) >=
  recall(1); on the same raw codes at 1, 16 and 100 probes the windowed
  (K3), fixed-cap (K5) and gather engines give the grouped engine's
  candidates and its ids on >= 0.999 of the slots; each engine's ms per
  value at 100 probes, eager and replayed, and K5's whole call on those
  100 probes' events;
* ``eval_ensemble``: ``run_sweep_multitable`` on the 8-table params,
  flip, 1..4 probes per table, windowed engine (K3), against the JAX
  package's CPU values;
* ``eval_cli``: ``cli.evaluate.main`` on the synthetic dataset for a
  single-table and an 8-table artifact of seeded heads, on the card and
  on the CPU: the printed lines are identical;
* ``hnsw``: ``native.NativeHNSW`` on the first 16,384 corpus rows, 1,000
  queries, cosine, M=10, ef_construction=500, ef 40 and 100, against
  the exact kNN from ``ops.knn.knn`` on the card: recall and mean visit
  count equal the JAX package's (``eval_anchor.py``); ``build_s`` and
  QPS are the host's; then ``cli.train --learner_type hnsw`` on the
  synthetic dataset.

Then training, at the bench's training configuration (SIREN
100->256->256, 12-bit MVB, triplet with margin 0.5, positive_k 20 and
balance lambda 1.5, batch 2048, lr 1e-3, seed 0) on its 131,072-row
subset (drawn, as ``bench.py`` draws it, from the workload's generator),
each phase one line:

* ``train_knn``: the subset's self-kNN (k = 20) on the card against the
  committed ``sub_knn``: ids agree on >= 0.999 of the slots, and rows
  differ only at ties;
* ``train_step``: from the committed params, on the same injected
  arrays, step 1's loss and every gradient on the card within rtol 1e-4
  of the CPU's, the first 20 steps' losses within rtol 1e-3; then on the
  card the 20 steps replayed (``Trainer.run_segment``: every step a
  replay of the captured ``StepProgram``) against the eager body's
  (``_run_segment_eager``): two eager runs are compared first, and where
  they agree bit for bit the replay must too;
* ``train_fused``: the same replay-against-eager check for the single
  table and the L=8 ensemble (8 seeded tables), then for each the
  step's time eager and replayed, each one's device busy share
  (``torch.profiler``), the capture's seconds and the step graph's pool;
  the step launches no hand-written kernel;
* ``train``: ``TripletTrainer.fit`` for 1,000 steps with an eval every
  500 (K1 from the trainer), then the full corpus indexed with the
  trained module and served at 16 flip probes, cap 512: recall@10 in
  [0.730, 0.755] and mean candidates in [4400, 4950] (the JAX package's
  fit at seeds 0 and 1 lands at 0.73949 / 4670.52 and 0.74233 / 4667.84,
  ``train_anchor.py``), ``train_s``, steps/s, each eval's seconds and,
  of them, the seconds spent capturing its serve's graphs, and the step
  graph's capture seconds and pool;
* ``train_ensemble``: ``MultiTableTrainer(L=8)`` at
  ``benchmarks/mt_highrecall.py``'s configuration, 600 steps and one
  eval (K3 from the trainer), then the full corpus at 4 flip probes per
  table on the windowed engine: recall@10 >= 0.985; the same timings;
* ``train_cli``: ``nlsh_tpu_torch.cli.train.main`` on the synthetic
  dataset with the JSONL logger: its checkpoint loads and serves, and
  ``--resume_from`` continues at the saved step; the same timings.

Then the multi-device layer, on the one card through meshes that name it
more than once (the entries run one after another).  Such a mesh runs
each of the JAX package's multi-device programs as one captured CUDA
graph replayed per step or batch (``Mesh.on_one_device``): the
data-parallel step (``parallel.dp.DPStepProgram``), the sharded serve
(``ShardedIndexer._serve_body``) and the table-sharded ensemble's
windowed and fixed-cap serve (``MultiTableIndexer._mesh_serve_body``).
Each phase one line:

* ``ensemble_sharded`` (after ``ensemble_int8``): the committed 8-table
  ensemble over 4 entries (2 tables each) on the windowed (K3), grouped
  (K1) and fixed-cap (K5) engines: ids >= 0.999 of the unsharded serve's,
  recall and summed candidates in the ensemble's windows; the gather
  engine's psum of distinct counts >= the exact count (1,000 queries);
  on the windowed and fixed-cap engines the replay equals the body run
  eagerly bit for bit (``replay_equals_eager``), with ``eager_pass_ms``
  / ``replay_pass_ms`` (5 fetched passes each, and their medians),
  ``busy`` (each one's device busy share, ``torch.profiler``) and the
  graph's ``graph_pool_mib``;
* ``train_dp``: the bench's training step over 2 entries of the card
  against the same data-parallel runner over 2 CPU entries (step 1's
  loss and gradients rtol 1e-4, 20 losses rtol 1e-3); on the card the
  20 steps replayed against the eager body's (``replay_bitwise``: losses,
  params and moments, where two eager runs agree), both held to the
  CPU's losses (``replayed_losses_rel_err``, ``eager_losses_rel_err``);
  then ``eager_step_ms`` / ``replayed_step_ms``, ``eager_busy`` /
  ``replayed_busy``, ``capture_s`` and ``graph_pool_mib``;
* ``sharded``: ``ShardedIndexer`` over one entry and over 4, on the
  grouped, windowed, fixed-cap and gather engines: recall and candidates
  in the single table's windows and equal per query to an ``Indexer``
  at the largest bucket's cap, ids >= 0.999; per-row int8 grouped in the
  int8 window; ``save``/``load`` at 4 entries, refused on one; on the
  grouped, windowed and fixed-cap engines the replay against the eager
  body, with the same fields as ``ensemble_sharded``'s;
* ``config5``: ``benchmarks/configs.py``'s deep-image-96 10M x 96 (seed
  0), exact ground truth on the card, a 14-bit SIREN fitted as
  ``config_5`` fits it through ``fit(mesh=make_mesh(axis="data"))``
  (every step a replay of one graph: ``train_s`` beside
  ``train_s_eager_before``, the fit with its steps eager; the step
  graph's ``step_capture_s`` and ``step_graph_pool_mib``), and the bf16
  grouped serve at 16 flip probes, lazy corpus on one entry against 4
  entries built on the card (candidates equal, ids >= 0.999; on 500
  queries K1 against its plain version, and the exact f32 gather
  engine's candidates and ranking within bf16's rounding bound): recall,
  build and pass times, QPS at 2,000 and 16,384 queries, peak device
  memory.

Then BASELINE's configurations 1, 2 and 4 and the product-quantisation
one (``benchmarks/configs.py``'s ``config_1``, ``config_2``, ``config_4``
and ``config_pq`` on their synthetic stand-ins, as
``nlsh_tpu_torch.data.configs`` holds them, the kNN on the card), trained
through ``TripletTrainer.fit`` (config 4: ``MultiTableTrainer`` of it)
and served through ``Indexer`` / ``MultiTableIndexer``, each phase one
line:

* ``config1``: glove-25 shape, 100,000 x 25, cosine;
  ``MultivariateBernoulli(TwoLayer256Relu(25), 8)`` fitted 400 steps
  (balance 0, batch 1024), served at 10 sampled probes from a CUDA
  generator on the grouped engine at the largest bucket's budget;
* ``config2``: sift-128 shape, 1,000,000 x 128, euclidean; a 12-bit
  SIREN 128->256->256 fitted 400 steps on a 131,072-row subset (balance
  1.5, batch 2048), served f32 grouped at 16 flip probes;
* ``config4``: glove-100 shape, 200,000 x 100, cosine; eight 10-bit
  ``MultivariateBernoulli`` tables on SIREN 100->128->128 fitted jointly
  300 steps (batch 1024), one f32 flat layout on the windowed engine
  (K3), calibrated on the first 10,000 corpus rows at one probe a table,
  the 10,000 queries at one probe a table (each table's hard code); the
  branch the guard took, and the same batch on both branches;
* ``configpq``: glove-100 shape, 200,000 x 100, cosine; a 12-bit
  ``ProductQuantization`` head (3 bands of 4 bits) on SIREN
  100->256->256 fitted 400 steps (batch 2048), served bf16 grouped (K1)
  at 10 sampled probes from a CUDA generator.

Each holds recall@10 and mean candidates (config 4: the exact distinct
count, ``exact_query_size``) to the windows of the JAX package's own fits
(``train_anchor.py --config <name>``), the serve to the gather engine on
the same probes (candidates equal per query; ids >= 0.98 on f32 layouts,
on pq's bf16 layout every differing id within bf16's cosine bound) and
K1 / K3 to its plain version on the same layout (1,000 queries:
candidates equal, ids >= 0.999), and reports ``train_s``, ``build_s``,
the pass time, QPS, peak device memory per stage and K1's / K3's time
beside its bound at the serve's shapes (d = 25 on a layout padded to 128
features; d = 128 unpadded; d = 100 padded to 128).

Each path's launch counts are set to 0 just before it and read just
after; every kernel must have launched on the path that runs it (K1, K2:
the grouped serve; K3: the ensemble serve; K4: the windowed serve at
k=20; K5: the fixed-cap serve; K6: the serve's events scored by row
offset, since the JAX package has no caller of it; K7: the int8 probe).
The serving-process and training phases reset and read the counts the
same way; what they launched is each kernel's ``new_callers`` in the
``kernels`` line.

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
network, and imports nothing of JAX, of the JAX package or of its bench
(``bench.py``, ``benchmarks/``): the last check looks for them in
``sys.modules``.  Outside a checkout of the repository it fails before
any output (the port's package and the committed artifacts are missing).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from nlsh_tpu_torch.data import workloads as wl
from nlsh_tpu_torch.data.workloads import id_agreement
from nlsh_tpu_torch.tools.common import (
    ARTIFACTS,
    GT,
    ROOT,
    bench_head,
    bench_index,
    cuda_ms,
    flat_flip_probes,
    flip_probes,
    load_ensemble,
    load_hashing,
)

RECALL_RANGE = (0.7416, 0.7436)      # exact-f32 JAX on the CPU: 0.74264
N_CAND_RANGE = (4665.0, 4676.0)      # exact-f32 JAX on the CPU: 4670.30
SCORE_TOL = 1e-5                     # kernel vs plain, unit-scale scores
TIE_TOL = 1e-6                       # lanes compared only off such ties
SLICE_ROWS, SLICE_QUERIES = 65_536, 512
DEVICE = "cuda"
# the L=8 ensemble at 4 flip probes per table; exact-f32 JAX on the CPU:
# recall@10 0.99211, summed candidates 9539.69, exact query_size 8881.76
MT_RECALL_RANGE = (0.9911, 0.9931)
MT_N_CAND_RANGE = (9535.0, 9545.0)
MT_QUERY_SIZE_RANGE = (8877.0, 8887.0)
MT_GATHER_QUERIES = 1000
# the single table on the per-row int8 layout, grouped engine: the port's
# plain serve on the CPU gives 0.72406 (tests/test_torch_full.py)
INT8_RECALL_RANGE = (0.7231, 0.7251)
# the same table on the bf16 layout, grouped engine: the port's plain
# serve on the CPU (tests/test_torch_full.py BF16_RECALL; the JAX
# package's serve gives the same ids at a cut size,
# tests/test_torch_bench_bf16.py)
BF16_RECALL = 0.73468
BF16_RECALL_TOL = 0.001
TOPK_SRC = "nlsh_tpu_torch/csrc/grouped_topk.cu"
GROUPED_SRC = "nlsh_tpu_torch/csrc/grouped_scores.cu"
BUCKET_SRC = "nlsh_tpu_torch/csrc/bucket_scores.cu"
PANEL_TOPK_SRC = "nlsh_tpu_torch/csrc/panel_topk.cu"
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
    "panel_topk": ("none: jax.lax.top_k, nlsh_tpu/index/serving.py:210, :370",
                   PANEL_TOPK_SRC),
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
LIBRARY_K8 = ("torch.topk(keys, kk) on int64 keys (the masked score's ordered "
              "bits over br - 1 - lane, distinct, so no tie rule) built before "
              "the timed region: the scale, mask, where and key build are "
              "left out, which flatters the library")
K8_KK = 100  # the k = 100 serve's per-slot top-k (glove100-mvb12.k100)


# the card's name and power limit, as phase_device reads them
CARD = {"nvidia_smi": None}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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
    CARD["nvidia_smi"] = smi
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


def phase_index(corpus: np.ndarray):
    import torch

    t0 = time.perf_counter()
    idx = bench_index(corpus)
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
    every query at k=20 (above ROW_TOPK, so K2 and K8), through
    Indexer.query.
    Returns the k=10 ids and candidates, and the launch counts of the
    run."""
    import torch

    from nlsh_tpu_torch.utils.metrics import calculate_recall

    def serve(k):
        return idx.query(queries, k=k, hash_times=wl.HASH_TIMES,
                         probe_mode="flip")

    reset_launches()
    ids, n_cand = serve(wl.K)
    ids20, _ = serve(2 * wl.K)
    launches = read_launches("grouped_scores_topk", "grouped_scores",
                             "panel_topk")
    check(ids.shape == (queries.shape[0], wl.K) and ids20.shape[1] == 2 * wl.K,
          "result shapes")
    check(bool(((ids >= -1) & (ids < idx.corpus.shape[0])).all()), "id range")
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
    mean_cand = float(n_cand.mean())
    check(RECALL_RANGE[0] <= recall <= RECALL_RANGE[1],
          f"recall@10 {recall} outside {RECALL_RANGE}")
    check(N_CAND_RANGE[0] <= mean_cand <= N_CAND_RANGE[1],
          f"mean n_candidates {mean_cand} outside {N_CAND_RANGE}")
    head20 = id_agreement(ids, ids20[:, :wl.K])
    check(head20 >= 0.999, f"k=20 head vs k=10 agreement {head20} < 0.999")

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        serve(wl.K)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    emit("serve", n_queries=int(queries.shape[0]), k=wl.K,
         hash_times=wl.HASH_TIMES, recall_at_10=recall,
         mean_n_candidates=mean_cand, k20_head_agreement=head20,
         launches=launches, pass_s=times, median_s=med,
         qps=queries.shape[0] / med)
    return ids, n_cand, launches


def _row_scale(lay):
    """The per-row int8 scales of a layout, or None."""
    return lay.scale if lay.scale is not None and lay.scale.ndim == 1 else None


def _topk_check(name: str, got, want, relative: bool = False) -> float:
    """A fused kernel's (scores, lanes) against its plain version's: the
    same -inf pattern, scores within SCORE_TOL (``relative``: SCORE_TOL
    times the largest score magnitude, if above 1, for euclidean scores
    ``2 q.c - |c|^2``), lanes equal on >= 0.999 of the finite slots
    (near-ties may swap).  Returns the max error."""
    import torch

    fin = torch.isfinite(want[0])
    check(bool((torch.isfinite(got[0]) == fin).all()), f"{name} -inf pattern")
    check(bool((got[1] == want[1])[fin].float().mean() >= 0.999),
          f"{name} lanes vs plain at the main path's shapes")
    err = float((got[0] - want[0])[fin].abs().max())
    tol = SCORE_TOL * (max(1.0, float(want[0][fin].abs().max()))
                       if relative else 1.0)
    check(err <= tol, f"{name} error {err} > {tol} at the main path's shapes")
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


def _grouped_times(lay, q, pid, pv, panel: bool = True) -> dict:
    """K1/K2 (K1 alone unless ``panel``) and their plain versions at the
    grouped prep of all the queries on ``lay``: CUDA-event times and max
    score error (relative on a euclidean layout).  Bounds count the
    queries' own width (the metric-extended one, cosine and euclidean
    alike), not the layout's padded ``d_pad``."""
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
    k1 = qk.grouped_scores_topk(*args, grp_cnt, wl.K, **kw)
    err = _topk_check("K1", k1,
                      qk.grouped_scores_topk_plain(*args, grp_cnt, wl.K, **kw),
                      relative=lay.metric == "euclidean")
    out["grouped_scores_topk"] = kernel_entry(
        err,
        cuda_ms(lambda: qk.grouped_scores_topk(*args, grp_cnt, wl.K, **kw),
                20),
        cuda_ms(lambda: qk.grouped_scores_topk_plain(*args, grp_cnt, wl.K,
                                                     **kw), 3),
        bounds.topk_counts(*args, None, grp_cnt, wl.K, lay.br, q.shape[1],
                           kw["norms"], kw["scale_rows"]),
        None, NO_LIBRARY_TOPK)
    shape = {"g_total": g_total, "group_q": 32, "block_rows": lay.br,
             "d_pad": lay.d_pad,
             "live_groups": int((grp_cnt.max(dim=1).values > 0).sum()),
             "live_slots": int((grp_cnt > 0).sum()),
             "topk_blocks_per_sm": qk.topk_blocks_per_sm(
                 lay.data.dtype, lay.d_pad, windowed=False)}
    if not panel:
        torch.cuda.synchronize()
        return {**shape, "kernels": out}
    panel = qk.grouped_scores(*args, block_rows=lay.br)
    k2_is_k1 = _panel_is_topk("K2", panel, k1, lay)
    err = _panel_err("K2", panel,
                     qk.grouped_scores_plain(*args, block_rows=lay.br), lay,
                     grp_block)
    del k1
    out["grouped_scores"] = kernel_entry(
        err, cuda_ms(lambda: qk.grouped_scores(*args, block_rows=lay.br), 20),
        cuda_ms(lambda: qk.grouped_scores_plain(*args, block_rows=lay.br), 3),
        bounds.panel_counts(lay.data, grp_qvecs, grp_block, 32, lay.br,
                            q.shape[1]),
        bmm_ms(*args, lay.br, 5), LIBRARY_BMM)
    out["panel_topk"] = _panel_topk_times(lay, panel, grp_block, grp_cnt)
    del panel
    torch.cuda.synchronize()
    return {**shape,
            "panel_blocks_per_sm": qk.panel_blocks_per_sm(lay.data.dtype,
                                                          lay.d_pad),
            "k2_panel_is_k1_scores_bitwise": k2_is_k1,
            "kernels": out}


def _panel_topk_keys(lay, panel, grp_block, grp_cnt) -> "torch.Tensor":
    """The K8 library yardstick's operand: each masked panel score's
    ordered bits (-0.0 as +0.0) over ``br - 1 - lane``, as int64 keys in
    ``(g_total * G, br)`` rows, distinct within a row."""
    import torch

    br = lay.br
    scale, norms = _row_scale(lay), lay.norms
    blk = grp_block.long()
    if scale is not None:
        panel = panel * scale.view(-1, br)[blk][:, None, :]
    if norms is not None:
        panel = panel - norms.view(-1, br)[blk][:, None, :]
    lane = torch.arange(br, device=panel.device)
    panel = torch.where(lane < grp_cnt[:, :, None], panel, -torch.inf)
    bits = panel.reshape(-1, br).view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)
    ordered = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits,
                          bits + 0x80000000)
    return (ordered - 0x80000000) * (1 << 32) + (br - 1 - lane)


def _panel_topk_times(lay, panel, grp_block, grp_cnt) -> dict:
    """K8 at the k = 100 serve's shapes: the single table's K2 panel of
    every query (9,096 groups x 32 slots x 512 lanes), ``kk`` 100; bitwise
    against its plain version (the old mask, ``torch.where`` and stable
    sort); its time, the plain version's, ``torch.topk`` on composite
    keys (whose lanes must be K8's) and its bound."""
    import torch

    from nlsh_tpu_torch.ops.cuda import bounds
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk

    kw = dict(norms=lay.norms, scale_rows=_row_scale(lay))
    topk = (panel, grp_block, None, grp_cnt, K8_KK)
    got = qk.panel_topk(*topk, **kw)
    want = qk.panel_topk_plain(*topk, **kw)
    bitwise = bool(torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
                   and torch.equal(got[1], want[1]))
    check(bitwise, "K8 differs from its plain version at the main path's "
                   "shapes")
    del want
    keys = _panel_topk_keys(lay, panel, grp_block, grp_cnt)
    lib = torch.topk(keys, K8_KK, dim=1).values
    lib_lanes = (lay.br - 1 - lib % (1 << 32)).to(torch.int32)
    check(bool(torch.equal(lib_lanes, got[1])),
          "torch.topk on composite keys differs from K8's lanes")
    del lib, lib_lanes, got
    entry = kernel_entry(
        0.0, cuda_ms(lambda: qk.panel_topk(*topk, **kw), 20),
        cuda_ms(lambda: qk.panel_topk_plain(*topk, **kw), 3),
        bounds.panel_topk_counts(*topk, **kw),
        cuda_ms(lambda: torch.topk(keys, K8_KK, dim=1), 5), LIBRARY_K8)
    del keys
    return {**entry, "bitwise": bitwise, "kk": K8_KK,
            "live_slots": int((grp_cnt > 0).sum()),
            "live_lanes": int(grp_cnt.clamp(0, lay.br).sum())}


def _windowed_times(lay, q, pid, pv, g_total: int,
                    panel_reps: int | None) -> dict:
    """K3/K4 (K4 timed over ``panel_reps`` calls; K3 alone when it is
    None) and their plain versions at the windowed prep of the probes
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
    topk = (grp_lo, grp_hi, wl.K)
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
    live = grp_hi > grp_lo
    shape = {"g_total": g_total, "group_q": qk.GROUP_W, "block_rows": lay.br,
             "d_pad": lay.d_pad, "live_groups": int(live.any(dim=1).sum()),
             "live_slots": int(live.sum()),
             "topk_blocks_per_sm": qk.topk_blocks_per_sm(
                 lay.data.dtype, lay.d_pad, windowed=True)}
    if panel_reps is None:
        torch.cuda.synchronize()
        return {**shape, "kernels": out}
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
    return {**shape,
            "panel_blocks_per_sm": qk.panel_blocks_per_sm(lay.data.dtype,
                                                          lay.d_pad),
            "k4_panel_is_k3_scores_bitwise": k4_is_k3,
            "kernels": out}


def phase_kernel_times(idx, queries: np.ndarray) -> dict:
    """K1/K2 and their plain versions at the main path's own shapes (the
    grouped prep of all queries): CUDA-event times and max score error."""
    res = _grouped_times(idx.layout, *flip_probes(idx, queries))
    out = res.pop("kernels")
    emit("kernel_times", **res, **out)
    return out


def _gather_body_of(idx, kw, dim: int = 100):
    """An ``Indexer``'s gather body (``body(q, None)``: flip probes) at the
    query chunk its serve takes, and that chunk."""
    from nlsh_tpu_torch.index.indexer import _gather_body
    from nlsh_tpu_torch.index.query import default_query_chunk

    chunk = default_query_chunk(kw["hash_times"], idx.probe_budget, dim)
    return _gather_body(idx.hashing, idx.table, idx.corpus,
                        probe_budget=idx.probe_budget, metric=idx.metric,
                        query_chunk=chunk, **kw), chunk


def _gather_serve_replay(what: str, idx, q, kw) -> dict:
    """An ``Indexer``'s gather engine replayed (one graph per batch:
    hash, the chunk loop, pack) against its body run eagerly, bit for
    bit, with both passes and busy shares, the pool beside the chunk's
    ``_GATHER_BUDGET_BYTES`` and the capture seconds
    (:func:`_serve_replay`)."""
    from nlsh_tpu_torch.index.query import _GATHER_BUDGET_BYTES

    body, chunk = _gather_body_of(idx, kw, q.shape[1])
    out = _serve_replay(what, lambda: idx.query_async(q, **kw), body, q,
                        idx._graphs)
    out.update(query_chunk=chunk, chunks=-(-q.shape[0] // chunk),
               gather_budget_mib=_GATHER_BUDGET_BYTES / 2 ** 20)
    return out


def phase_parity(corpus, queries, idx, ids_k1) -> dict:
    """Grouped vs gather on a 65,536-row slice (cosine, euclidean; the
    bench's 0.98 gate), each gather serve a replayed graph held to its
    eager body bit for bit; the full serve with K1 vs the plain scorer;
    and the gather engine on the full single table (10,000 queries, 16
    flip probes, cap 512): replay vs eager body, both passes, busy
    shares, the graph's pool and capture seconds, ids vs K1's."""
    import torch

    from nlsh_tpu_torch.index import Indexer

    out = {}
    hashing = idx.hashing
    kw = dict(k=wl.K, hash_times=wl.HASH_TIMES, probe_mode="flip")
    for metric in ("cosine", "euclidean"):
        small = Indexer(hashing, corpus[:SLICE_ROWS], device=DEVICE,
                        metric=metric, engine="gather")
        qs = queries[:SLICE_QUERIES]
        g_ids, g_cand = small.query(qs, k=wl.K, hash_times=wl.HASH_TIMES,
                                    probe_mode="flip")
        q_small = torch.as_tensor(qs, device=DEVICE)
        packed = small.query_async(q_small, **kw)
        with _Uncounted(), torch.no_grad():
            eager = _gather_body_of(small, kw)[0](q_small, None)
            check(bool(torch.equal(packed, eager)),
                  f"{metric}: the gather replay differs from its eager body")
        small.engine = "grouped"
        s_ids, s_cand = small.query(qs, k=wl.K, hash_times=wl.HASH_TIMES,
                                    probe_mode="flip")
        check(bool((g_cand == s_cand).all()), f"{metric}: n_candidates differ")
        agree = id_agreement(g_ids, s_ids)
        check(agree >= 0.98, f"{metric}: grouped vs gather {agree} < 0.98")
        out[f"{metric}:grouped:gather"] = agree
    p_ids, _ = idx.query(queries, k=wl.K, hash_times=wl.HASH_TIMES,
                         probe_mode="flip", plain=True)
    agree = id_agreement(p_ids, ids_k1)
    check(agree >= 0.999, f"K1 vs plain serve agreement {agree} < 0.999")
    out["full:k1:plain"] = agree
    idx.engine = "gather"
    q = torch.as_tensor(queries, device=DEVICE)
    gather = _gather_serve_replay("single-table gather", idx, q, kw)
    x_ids, _ = Indexer.fetch(idx.query_async(q, **kw))
    idx.engine = "grouped"
    gather["vs_k1"] = id_agreement(x_ids, ids_k1)
    check(gather["vs_k1"] >= 0.98,
          f"full gather vs K1 {gather['vs_k1']} < 0.98")
    emit("parity", card=CARD["nvidia_smi"], gather_full=gather, **out)
    return out


def phase_windowed(idx, queries: np.ndarray, gt: np.ndarray, grouped_ids,
                   grouped_cand) -> dict:
    """The single table on the windowed engine (dense layout, K3 at
    k=10, K4 and K8 at k=20): recall, candidates query by query and ids
    against the grouped engine's run.  Returns the launch counts of the
    run."""
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    idx.engine = "windowed"
    layout = idx.layout  # the dense layout's build is not part of the run
    reset_launches()
    ids, n_cand = idx.query(queries, k=wl.K, hash_times=wl.HASH_TIMES,
                            probe_mode="flip")
    ids20, n_cand20 = idx.query(queries, k=2 * wl.K, hash_times=wl.HASH_TIMES,
                                probe_mode="flip")
    launches = read_launches("windowed_scores_topk", "windowed_scores",
                             "panel_topk")
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
    check(RECALL_RANGE[0] <= recall <= RECALL_RANGE[1],
          f"windowed recall@10 {recall} outside {RECALL_RANGE}")
    check(bool((n_cand == grouped_cand).all() and (n_cand20 == n_cand).all()),
          "windowed n_candidates differ from the grouped engine's")
    agree = id_agreement(grouped_ids, ids)
    check(agree >= 0.999, f"windowed vs grouped agreement {agree} < 0.999")
    head20 = id_agreement(ids, ids20[:, :wl.K])
    check(head20 >= 0.999, f"windowed k=20 head vs k=10 {head20} < 0.999")
    emit("windowed", n_queries=int(queries.shape[0]), k=[wl.K, 2 * wl.K],
         hash_times=wl.HASH_TIMES, recall_at_10=recall,
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
        return idx.query(queries, k=wl.K, hash_times=wl.HASH_TIMES,
                         probe_mode="flip")

    reset_launches()
    ids, n_cand = serve()
    launches = read_launches("bucket_scores_auto")
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
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
    emit("fixed", n_queries=int(queries.shape[0]), k=wl.K,
         hash_times=wl.HASH_TIMES,
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
    q, pid, pv = flip_probes(idx, queries)
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
        return idx.query(queries, k=wl.K, hash_times=wl.HASH_TIMES,
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
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
    check(INT8_RECALL_RANGE[0] <= recall <= INT8_RECALL_RANGE[1],
          f"int8 recall@10 {recall} outside {INT8_RECALL_RANGE}")
    check(bool((n_cand == f32_cand).all()),
          "int8 n_candidates differ from the f32 serve's")
    res = {"recall_at_10": recall, "layout_rows": layout.n_rows,
           "layout_gib": layout.data.numel() / 2 ** 30, "build_s": build_s}
    timed = _timed_passes(serve, 5)
    res["grouped"] = {**timed, "qps": queries.shape[0] / timed["median_s"]}
    q, pid, pv = flip_probes(idx, queries)
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
        "recall_at_10": float(calculate_recall(gt[:, :wl.K], g_ids, np.mean)),
        "vs_per_row": id_agreement(ids, g_ids)}
    idx.serving_dtype, idx.int8_scale = torch.float32, "per_row"
    emit("int8", n_queries=int(queries.shape[0]), k=wl.K,
         hash_times=wl.HASH_TIMES,
         scale_mode="per_row", **res, launches=launches,
         grouped_table=k12, windowed_table=k34, kernel_times=times)
    return launches, times


def phase_bf16(idx, queries: np.ndarray, gt: np.ndarray, f32_cand) -> None:
    """The single table on the bf16 layout, grouped engine, through
    ``Indexer.query`` (K1 on bf16 rows, f32 queries): recall within
    ``BF16_RECALL_TOL`` of ``BF16_RECALL``, candidates in ``N_CAND_RANGE``
    and equal to the f32 serve's per query (the layout's type does not
    change which rows a bucket holds), the layout's GiB and QPS."""
    import torch

    from nlsh_tpu_torch.utils.metrics import calculate_recall

    def serve():
        return idx.query(queries, k=wl.K, hash_times=wl.HASH_TIMES,
                         probe_mode="flip")

    idx.engine, idx.serving_dtype = "grouped", torch.bfloat16
    t0 = time.perf_counter()
    layout = idx.layout
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(layout.data.dtype == torch.bfloat16, "bf16 layout")
    reset_launches()
    ids, n_cand = serve()
    launches = read_launches("grouped_scores_topk")
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
    mean_cand = float(n_cand.mean())
    check(abs(recall - BF16_RECALL) <= BF16_RECALL_TOL,
          f"bf16 recall@10 {recall} not within {BF16_RECALL_TOL} of "
          f"{BF16_RECALL}")
    check(N_CAND_RANGE[0] <= mean_cand <= N_CAND_RANGE[1],
          f"bf16 mean n_candidates {mean_cand} outside {N_CAND_RANGE}")
    check(bool((n_cand == f32_cand).all()),
          "bf16 n_candidates differ from the f32 serve's")
    timed = _timed_passes(serve, 5)
    idx.serving_dtype = torch.float32
    emit("bf16", n_queries=int(queries.shape[0]), k=wl.K,
         hash_times=wl.HASH_TIMES,
         recall_at_10=recall, target=BF16_RECALL, mean_n_candidates=mean_cand,
         layout_rows=layout.n_rows,
         layout_gib=layout.data.numel() * layout.data.element_size() / 2 ** 30,
         build_s=build_s, launches=launches, **timed,
         qps=queries.shape[0] / timed["median_s"])


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

    kw = dict(hash_times=wl.ENSEMBLE_HASH_TIMES, probe_mode="flip")
    g_cal = midx.calibrate(queries, **kw)
    layout = midx._serving_layout()
    gp, gv = flat_flip_probes(midx, queries)
    override, needed = midx.windowed_group_bound(layout, gp, gv)
    static = _static_groups(layout, gp)
    check(override == g_cal, f"the batch ({needed} groups) does not fit its "
          f"own calibration ({g_cal})")

    reset_launches()
    ids, n_cand = midx.query(queries, k=wl.K, **kw)
    launches = read_launches("windowed_scores_topk")
    check(ids.shape == (queries.shape[0], wl.K), "ensemble result shape")
    check(bool(((ids >= -1) & (ids < midx.corpus.shape[0])).all()),
          "ensemble id range")
    for row in ids[:200]:
        real = row[row >= 0]
        check(len(set(real)) == len(real), "duplicate ids after the dedupe")
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
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
        midx.query(queries, k=wl.K, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    emit("ensemble_serve", n_queries=int(queries.shape[0]), k=wl.K,
         hash_times=wl.ENSEMBLE_HASH_TIMES, probe_mode="flip",
         engine=midx.engine,
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

    gp, gv = flat_flip_probes(midx, queries)
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
        queries, k=wl.K, hash_times=wl.HASH_TIMES, probe_mode="flip"), top=25)
    idx.engine = "grouped"


def phase_ensemble_profile(midx, queries: np.ndarray) -> None:
    """``--profile``: 3 ensemble serve passes under ``torch.profiler``."""
    _profile_passes("ensemble_profile", lambda: midx.query(
        queries, k=wl.K, hash_times=wl.ENSEMBLE_HASH_TIMES,
        probe_mode="flip"), top=15)


def phase_ensemble_parity(midx, queries: np.ndarray, ids, n_cand) -> dict:
    """Windowed with K3 vs its plain scorer (all queries, >= 0.999), vs
    the grouped engine (all queries, >= 0.999, equal candidates), and vs
    the gather engine (the first 1,000 queries, the bench's 0.98 gate),
    whose serve is one replayed graph: held to its eager body bit for
    bit, with both passes, busy shares, the pool and capture seconds."""
    import torch

    kw = dict(k=wl.K, hash_times=wl.ENSEMBLE_HASH_TIMES, probe_mode="flip")
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
    q_head = torch.as_tensor(head, device=DEVICE)
    gather = _serve_replay(
        "ensemble gather", lambda: midx.query_async(q_head, **kw),
        midx._gather_body(wl.K, wl.ENSEMBLE_HASH_TIMES, "flip"), q_head,
        midx._graphs)
    emit("ensemble_parity", card=CARD["nvidia_smi"],
         gather_queries=MT_GATHER_QUERIES,
         gather_mean_distinct=float(x_cand.mean()), gather_graph=gather,
         **out)
    midx.engine = "windowed"
    return out


def phase_ensemble_guard(midx, queries: np.ndarray, ids, n_cand) -> dict:
    """A starved calibration (4 queries, one probe per table): the full
    batch's exact need exceeds it, so the serve must take the static
    group bound and give the calibrated serve's ids and candidates; the
    guard's branch is taken on the card inside the replay, which equals
    the guarded body run eagerly bit for bit."""
    import torch

    from nlsh_tpu_torch.parallel.multitable import _mt_serve_body

    g_starved = midx.calibrate(queries[:4], hash_times=1, probe_mode="flip")
    layout = midx._serving_layout()
    gp, gv = flat_flip_probes(midx, queries)
    override, needed = midx.windowed_group_bound(layout, gp, gv)
    check(override is None and needed > g_starved,
          f"a batch of {needed} groups was served on a starved calibration "
          f"of {g_starved}")
    kw = dict(k=wl.K, hash_times=wl.ENSEMBLE_HASH_TIMES, probe_mode="flip")
    s_ids, s_cand = midx.query(queries, **kw)
    check(bool(np.array_equal(s_cand, n_cand)),
          "static-bound serve: n_candidates differ from the calibrated serve")
    check(bool(np.array_equal(s_ids, ids)),
          "static-bound serve: ids differ from the calibrated serve")
    q = torch.as_tensor(queries, device=DEVICE)
    with _Uncounted(), torch.no_grad():
        eager = _mt_serve_body(midx.hashings, layout, engine="windowed",
                               n_rows=midx.n_rows, g_override=g_starved,
                               **kw)(q, None)
        check(bool(torch.equal(midx.query_async(q, **kw), eager)),
              "the starved replay differs from its eager body")
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
# the one-dispatch serve: the fused serves as replayed CUDA graphs
# ---------------------------------------------------------------------------

FUSED_REPEATS = 16   # bench.py's PIPELINE_DEPTH: batches of the fresh pool
FUSED_PASSES = 5     # timed passes of each of the eager and replayed serves
FUSED_KERNEL = {"grouped": "grouped_scores_topk",
                "windowed": "windowed_scores_topk",
                "fixed": "bucket_scores_auto"}
FUSED_PANEL = {"grouped": "grouped_scores", "windowed": "windowed_scores"}


def _pass_ms(fn, n: int) -> list:
    """Host milliseconds of ``n`` calls of ``fn``, each fetched to the
    host (``fn`` ends in a copy to numpy)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _busy_share(fn) -> dict:
    """The device's busy share of one pass of ``fn``: device time summed
    over ``torch.profiler``'s device-side events of 3 passes, over the
    unprofiled wall time of a pass (and over the profiled one); and the
    device events of a pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def passes():
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3 * 1e3

    passes()
    wall_ms = passes()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = passes()
    events = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]
    device_ms = sum(e.self_device_time_total for e in events) / 3e3
    if device_ms <= 0:
        return {"busy_share": None, "note": "not measured: the profile saw "
                "no device time", "wall_ms": wall_ms}
    return {"device_ms": device_ms, "wall_ms": wall_ms,
            "profiled_wall_ms": profiled_ms,
            "device_events": sum(e.count for e in events) / 3,
            "busy_share": device_ms / wall_ms,
            "busy_share_profiled": device_ms / profiled_ms}


def _batched_qps(run, n_queries: int) -> dict:
    """``run()`` (one replay of ``FUSED_REPEATS`` batches, fetched) after
    its capture, timed 3 times: the time per call and per batch, and
    QPS = repeats * nq / call time."""
    run()
    call_ms = _pass_ms(run, 3)
    med = float(np.median(call_ms))
    return {"repeats": FUSED_REPEATS, "call_ms": call_ms,
            "ms_per_batch": med / FUSED_REPEATS,
            "qps": FUSED_REPEATS * n_queries / (med / 1e3)}


def phase_fused(idx, queries: np.ndarray, gt: np.ndarray, f32_cand) -> dict:
    """The single table's one-dispatch serve (``_fused_serve``, a captured
    CUDA graph replayed by ``Indexer.query``) on the grouped, windowed
    and fixed-cap engines (f32) and the per-row int8 grouped engine: the
    replay's ids and candidates bitwise the eager body's on the same
    batch (k = 10; and k = 20 where K2 / K4 serve), recall and
    candidates in their windows, the eager and the replayed pass (ms,
    fetched), each device's busy share of one pass from
    ``torch.profiler``, ``_fused_serve_batched``'s QPS over
    ``workloads.glove100_fresh_pool(16)`` (one replay, one fetch of 16 x
    10,000 queries; its repeat 0 bitwise a single replay of the pool's
    batch 0) and each captured graph's pool.  Returns the launch counts,
    every one from replays: the counts are set to 0 after the capture."""
    import torch

    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.index.indexer import _fused_serve_batched, _serve_body
    from nlsh_tpu_torch.utils.graphs import GraphCache
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    q = torch.as_tensor(queries, device=idx.device)
    pool = torch.as_tensor(wl.glove100_fresh_pool(FUSED_REPEATS),
                           device=idx.device)
    kw = dict(hash_times=wl.HASH_TIMES, probe_mode="flip")
    launches, cases = [], {}
    for engine, dtype in (("grouped", "float32"), ("windowed", "float32"),
                          ("fixed", "float32"), ("grouped", "int8")):
        name = f"{engine}_{dtype}"
        idx.engine, idx.serving_dtype = engine, getattr(torch, dtype)
        lay = idx.layout
        res, packed = {}, {}
        for k in ((wl.K, 2 * wl.K)
                  if dtype == "float32" and engine in FUSED_PANEL
                  else (wl.K,)):
            body = _serve_body(idx.hashing, lay, idx.table.counts, k=k,
                               grouped=engine, **kw)
            idx.query_async(q, k=k, **kw)  # the capture
            res[f"k{k}_graph_pool_mib"] = \
                idx._graphs.pool_bytes()[-1] / 2 ** 20
            reset_launches()
            packed[k] = idx.query_async(q, k=k, **kw)
            kernel = FUSED_KERNEL[engine] if k == wl.K else FUSED_PANEL[engine]
            launches.append(read_launches(kernel))
            with torch.no_grad():
                eager = body(q, None)
            check(bool(torch.equal(packed[k], eager)),
                  f"fused {name} k={k}: the replay differs from the eager "
                  "body")
            res[f"k{k}_launches_per_replay"] = launches[-1][kernel]
        ids, cand = Indexer.fetch(packed[wl.K])
        recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
        mean_cand = float(cand.mean())
        if dtype == "float32":
            check(RECALL_RANGE[0] <= recall <= RECALL_RANGE[1]
                  and N_CAND_RANGE[0] <= mean_cand <= N_CAND_RANGE[1],
                  f"fused {name}: recall {recall}, candidates {mean_cand}")
        else:
            check(INT8_RECALL_RANGE[0] <= recall <= INT8_RECALL_RANGE[1]
                  and bool((cand == f32_cand).all()),
                  f"fused {name}: recall {recall}, candidates differ")
        body = _serve_body(idx.hashing, lay, idx.table.counts, k=wl.K,
                           grouped=engine, **kw)

        def eager_pass():
            with torch.no_grad():
                return body(q, None).cpu().numpy()

        def replay_pass():
            return idx.query(q, k=wl.K, **kw)

        eager_ms = _pass_ms(eager_pass, FUSED_PASSES)
        replay_ms = _pass_ms(replay_pass, FUSED_PASSES)
        busy = {"eager": _busy_share(eager_pass),
                "replay": _busy_share(replay_pass)}
        graphs = GraphCache()
        single = idx.query_async(pool[0], k=wl.K, **kw).cpu().numpy()

        def batched():
            return _fused_serve_batched(
                idx.hashing, lay, idx.table.counts, pool, k=wl.K,
                grouped=engine, repeats=FUSED_REPEATS, graphs=graphs,
                **kw).cpu().numpy()

        first = batched()
        check(first.shape == (FUSED_REPEATS, queries.shape[0], wl.K + 1)
              and bool(np.array_equal(first[0], single)),
              f"fused {name}: batched repeat 0 differs from its single "
              "replay")
        cases[name] = {
            "recall_at_10": recall, "mean_n_candidates": mean_cand,
            "replay_equals_eager": True, **res,
            "eager_pass_ms": eager_ms,
            "eager_median_ms": float(np.median(eager_ms)),
            "replay_pass_ms": replay_ms,
            "replay_median_ms": float(np.median(replay_ms)),
            "busy": busy, "batched": _batched_qps(batched, queries.shape[0]),
            "batched_graph_pool_mib": graphs.pool_bytes()[0] / 2 ** 20}
        del graphs
    idx.engine, idx.serving_dtype = "grouped", torch.float32
    emit("fused", card=CARD["nvidia_smi"], n_queries=int(queries.shape[0]),
         k=wl.K, hash_times=wl.HASH_TIMES, **cases)
    return _summed(launches)


def _summed(counts: list) -> dict:
    out = {}
    for got in counts:
        for name, n in got.items():
            out[name] = out.get(name, 0) + n
    return out


def phase_ensemble_fused(midx, queries: np.ndarray, gt: np.ndarray, mt_ids,
                         mt_cand) -> dict:
    """The ensemble's one-dispatch serve (``_fused_mt_serve``, replayed by
    ``MultiTableIndexer.query``) on the windowed engine at the batch's
    own calibration and on the fixed-cap engine: the replay bitwise the
    eager body, recall and summed candidates in the ensemble's windows
    and equal to the ensemble serve's, the forced guard (a starved
    calibration: ONE replay, whose conditional node takes the
    static-bound branch on the card, gives the calibrated serve's ids and
    candidates, launches K3 once and makes no host sync), the eager and
    the replayed pass (and the starved one), the busy shares,
    ``_fused_mt_serve_batched``'s QPS over the fresh pool and the graphs'
    pools: the two-branch graph beside the one-branch static graph a
    starved batch captured before.  Returns the launch counts, from
    replays."""
    import torch

    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.parallel.multitable import (
        _fused_mt_serve,
        _fused_mt_serve_batched,
        _mt_serve_body,
        _windowed_needed,
    )
    from nlsh_tpu_torch.utils.graphs import GraphCache
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    q = torch.as_tensor(queries, device=midx.device)
    pool = torch.as_tensor(wl.glove100_fresh_pool(FUSED_REPEATS),
                           device=midx.device)
    kw = dict(hash_times=wl.ENSEMBLE_HASH_TIMES, probe_mode="flip")
    launches, cases = [], {}
    for engine in ("windowed", "fixed"):
        midx.engine = engine
        layout = midx._serving_layout()
        g_cal = midx.calibrate(queries, **kw) if engine == "windowed" \
            else None
        body = _mt_serve_body(midx.hashings, layout, k=wl.K, engine=engine,
                              n_rows=midx.n_rows, g_override=g_cal, **kw)

        def replay():
            return midx.query_async(q, k=wl.K, **kw)

        replay()  # the capture
        pool_mib = midx._graphs.pool_bytes()[-1] / 2 ** 20
        reset_launches()
        packed = replay()
        launches.append(read_launches(FUSED_KERNEL[engine]))
        with torch.no_grad():
            eager = body(q, None)
        res = {}
        if g_cal is not None:
            need = _windowed_needed(layout, *flat_flip_probes(midx, queries))
            check(need <= g_cal, f"the batch ({need} groups) does not fit "
                  f"its own calibration ({g_cal})")
            res.update(groups_calibrated=g_cal, groups_needed=need)
        check(bool(torch.equal(packed, eager)),
              f"fused ensemble {engine}: the replay differs from the eager "
              "body")
        ids, cand = Indexer.fetch(packed)
        recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
        mean_cand = float(cand.mean())
        check(MT_RECALL_RANGE[0] <= recall <= MT_RECALL_RANGE[1]
              and MT_N_CAND_RANGE[0] <= mean_cand <= MT_N_CAND_RANGE[1],
              f"fused ensemble {engine}: recall {recall}, candidates "
              f"{mean_cand}")
        check(bool((cand == mt_cand).all()),
              f"fused ensemble {engine}: candidates differ from the serve's")
        agree = id_agreement(mt_ids, ids)
        check(agree >= 0.999, f"fused ensemble {engine} vs the serve "
              f"{agree} < 0.999")

        def eager_pass():
            with torch.no_grad():
                return body(q, None).cpu().numpy()

        def replay_pass():
            return midx.query(q, k=wl.K, **kw)

        eager_ms = _pass_ms(eager_pass, FUSED_PASSES)
        replay_ms = _pass_ms(replay_pass, FUSED_PASSES)
        busy = {"eager": _busy_share(eager_pass),
                "replay": _busy_share(replay_pass)}
        graphs = GraphCache()

        def batched():
            return _fused_mt_serve_batched(
                midx.hashings, layout, pool, k=wl.K, engine=engine,
                n_rows=midx.n_rows, repeats=FUSED_REPEATS, g_override=g_cal,
                graphs=graphs, **kw).cpu().numpy()

        qps = _batched_qps(batched, queries.shape[0])
        res.update(
            recall_at_10=recall, mean_n_candidates=mean_cand,
            vs_serve=agree, replay_equals_eager=True,
            eager_pass_ms=eager_ms,
            eager_median_ms=float(np.median(eager_ms)),
            replay_pass_ms=replay_ms,
            replay_median_ms=float(np.median(replay_ms)), busy=busy,
            batched=qps, graph_pool_mib=pool_mib,
            batched_graph_pool_mib=graphs.pool_bytes()[0] / 2 ** 20)
        del graphs
        if engine == "windowed":
            res["guard"] = _forced_guard(midx, layout, q, queries, packed,
                                         replay, replay_pass, launches)
            # the static-bound graph a starved batch captured before the
            # guard moved into the serve's graph, for its pool
            static = GraphCache()
            _fused_mt_serve(midx.hashings, layout, q, k=wl.K, engine=engine,
                            n_rows=midx.n_rows, graphs=static, **kw)
            res["guard"].update(
                calibrated_graph_pool_mib=pool_mib,
                static_graph_pool_mib=static.pool_bytes()[0] / 2 ** 20,
                calibrated_plus_static_mib=pool_mib
                + static.pool_bytes()[0] / 2 ** 20)
            del static
        cases[engine] = res
    midx.engine = "windowed"
    emit("ensemble_fused", card=CARD["nvidia_smi"],
         n_queries=int(queries.shape[0]), k=wl.K,
         hash_times=wl.ENSEMBLE_HASH_TIMES,
         **cases)
    return _summed(launches)


def _forced_guard(midx, layout, q, queries, packed, replay, replay_pass,
                  launches: list) -> dict:
    """A starved calibration (4 queries, one probe per table) of the same
    batch: the replay's conditional node serves it at the static bound,
    in ONE replay that reads nothing on the host
    (``set_sync_debug_mode("error")``) and launches K3 once, with the
    calibrated serve's answer; the two-branch graph's pool and capture
    seconds and the starved pass."""
    import torch

    from nlsh_tpu_torch.parallel.multitable import _windowed_needed

    g_starved = midx.calibrate(queries[:4], hash_times=1, probe_mode="flip")
    need = _windowed_needed(layout, *flat_flip_probes(midx, queries))
    check(need > g_starved, f"a batch of {need} groups fit a starved "
          f"calibration of {g_starved}")
    replay()  # the capture: both branches
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        guarded = replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches.append(read_launches(FUSED_KERNEL["windowed"]))
    n_k3 = launches[-1][FUSED_KERNEL["windowed"]]
    check(n_k3 == 1, f"the guarded replay counted {n_k3} K3 launches")
    check(len(midx._graphs) == 1, "the starved serve captured a second graph")
    check(bool(torch.equal(guarded, packed)),
          "the guard's static-bound branch differs from the calibrated serve")
    starved_ms = _pass_ms(replay_pass, FUSED_PASSES)
    return {"groups_calibrated": g_starved, "groups_needed": need,
            "ids_equal": True, "n_candidates_equal": True,
            "replays": 1, "host_syncs": 0,
            "two_branch_graph_pool_mib":
                midx._graphs.pool_bytes()[-1] / 2 ** 20,
            "two_branch_capture_s": midx._graphs.capture_s()[-1],
            "starved_pass_ms": starved_ms,
            "starved_median_ms": float(np.median(starved_ms))}


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
    ids, n_cand = back.query(queries, k=wl.K, hash_times=wl.HASH_TIMES,
                             probe_mode="flip")
    launches = read_launches("grouped_scores_topk")
    check(bool(np.array_equal(ids, single[0])), "restored serve: ids differ")
    check(bool(np.array_equal(n_cand, single[1])),
          "restored serve: n_candidates differ")
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
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
    kw = dict(hash_times=wl.ENSEMBLE_HASH_TIMES, probe_mode="flip")
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
    ids, n_cand = mback.query(queries, k=wl.K, **kw)
    launches = read_launches("windowed_scores_topk")
    check(bool(np.array_equal(ids, ensemble[0])),
          "restored ensemble serve: ids differ")
    check(bool(np.array_equal(n_cand, ensemble[1])),
          "restored ensemble serve: n_candidates differ")
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
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
                          metric=idx.metric, probe_budget=wl.CAP,
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
            queries, k=wl.K, hash_times=wl.HASH_TIMES, probe_mode="flip")
        check(bool(np.array_equal(h_cand, n_cand)),
              f"host layout {name}: n_candidates differ")
        want = ids if dtype == torch.float32 else built["device"][0].query(
            queries, k=wl.K, hash_times=wl.HASH_TIMES, probe_mode="flip")[0]
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
                  probe_budget=wl.CAP)
    _ = idx.layout
    kw = dict(k=wl.K, hash_times=wl.HASH_TIMES, probe_mode="flip")

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
    recall_a = float(calculate_recall(gt[:, :wl.K], ids_a, np.mean))
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
    k_eff = wl.K + (1 << (UPDATE_REMOVED - 1).bit_length())

    reset_launches()
    ids_r, cand_r = serve()
    launches = read_launches("grouped_scores", "panel_topk")
    check(qk.KERNEL_LAUNCHES["grouped_scores_topk"] == 0,
          "the tombstone serve fetches k_eff > 16 per block: K2, not K1")
    check(ids_r.shape == (queries.shape[0], wl.K), "tombstone serve shape")
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
    q_sample = torch.as_tensor(qs, device=DEVICE)
    with _Uncounted():
        check(bool(torch.equal(idx.query_async(q_sample, **kw),
                               idx.query_async(q_sample, plain=True, **kw))),
              "the gather replay (buffer, tombstones) differs from its eager "
              "body")
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
          and idx.probe_budget == wl.CAP, "state after compact")
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
                      probe_budget=wl.CAP,
                      table=build_bucket_table(codes, idx.hashing.n_buckets))
    s_ids, s_cand = scratch.query(queries, **kw)
    check(bool(np.array_equal(s_ids, ids_c))
          and bool(np.array_equal(s_cand, cand_c)),
          "after compact: not the index built from scratch")
    # not a check: the buffer was scanned whole, the table is only probed
    vs_tomb = id_agreement(ids_r, ids_c)
    recall_c = float(calculate_recall(gt[:, :wl.K], ids_c, np.mean))
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

    kw = dict(hash_times=wl.ENSEMBLE_HASH_TIMES, probe_mode="flip")

    def serve():
        return midx.query(queries, k=wl.K, **kw)

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
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
    check(MT_RECALL_RANGE[0] <= recall <= MT_RECALL_RANGE[1],
          f"ensemble fixed-cap recall@10 {recall} outside {MT_RECALL_RANGE}")
    timed = _timed_passes(serve, 3)
    emit("ensemble_fixed", n_queries=int(queries.shape[0]), k=wl.K,
         hash_times=wl.ENSEMBLE_HASH_TIMES, recall_at_10=recall,
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
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
    check(MT_INT8_RECALL_RANGE[0] <= recall <= MT_INT8_RECALL_RANGE[1],
          f"ensemble int8 recall@10 {recall} outside {MT_INT8_RECALL_RANGE}")
    p_ids, _ = midx.query(queries[:MT_GATHER_QUERIES], k=wl.K, plain=True,
                          **kw)
    vs_plain = id_agreement(p_ids, ids[:MT_GATHER_QUERIES])
    check(vs_plain >= 0.999, f"ensemble int8 K3 vs plain {vs_plain} < 0.999")
    timed = _timed_passes(serve, 3)
    emit("ensemble_int8", n_queries=int(queries.shape[0]), k=wl.K,
         hash_times=wl.ENSEMBLE_HASH_TIMES, scale_mode=midx.int8_scale,
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
    kw = dict(k=wl.K, hash_times=HEAD_PROBES, probe_mode="flip")
    out = {}
    for kind, seed in (("Categorical", 11), ("ProductQuantization", 12)):
        head = _seeded_head(kind, 4096 if kind == "Categorical" else 12, seed)
        check(head.n_buckets == 4096, f"{kind}: n_buckets")
        idx = Indexer(head, rows, device=DEVICE, metric="cosine",
                      probe_budget=wl.CAP, engine="gather")
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
         hash_times=HEAD_PROBES, probe_budget=wl.CAP, **out)
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
        ["--model_path", base, "--data_id", "synthetic", "-k", str(wl.K),
         "--hash_times", str(wl.HASH_TIMES), "--probe_mode", "flip"])
    check(args.device == "cuda", "the CLI defaults to the card")
    kw = dict(k=wl.K, hash_times=wl.HASH_TIMES, probe_mode="flip")
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
        check(ids.shape == (rows.shape[0], wl.K)
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


# ---------------------------------------------------------------------------
# offline evaluation: the multi-probe sweep and the HNSW baseline
# ---------------------------------------------------------------------------

# The JAX package's exact-f32 CPU values of the sweeps and the HNSW graph
# at these phases' configurations, from
# `JAX_PLATFORMS=cpu python3 eval_anchor.py` (its --parts as noted):
# (avg_n_candidates, recall) per probe count.
EVAL_FLIP_PROBES = 16
EVAL_FLIP_QUERIES = 10_000           # eval_anchor.py --parts flip
EVAL_FLIP = (
    (301.1147, 0.19230999052524567), (599.2901, 0.3240800201892853),
    (892.4784, 0.40971001982688904), (1184.6225, 0.4711399972438812),
    (1477.1289, 0.5278100371360779), (1767.8122, 0.5678200125694275),
    (2058.0718, 0.5958400368690491), (2349.2184, 0.6169999837875366),
    (2639.565, 0.6528300046920776), (2929.3914, 0.6769700050354004),
    (3220.4846, 0.6945499777793884), (3510.0792, 0.7075999975204468),
    (3800.292, 0.7209299802780151), (4089.4288, 0.7297099828720093),
    (4379.365, 0.7370700240135193), (4670.3042, 0.7426600456237793),
)
EVAL_ENSEMBLE_QUERIES = 10_000       # eval_anchor.py --parts ensemble
EVAL_ENSEMBLE = (
    (2299.4142, 0.8211899399757385), (4491.2513, 0.9537599682807922),
    (6683.2156, 0.9828399419784546), (8881.7637, 0.9921099543571472),
)
EVAL_CAND_TOL, EVAL_RECALL_TOL = 0.01, 0.001
EVAL_SAMPLE_PROBES = 100             # the reference's own eval.py sweep
EVAL_SAMPLE_CHECKS = (1, 16, 100)    # probe counts held across engines
EVAL_CLI_PROBES = 16
# NativeHNSW on the first 16,384 corpus rows, 1,000 queries, cosine,
# M=10, ef_construction=500 (eval_anchor.py --parts hnsw): recall@10
# against the exact kNN of those rows and the mean visit count per ef
HNSW_ROWS, HNSW_QUERIES = 16_384, 1_000
HNSW_REF = {
    40: (0.9527999758720398, 613.065),
    100: (0.9773999452590942, 1305.051),
}


def _sweep_rows_check(name: str, rows, want, n_queries: int) -> float:
    """Each row against the JAX package's (candidates, recall); returns
    the largest recall difference."""
    check(len(rows) == len(want), f"{name}: {len(rows)} rows")
    worst = 0.0
    for r, (cand, recall) in zip(rows, want):
        check(abs(r["avg_n_candidates"] - cand) <= EVAL_CAND_TOL
              and abs(r["recall"] - recall) <= EVAL_RECALL_TOL,
              f"{name} at {r['n_probes']} probes on {n_queries} queries: "
              f"{r['avg_n_candidates']}, {r['recall']} against the JAX "
              f"package's {cand}, {recall}")
        worst = max(worst, abs(r["recall"] - recall))
    return worst


def _pairs(rows) -> list:
    return [[r["avg_n_candidates"], r["recall"]] for r in rows]


def _per_value_ms(fn, values) -> float:
    """Host ms per value of ``fn(n)`` over ``values``, each fetched."""
    t0 = time.perf_counter()
    for n in values:
        fn(n).cpu()
    return (time.perf_counter() - t0) * 1e3 / len(values)


def _eager_sweep(body, values) -> dict:
    """A sweep's body run eagerly, left out of the tallies: its result at
    each value, on the host, and its host ms per value over the values,
    twice.  Run it before the sweep's graph is captured: the body's peak
    and the graph's pool (each over 30 GiB at 100 sampled probes on the
    fixed-cap engine) are then never held on the card at once."""
    import torch

    def eager(n):
        return body(torch.full((), n, dtype=torch.int32, device=DEVICE))

    with _Uncounted(), torch.no_grad():
        results = {n: eager(n).cpu() for n in dict.fromkeys(values)}
        ms = [_per_value_ms(eager, values) for _ in range(2)]
    torch.cuda.empty_cache()
    return {"results": results, "ms": ms}


def _sweep_replay_vs_eager(what: str, step, eager: dict, values) -> dict:
    """A sweep's replayed step (``step(n)``: one graph for every value)
    against its body's eager results (:func:`_eager_sweep`), bit for bit;
    then the replay's host ms per value over the values (fetched), left
    out of the tallies."""
    import torch

    with _Uncounted(), torch.no_grad():
        for n, want in eager["results"].items():
            check(bool(torch.equal(step(n).cpu(), want)),
                  f"{what}: the replay differs from the eager body at {n}")
        replay_ms = [_per_value_ms(step, values) for _ in range(2)]
    return {"replay_equals_eager": True, "values": len(values),
            "eager_ms_per_value": eager["ms"], "replay_ms_per_value": replay_ms}


def _sweep_parts(hashing, c, q, probes: int, probe_mode: str, seed=None):
    """The table, its probe budget and the raw codes ``run_sweep`` builds
    (sampled from a generator seeded ``seed``)."""
    import torch

    from nlsh_tpu_torch.cli import evaluate as ev
    from nlsh_tpu_torch.index import build_bucket_table, hash_corpus

    table = build_bucket_table(hash_corpus(hashing, c), hashing.n_buckets)
    gen = None if seed is None else \
        torch.Generator(device=DEVICE).manual_seed(seed)
    raw = ev.sample_probe_codes(hashing, q, probes, gen,
                                probe_mode=probe_mode)
    return table, max(table.max_count(), 1), raw


def phase_eval_flip(corpus: np.ndarray, queries: np.ndarray, gt: np.ndarray):
    """``run_sweep`` on the grouped engine (K1), flip probes 1..16, over the
    whole corpus and 10,000 queries with the committed params: every
    row against the JAX package's CPU values; then the sweep's replayed
    step against its eager body at every value, bit for bit, and the ms
    per value of each.  Returns the rows and the launches."""
    import torch

    from nlsh_tpu_torch.cli import evaluate as ev
    from nlsh_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    reset_launches()
    with timer("sweep"):
        rows = ev.run_sweep(load_hashing(), corpus, queries, gt, wl.K,
                            max_probes=EVAL_FLIP_PROBES,
                            engine="pallas-grouped", probe_mode="flip",
                            device=DEVICE)
    launches = read_launches("grouped_scores_topk")
    check(queries.shape[0] == EVAL_FLIP_QUERIES, "eval_flip's queries")
    worst = _sweep_rows_check("eval_flip", rows, EVAL_FLIP, EVAL_FLIP_QUERIES)
    hashing = load_hashing().to(DEVICE).eval()
    c = torch.as_tensor(corpus, device=DEVICE)
    q = torch.as_tensor(queries, device=DEVICE)
    table, budget, raw = _sweep_parts(hashing, c, q, EVAL_FLIP_PROBES, "flip")
    args = (table, c, q, raw, wl.K, budget, "cosine", "grouped")
    values = range(1, EVAL_FLIP_PROBES + 1)
    eager = _eager_sweep(ev.sweep_body(*args), values)
    timed = _sweep_replay_vs_eager("eval_flip", ev.sweep_step(*args), eager,
                                   values)
    emit("eval_flip", card=CARD["nvidia_smi"], engine="grouped",
         n_queries=int(queries.shape[0]), rows=_pairs(rows),
         max_recall_diff=worst, launches=launches,
         launches_per_value=launches["grouped_scores_topk"] / len(rows),
         sweep_s=timer.totals["sweep"],
         ms_per_value=timer.totals["sweep"] * 1e3 / len(rows),
         eager_vs_replay=timed, phases=timer.summary())
    return rows, launches


def phase_eval_sample(corpus: np.ndarray, queries: np.ndarray, gt: np.ndarray,
                      flip_rows) -> dict:
    """The reference's own sweep: sampled probes (seed 0), 1..100, on the
    grouped engine (K1), timed.  Then on the same raw codes at 1, 16 and
    100 probes the windowed (K3), fixed-cap (K5) and gather engines
    against the grouped one: candidates identical, ids on >= 0.999 of
    the slots (``bench.py``'s engine gates), each engine's ms per sweep
    value at 100 probes, eager and replayed (one graph per engine, the
    replay bitwise its eager body), and K5's whole wrapper call on the
    events of 100 probes.  Returns the launches."""
    import torch

    from nlsh_tpu_torch.cli import evaluate as ev
    from nlsh_tpu_torch.index import build_bucket_table, hash_corpus
    from nlsh_tpu_torch.ops import packing
    from nlsh_tpu_torch.ops.cuda import bounds
    from nlsh_tpu_torch.ops.cuda import query_kernel as qk
    from nlsh_tpu_torch.tools.fixed_events import fixed_events
    from nlsh_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    hashing = load_hashing().to(DEVICE).eval()
    c = torch.as_tensor(corpus, device=DEVICE)
    q = torch.as_tensor(queries, device=DEVICE)
    raw = ev.sample_probe_codes(
        hashing, q, EVAL_SAMPLE_PROBES,
        torch.Generator(device=DEVICE).manual_seed(0))
    reset_launches()
    with timer("sweep"):
        rows = ev.run_sweep(hashing, c, q, gt, wl.K,
                            max_probes=EVAL_SAMPLE_PROBES,
                            engine="pallas-grouped", seed=0, device=DEVICE)
    launches = read_launches("grouped_scores_topk")
    cands = [r["avg_n_candidates"] for r in rows]
    check(rows[0] == flip_rows[0],
          f"one sampled probe {rows[0]} != one flip probe {flip_rows[0]}")
    check(all(b >= a for a, b in zip(cands, cands[1:])),
          "sampled sweep: candidates fell as probes grew")
    check(rows[-1]["recall"] >= rows[0]["recall"], "recall(100) < recall(1)")

    with timer("table"):
        table = build_bucket_table(hash_corpus(hashing, c),
                                   hashing.n_buckets)
    budget = table.max_count()
    per_value_ms, agree, grouped = {}, {}, {}
    reset_launches()
    # one engine's graph at a time: a pool keeps its peak, and the four
    # sweep graphs at 100 probes together ran the card out of memory
    for engine in ("grouped", "windowed", "fixed", "gather"):
        with timer(f"layout_{engine}"):
            args = (table, c, q, raw, wl.K, budget, "cosine", engine)
            step, body = ev.sweep_step(*args), ev.sweep_body(*args)
        # the gather engine's value takes ~1 s: time it once each way
        values = [EVAL_SAMPLE_PROBES] * (1 if engine == "gather" else 3)
        eager = _eager_sweep(body, values)
        for n in EVAL_SAMPLE_CHECKS:
            packed = step(n)
            if engine == "grouped":
                grouped[n] = packed
                check(float(np.mean(packed[:, -1].cpu().numpy()))
                      == rows[n - 1]["avg_n_candidates"],
                      f"the sweep's own draw differs from seed 0's at {n} "
                      "probes")
                continue
            check(bool(torch.equal(packed[:, -1], grouped[n][:, -1])),
                  f"{engine} candidates differ from grouped at {n} probes")
            a = id_agreement(grouped[n][:, :-1].cpu().numpy(),
                             packed[:, :-1].cpu().numpy())
            check(a >= 0.999, f"{engine} vs grouped ids {a} at {n} probes")
            agree[f"{engine}_{n}"] = a
        timed = _sweep_replay_vs_eager(f"eval_sample {engine}", step, eager,
                                       values)
        per_value_ms[engine] = {
            "eager": float(np.median(timed["eager_ms_per_value"])),
            "replay": float(np.median(timed["replay_ms_per_value"]))}
        del step, body, packed, eager
        torch.cuda.empty_cache()
    engine_launches = read_launches("windowed_scores_topk",
                                    "bucket_scores_auto")

    # K5 at the sweep's widest events: every query's 100 sampled probes,
    # on the fixed-cap engine's layout
    lay = qk.serving_layout(table, c, metric="cosine", cap=budget)
    pid, pv = packing.dedupe_codes(raw)
    qe = qk.extend_queries(lay, q)
    block_idx, starts, counts = fixed_events(lay, pid, pv)
    five = (lay.data, qe, block_idx, counts, lay.cap)
    k5 = qk.bucket_scores_auto(*five)
    sub = slice(0, 1000)  # the plain version on the first 1,000 queries
    plain = (lay.data, qe[sub], block_idx[sub], counts[sub], lay.cap)
    p5 = qk.bucket_scores_auto_plain(*plain)
    err = _masked_err("K5 at 100 probes", k5[sub], p5, False)
    del k5, p5
    k5_times = kernel_entry(
        err, cuda_ms(lambda: qk.bucket_scores_auto(*five), 5),
        cuda_ms(lambda: qk.bucket_scores_auto_plain(*plain), 1),
        bounds.bucket_counts(lay.data, qe, starts, counts, lay.cap,
                             q.shape[1]), None, NO_LIBRARY_BUCKET)
    k5_times.update(plain_note="plain_ms on the first 1,000 queries only",
                    n_events=int(pv.sum()), event_slots=pid.numel(),
                    cap=lay.cap, live_rows=int(counts.sum()),
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit("eval_sample", card=CARD["nvidia_smi"], engine="grouped",
         n_queries=int(q.shape[0]),
         probe_budget=budget, rows=_pairs(rows), sweep_s=timer.totals["sweep"],
         ms_per_value=timer.totals["sweep"] * 1e3 / len(rows),
         ms_per_value_at_100=per_value_ms, agreement=agree,
         launches=launches, engine_launches=engine_launches,
         k5_at_100_probes=k5_times, phases=timer.summary())
    launches.update(engine_launches)
    return launches


def phase_eval_ensemble(corpus: np.ndarray, queries: np.ndarray,
                        gt: np.ndarray) -> dict:
    """``run_sweep_multitable`` on the committed 8-table params, flip
    probes, 32 in all (4 per table), on the windowed engine (K3):
    ``ht = 1..4`` against the JAX package's CPU values."""
    from nlsh_tpu_torch.cli.evaluate import run_sweep_multitable
    from nlsh_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    nq = EVAL_ENSEMBLE_QUERIES
    reset_launches()
    with timer("sweep"):
        rows = run_sweep_multitable(
            load_ensemble(), corpus, queries[:nq], gt[:nq], wl.K, 8,
            max_probes=32, engine="pallas-windowed", probe_mode="flip",
            device=DEVICE)
    launches = read_launches("windowed_scores_topk")
    check([r["hash_times"] for r in rows] == [1, 2, 3, 4], "ht 1..4")
    worst = _sweep_rows_check("eval_ensemble", rows, EVAL_ENSEMBLE, nq)
    emit("eval_ensemble", card=CARD["nvidia_smi"], engine="windowed",
         n_queries=nq, rows=_pairs(rows), max_recall_diff=worst,
         launches=launches, sweep_s=timer.totals["sweep"],
         ms_per_value=timer.totals["sweep"] * 1e3 / len(rows),
         phases=timer.summary())
    return launches


def phase_eval_cli(tmp: str) -> dict:
    """``python3 -m nlsh_tpu_torch.cli.evaluate`` (its ``main``) on the
    synthetic dataset, for a single-table and an 8-table artifact of
    seeded heads written by the port's ``save_model``, flip probes, on
    the card with its defaults (``auto``: the fixed-cap engine, the
    windowed one for the ensemble) and on the CPU with the same engine:
    the printed lines are identical.  (The CPU's own ``auto``, the gather
    engine, ranks one near-tie of this set the other way.)  Returns the
    card runs' launches."""
    import contextlib
    import io

    import torch

    from nlsh_tpu_torch.cli import evaluate as cli
    from nlsh_tpu_torch.models import get_encoder, get_hashing
    from nlsh_tpu_torch.parallel.multitable import init_multi_table
    from nlsh_tpu_torch.utils.checkpoint import save_model
    from nlsh_tpu_torch.utils.profiling import PhaseTimer

    os.environ["NLSH_SYNTH_CACHE_DIR"] = os.path.join(tmp, "synth_cache")
    gen = torch.Generator().manual_seed(0)
    head = get_hashing("MultivariateBernoulli",
                       get_encoder("siren", 32, [256, 256]), 12).init(gen)
    save_model(os.path.join(tmp, "eval_single"), head)
    save_model(os.path.join(tmp, "eval_t8"), init_multi_table(head, 8, gen))
    check(cli.nlsh_eval_argparse().parse_args(
        ["--model_path", "m", "--data_id", "d"]).device == "cuda",
        "the evaluation CLI defaults to the card")
    timer = PhaseTimer()
    out, launches = {}, {}
    for name in ("eval_single", "eval_t8"):
        argv = ["--model_path", os.path.join(tmp, name), "--data_id",
                "synthetic", "--probe_mode", "flip", "--max_probes",
                str(EVAL_CLI_PROBES), "--json_out",
                os.path.join(tmp, name + ".jsonl")]
        # the card's default engine (auto) and the same engine on the CPU
        engine = "fixed" if name == "eval_single" else "windowed"
        lines = []
        for device, extra in ((DEVICE, []), ("cpu", ["--engine", engine])):
            printed = io.StringIO()
            reset_launches()
            with timer(f"{name}_{device}"), contextlib.redirect_stdout(printed):
                cli.main(argv + ["--device", device] + extra)
            if not lines:
                launches[name] = read_launches(
                    "bucket_scores_auto" if name == "eval_single"
                    else "windowed_scores_topk")
            lines.append(printed.getvalue().splitlines())
        n_rows = EVAL_CLI_PROBES // (8 if name == "eval_t8" else 1)
        check(len(lines[0]) == n_rows and lines[0] == lines[1],
              f"{name}: the card's lines {lines[0]} != the CPU's {lines[1]}")
        out[name] = lines[0]
    merged = {}
    for got in launches.values():
        merged.update(got)
    ms_per_value = {key: sec * 1e3 / len(out[key.rsplit("_", 1)[0]])
                    for key, sec in timer.totals.items()}
    emit("eval_cli", card=CARD["nvidia_smi"], lines=out, launches=launches,
         ms_per_value=ms_per_value, phases=timer.summary())
    return merged


def phase_hnsw(corpus: np.ndarray, queries: np.ndarray, tmp: str) -> None:
    """``NativeHNSW`` (built with ``g++`` on this host) on the first 16,384
    corpus rows in row order, 1,000 queries, cosine, M=10,
    ef_construction=500, at ef 40 and 100, against the exact kNN of those
    rows from ``ops.knn.knn`` on the card: recall and the mean visit
    count equal the JAX package's.  ``build_s`` and QPS are the host's.
    Then ``cli.train --learner_type hnsw`` on the synthetic dataset."""
    import contextlib
    import io
    import platform

    from nlsh_tpu_torch import native
    from nlsh_tpu_torch.cli import train as train_cli
    from nlsh_tpu_torch.ops.knn import knn
    from nlsh_tpu_torch.utils.metrics import calculate_recall
    from nlsh_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    rows, qs = corpus[:HNSW_ROWS], queries[:HNSW_QUERIES]
    with timer("exact_knn"):
        _, exact = knn(qs, rows, wl.K, metric="cosine", device=DEVICE)
    exact = exact.cpu().numpy()
    with timer("native_build"):
        native.load_library()
    idx = native.NativeHNSW(space="cosine", dim=rows.shape[1])
    idx.init_index(max_elements=HNSW_ROWS, M=10, ef_construction=500)
    with timer("build"):
        idx.add_items(rows)
    out = {}
    for ef, (want_recall, want_visits) in HNSW_REF.items():
        idx.set_ef(ef)
        t0 = time.perf_counter()
        ids, _, counts = idx.knn_query(qs, k=wl.K)
        query_s = time.perf_counter() - t0
        recall = float(calculate_recall(exact, ids, np.mean))
        visits = float(np.mean(counts))
        check(abs(recall - want_recall) <= 1e-6
              and abs(visits - want_visits) <= 1e-6,
              f"HNSW at ef {ef}: recall {recall}, visits {visits} against "
              f"the JAX package's {want_recall}, {want_visits}")
        out[f"ef{ef}"] = {"recall": recall, "mean_visits": visits,
                          "host_qps": HNSW_QUERIES / query_s}
    os.environ["NLSH_SYNTH_CACHE_DIR"] = os.path.join(tmp, "synth_cache")
    with timer("train_cli"), contextlib.redirect_stdout(io.StringIO()):
        cli_recall = train_cli.main(["--data_id", "synthetic",
                                     "--learner_type", "hnsw", "--debug",
                                     "--device", DEVICE])
    check(0.9 < cli_recall <= 1.0, f"cli.train hnsw recall {cli_recall}")
    emit("hnsw", rows=HNSW_ROWS, queries=HNSW_QUERIES, M=10,
         ef_construction=500, host_build_s=timer.totals["build"],
         host=f"{platform.machine()} {platform.processor() or ''}".strip(),
         cxx=subprocess.run([native._cxx(), "--version"], capture_output=True,
                            text=True).stdout.splitlines()[0],
         train_cli_recall=float(cli_recall), note="build_s and QPS are the "
         "host's (one thread), not the card's", **out,
         phases=timer.summary())


# ---------------------------------------------------------------------------
# training: the bench's training configuration at full width
# ---------------------------------------------------------------------------

# the bench's fit (TRAIN_CFG, 1,000 steps) on its 131,072-row subset;
# the JAX package's fit at seeds 0 and 1, exact f32 on the CPU, served by
# the port's plain CPU serve (`train_anchor.py`): recall@10 0.73949 and
# 0.74233, candidates 4670.52 and 4667.84; the committed params (another
# stream) give 0.74264 and 4670.30
TRAIN_EVERY = 500
TRAIN_RECALL_RANGE = (0.730, 0.755)
TRAIN_N_CAND_RANGE = (4400.0, 4950.0)
TRAIN_STEP_CHECK = 20            # steps held card against CPU
TRAIN_STEP_RTOL = 1e-4           # step 1: loss and every gradient
TRAIN_LOSSES_RTOL = 1e-3         # the first 20 steps' losses
# benchmarks/mt_highrecall.py's ensemble: 8 x 12 bits, 600 steps; the
# committed ensemble gives 0.99211 at 4 flip probes per table
ENSEMBLE_TRAIN_STEPS = 600
ENSEMBLE_RECALL_MIN = 0.985
KNN_AGREEMENT_MIN = 0.999
KNN_TIE_TOL = 1e-5               # distances of differing ids, float64


def _train_cfg() -> dict:
    c = wl.TRAIN_CFG
    return dict(margin=c["margin"], positive_k=c["positive_k"],
                balance_lambda=c["balance_lambda"])


def _cosine64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return 1.0 - np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))


def phase_train_knn(sub: np.ndarray, sub_knn: np.ndarray) -> None:
    """The training subset's self-kNN (k = 20, cosine) on the card against
    the committed ``sub_knn`` (the JAX package's exact f32): ids agree on
    at least 0.999 of the slots, and where a row's ids differ its sorted
    float64 distances agree (the rows differ only at ties)."""
    import torch

    from nlsh_tpu_torch.ops.knn import self_knn

    t0 = time.perf_counter()
    nbr = self_knn(sub, k=sub_knn.shape[1], metric="cosine", device=DEVICE)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    nbr = nbr.cpu().numpy()
    check(nbr.shape == sub_knn.shape, "self_knn shape")
    agree = id_agreement(nbr, sub_knn)
    rows = np.flatnonzero(np.any(np.sort(nbr, 1) != np.sort(sub_knn, 1), 1))
    gap = 0.0
    for i in rows:
        ours = np.sort(_cosine64(sub[i], sub[nbr[i]]))
        theirs = np.sort(_cosine64(sub[i], sub[sub_knn[i]]))
        gap = max(gap, float(np.max(np.abs(ours - theirs))))
    check(agree >= KNN_AGREEMENT_MIN,
          f"self_knn vs the committed sub_knn {agree} < {KNN_AGREEMENT_MIN}")
    check(gap <= KNN_TIE_TOL, f"a row's ids differ off a tie: {gap}")
    emit("train_knn", n_rows=int(sub.shape[0]), k=int(sub_knn.shape[1]),
         knn_s=knn_s, agreement=agree, rows_differing=int(rows.size),
         max_distance_gap=gap)


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-30))


def _opt_tensors(state) -> list:
    """The state's params and amsgrad moments, in one list."""
    opt = state.opt_state
    return [*opt.params, *opt.mu, *opt.nu, *opt.nu_max]


def _states_equal(a, b) -> bool:
    import torch

    return a.step == b.step and all(
        torch.equal(x, y) for x, y in zip(_opt_tensors(a), _opt_tensors(b)))


def _segment_runs(trainer, corpus, knn, arrays, bs: int):
    """A trainer's segment, eager (``_run_segment_eager``) and replayed
    (``run_segment``), as ``run(state, seg_start, n_steps) -> losses``."""
    return (lambda state, s, n: trainer._run_segment_eager(
                state, corpus, knn, arrays, s, n, bs)[1],
            lambda state, s, n: trainer.run_segment(
                state, corpus, knn, arrays, s, n, bs)[1])


def _replay_vs_eager(name: str, eager_run, graphed_run, make_state) -> dict:
    """``TRAIN_STEP_CHECK`` steps from ``make_state()`` twice through
    ``eager_run`` (the eager body on the card) and once through
    ``graphed_run`` (replayed, capture included; each ``run(state,
    seg_start, n_steps) -> losses``): the two eager runs' losses, params
    and moments are compared bit for bit, and where they agree the replay
    must agree bit for bit too; where they do not (an atomic sum in a
    backward), the replay is held to ``TRAIN_STEP_RTOL`` in the params
    and ``TRAIN_LOSSES_RTOL`` in the losses.  Returns the replayed state,
    the eager one, the comparison and the replayed and eager losses."""
    runs = []
    for run in (eager_run, eager_run, graphed_run):
        state = make_state()
        runs.append((state, run(state, 0, TRAIN_STEP_CHECK)))
    (eager, l0), (again, l1), (graphed, l2) = runs
    deterministic = _states_equal(again, eager) and bool(l1.equal(l0))
    bitwise = _states_equal(graphed, eager) and bool(l2.equal(l0))
    param_err = max(_rel_err(a, b) for a, b in zip(
        graphed.opt_state.params, eager.opt_state.params))
    losses_err = float(((l2 - l0).abs() / l0.abs()).max())
    if deterministic:
        check(bitwise, f"{name}: the replayed {TRAIN_STEP_CHECK} steps differ "
              f"from the eager body's (params {param_err}, losses "
              f"{losses_err})")
    else:
        check(param_err <= TRAIN_STEP_RTOL
              and losses_err <= TRAIN_LOSSES_RTOL,
              f"{name}: replay vs a non-reproducible eager body: params "
              f"{param_err}, losses {losses_err}")
    return graphed, eager, {"eager_deterministic": deterministic,
                            "replay_bitwise": bitwise,
                            "replay_param_rel_err": param_err,
                            "replay_losses_rel_err": losses_err}, (l2, l0)


def _step_arrays(data, n_steps: int, bs: int, n_tables=None,
                 seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n = data.training.shape[0]
    shape = (n_steps * bs,) if n_tables is None else (n_steps * bs, n_tables)
    return {"anchor": rng.integers(0, n, shape),
            "col": rng.integers(0, 20, shape),
            "neg": rng.integers(0, n, shape)}


def phase_train_step(data, profile: bool = False) -> None:
    """The triplet step at the bench's width, card against CPU, from the
    committed params (``params_from_jax``) on the same injected arrays:
    step 1's loss and every gradient within ``TRAIN_STEP_RTOL`` of the
    tensor's largest magnitude, the first 20 steps' losses (replayed on
    the card) within ``TRAIN_LOSSES_RTOL``; then on the card the replayed
    20 steps against the eager body's (:func:`_replay_vs_eager`).
    ``profile``: then one eager and one replayed step under
    ``torch.profiler`` (``train_profile``, ``train_profile_replayed``)."""
    import torch

    from nlsh_tpu_torch.train import TripletTrainer
    from nlsh_tpu_torch.train.base import device_arrays, param_leaves

    bs = wl.TRAIN_CFG["batch_size"]
    arrays = _step_arrays(data, TRAIN_STEP_CHECK, bs)
    trainer = TripletTrainer(bench_head(), data, **_train_cfg())
    out = {}
    for device in ("cpu", DEVICE):
        params = {"hashing": load_hashing().to(device).train(), "extra": {}}
        corpus = torch.as_tensor(data.training, device=device)
        knn = torch.as_tensor(data.training_self_knn.astype(np.int64),
                              device=device)
        dev_arrays = device_arrays(arrays, device)
        batch = {k: v[:bs] for k, v in dev_arrays.items()}
        loss = trainer.loss_fn(params, corpus, knn, batch, None)
        grads = torch.autograd.grad(loss, param_leaves(params))
        state = trainer.make_state(params, wl.TRAIN_CFG["learning_rate"])
        t0 = time.perf_counter()
        _, losses = trainer.run_segment(state, corpus, knn, dev_arrays, 0,
                                        TRAIN_STEP_CHECK, bs)
        losses = losses.cpu()
        out[device] = (loss, grads, losses, time.perf_counter() - t0)

    def make_state():
        return trainer.make_state(
            {"hashing": load_hashing().to(DEVICE).train(), "extra": {}},
            wl.TRAIN_CFG["learning_rate"])

    graphed, eager, replay, _ = _replay_vs_eager(
        "train_step", *_segment_runs(trainer, corpus, knn, dev_arrays, bs),
        make_state)
    if profile:
        _profile_passes("train_profile", lambda: trainer._run_segment_eager(
            eager, corpus, knn, dev_arrays, 0, 1, bs)[1].cpu(), top=15)
        _profile_passes("train_profile_replayed", lambda: trainer.run_segment(
            graphed, corpus, knn, dev_arrays, 0, 1, bs)[1].cpu(), top=15)
    (l0, g0, s0, cpu_s), (l1, g1, s1, card_s) = out["cpu"], out[DEVICE]
    loss_err = _rel_err(l1, l0)
    grad_err = max(_rel_err(a, b) for a, b in zip(g1, g0))
    losses_err = float(((s1 - s0).abs() / s0.abs()).max())
    check(loss_err <= TRAIN_STEP_RTOL and grad_err <= TRAIN_STEP_RTOL,
          f"step 1 card vs CPU: loss {loss_err}, gradients {grad_err}")
    check(losses_err <= TRAIN_LOSSES_RTOL,
          f"{TRAIN_STEP_CHECK} steps' losses card vs CPU: {losses_err}")
    emit("train_step", batch_size=bs, steps=TRAIN_STEP_CHECK,
         step1_loss=float(l1.detach()), step1_loss_rel_err=loss_err,
         step1_grad_rel_err=grad_err, losses_rel_err=losses_err,
         losses=s1.tolist(), card_s=card_s, cpu_s=cpu_s, **replay)


TRAIN_FUSED_STEPS = 20   # timed steps of each of the eager and replayed runs
TRAIN_FUSED_BUSY = 5     # steps in each pass of the busy-share profile


def _step_numbers(eager_run, graphed_run, eager, graphed) -> dict:
    """The step's time eager and replayed (host ms per step over a
    segment of ``TRAIN_FUSED_STEPS``, synchronised; ``eager_run`` and
    ``graphed_run`` as :func:`_replay_vs_eager` takes them, on the states
    ``eager`` and ``graphed``), each one's device busy share
    (``_busy_share`` over passes of ``TRAIN_FUSED_BUSY`` steps), the
    capture's seconds and the graph's pool."""
    import torch

    out = {}
    for name, state, run in (("eager", eager, eager_run),
                             ("replayed", graphed, graphed_run)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state, TRAIN_STEP_CHECK, TRAIN_FUSED_STEPS).cpu()
        out[f"{name}_step_ms"] = 1e3 * (time.perf_counter() - t0) \
            / TRAIN_FUSED_STEPS
        share = _busy_share(lambda: run(state, 0, TRAIN_FUSED_BUSY).cpu())
        out[f"{name}_busy"] = {  # per step
            k: (v / TRAIN_FUSED_BUSY if k.endswith("_ms")
                or k == "device_events" else v) for k, v in share.items()}
    graph = graphed.step_program.graph
    out.update(capture_s=graph.capture_s,
               graph_pool_mib=graph.pool_bytes / 2 ** 20,
               program_capacity=graphed.step_program.capacity)
    return out


def phase_train_fused(data) -> None:
    """The one-dispatch step (``Trainer.run_segment``: every step a
    replay of the captured ``StepProgram``) at the bench's training
    configuration, for the single table (from the committed params) and
    the L=8 ensemble (8 seeded tables): the replayed 20 steps against the
    eager body's (:func:`_replay_vs_eager`), then the step's time eager
    and replayed, each one's busy share, the capture's seconds and the
    graph's pool (:func:`_step_numbers`).  The step launches no
    hand-written kernel: every tally stays 0."""
    import torch

    from nlsh_tpu_torch.ops.cuda import query_kernel as qk
    from nlsh_tpu_torch.parallel import init_multi_table
    from nlsh_tpu_torch.train import MultiTableTrainer, TripletTrainer
    from nlsh_tpu_torch.train.base import device_arrays

    bs = wl.TRAIN_CFG["batch_size"]
    lr = wl.TRAIN_CFG["learning_rate"]
    corpus = torch.as_tensor(data.training, device=DEVICE)
    knn = torch.as_tensor(data.training_self_knn.astype(np.int64),
                          device=DEVICE)
    n_steps = TRAIN_STEP_CHECK + TRAIN_FUSED_STEPS
    single = TripletTrainer(bench_head(), data, **_train_cfg())
    ensemble = MultiTableTrainer(TripletTrainer(bench_head(), data,
                                                **_train_cfg()), 8)
    cases = (
        ("single", single, None, lambda: single.make_state(
            {"hashing": load_hashing().to(DEVICE).train(), "extra": {}}, lr)),
        ("ensemble", ensemble, 8, lambda: ensemble.make_state(
            {"hashing": [h.to(DEVICE) for h in init_multi_table(
                bench_head(), 8, torch.Generator().manual_seed(
                    wl.SEED))], "extra": {}}, lr)))
    fields = {}
    for name, trainer, n_tables, make_state in cases:
        arrays = device_arrays(_step_arrays(data, n_steps, bs, n_tables),
                               DEVICE)
        reset_launches()
        runs = _segment_runs(trainer, corpus, knn, arrays, bs)
        graphed, eager, replay, _ = _replay_vs_eager(f"train_fused {name}",
                                                     *runs, make_state)
        numbers = _step_numbers(*runs, eager, graphed)
        check(not any(qk.KERNEL_LAUNCHES.values()),
              f"the training step launched a kernel: {qk.KERNEL_LAUNCHES}")
        fields[name] = {**replay, **numbers}
        del graphed, eager
        torch.cuda.empty_cache()
    emit("train_fused", card=CARD["nvidia_smi"], batch_size=bs, **fields)


class _Captures:
    """Every graph captured while entered (``graphs.capture``, the serves'
    and the training step's), for its ``capture_s`` and ``pool_bytes``."""

    def __enter__(self):
        from nlsh_tpu_torch.utils import graphs

        self.graphs, self._capture = [], graphs.capture

        def capture(*args, **kwargs):
            self.graphs.append(self._capture(*args, **kwargs))
            return self.graphs[-1]

        graphs.capture = capture
        return self

    def __exit__(self, *exc):
        from nlsh_tpu_torch.utils import graphs

        graphs.capture = self._capture


class _TimedEvals:
    """Wraps a trainer's ``_evaluate``: the host seconds of each eval, and
    of them the seconds spent capturing the serve's graphs (each eval's
    new ``Indexer`` captures its own)."""

    def __init__(self, evaluate):
        self.seconds, self.capture_s, self.graphs = [], [], []
        self._evaluate = evaluate

    def __call__(self, *args, **kwargs):
        import torch

        t0 = time.perf_counter()
        with _Captures() as captured:
            out = self._evaluate(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.capture_s.append(sum(g.capture_s for g in captured.graphs))
        self.graphs += captured.graphs
        return out


def _fit_logged(trainer, log_path: str, **fit_kw):
    """``trainer.fit`` on the card, timed, with its evals timed; returns
    the state, train_s, the evals' and the captures' numbers and the
    logged metrics."""
    import torch

    evals = trainer._evaluate = _TimedEvals(trainer._evaluate)
    t0 = time.perf_counter()
    with _Captures() as captured:
        state = trainer.fit(device=DEVICE, **fit_kw)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trainer.logger.close()
    metrics = {}
    with open(log_path) as f:
        for line in f:
            r = json.loads(line)
            if r["kind"] == "metric" and r["name"] != "training/loss":
                metrics.setdefault(r["name"], []).append([r["step"],
                                                          r["value"]])
    return state, train_s, _fit_timing(evals, captured), metrics


def _fit_timing(evals: _TimedEvals, captured: _Captures) -> dict:
    """A fit's evals' seconds and capture seconds, and its step graphs'
    (the graphs it captured outside its evals) capture seconds and
    pools."""
    steps = [g for g in captured.graphs
             if not any(g is e for e in evals.graphs)]
    return {"eval_s": evals.seconds, "eval_capture_s": evals.capture_s,
            "step_capture_s": [g.capture_s for g in steps],
            "step_graph_pool_mib": [g.pool_bytes / 2 ** 20 for g in steps]}


def phase_train(data, corpus: np.ndarray, queries: np.ndarray,
                gt: np.ndarray, tmp: str) -> dict:
    """``TripletTrainer.fit`` at the bench's configuration for 1,000
    steps, an eval every 500 (two, on the subset and its 256 queries: K1
    from the trainer), then the full corpus indexed with the trained
    module and the 10,000 queries served at 16 flip probes, cap 512:
    recall@10 and candidates in their windows.  Returns the fit's
    launches."""
    import torch

    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.train import TripletTrainer
    from nlsh_tpu_torch.utils.loggers import JSONLLogger
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    log = os.path.join(tmp, "train.jsonl")
    trainer = TripletTrainer(bench_head(), data, os.path.join(tmp, "train"),
                             logger=JSONLLogger(log, "train"), **_train_cfg())
    reset_launches()
    state, train_s, timing, metrics = _fit_logged(
        trainer, log, K=wl.K, batch_size=wl.TRAIN_CFG["batch_size"],
        learning_rate=wl.TRAIN_CFG["learning_rate"], epochs=100,
        test_every_updates=TRAIN_EVERY, max_steps=wl.TRAIN_STEPS,
        hash_times=wl.HASH_TIMES, seed=wl.SEED)
    launches = read_launches("grouped_scores_topk")
    eval_s = timing["eval_s"]
    check(state.step == wl.TRAIN_STEPS and len(eval_s) == 2
          and len(timing["step_capture_s"]) == 1,
          f"{state.step} steps, {len(eval_s)} evals, "
          f"{len(timing['step_capture_s'])} step captures")

    idx = Indexer(state.params["hashing"], corpus, device=DEVICE,
                  metric="cosine", probe_budget=wl.CAP)
    ids, n_cand = idx.query(queries, k=wl.K, hash_times=wl.HASH_TIMES,
                            probe_mode="flip")
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
    mean_cand = float(n_cand.mean())
    check(TRAIN_RECALL_RANGE[0] <= recall <= TRAIN_RECALL_RANGE[1],
          f"trained recall@10 {recall} outside {TRAIN_RECALL_RANGE}")
    check(TRAIN_N_CAND_RANGE[0] <= mean_cand <= TRAIN_N_CAND_RANGE[1],
          f"trained mean n_candidates {mean_cand} outside "
          f"{TRAIN_N_CAND_RANGE}")
    step_s = train_s - sum(eval_s)
    emit("train", steps=state.step, train_s=train_s, **timing,
         steps_per_s=state.step / step_s, step_ms=1e3 * step_s / state.step,
         launches=launches, eval_metrics=metrics, recall_at_10=recall,
         mean_n_candidates=mean_cand, max_bucket=idx.table.max_count(),
         buckets_used=idx.n_buckets_used())
    del idx
    torch.cuda.empty_cache()
    return launches


def phase_train_ensemble(data, corpus: np.ndarray, queries: np.ndarray,
                         gt: np.ndarray, tmp: str) -> dict:
    """``MultiTableTrainer(L=8)`` at ``benchmarks/mt_highrecall.py``'s
    configuration for 600 steps with one eval (K3 from the trainer), then
    the full corpus served at 4 flip probes per table on the windowed
    engine: recall@10 >= ``ENSEMBLE_RECALL_MIN``.  Returns the fit's
    launches."""
    import torch

    from nlsh_tpu_torch.parallel import MultiTableIndexer
    from nlsh_tpu_torch.train import MultiTableTrainer, TripletTrainer
    from nlsh_tpu_torch.utils.loggers import JSONLLogger
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    log = os.path.join(tmp, "train_ensemble.jsonl")
    inner = TripletTrainer(bench_head(), data,
                           os.path.join(tmp, "train_ensemble"),
                           logger=JSONLLogger(log, "ensemble"), **_train_cfg())
    trainer = MultiTableTrainer(inner, 8)
    reset_launches()
    state, train_s, timing, metrics = _fit_logged(
        trainer, log, K=wl.K, batch_size=wl.TRAIN_CFG["batch_size"],
        learning_rate=wl.TRAIN_CFG["learning_rate"], epochs=1000,
        test_every_updates=ENSEMBLE_TRAIN_STEPS,
        max_steps=ENSEMBLE_TRAIN_STEPS, hash_times=wl.HASH_TIMES, seed=wl.SEED)
    launches = read_launches("windowed_scores_topk")
    eval_s = timing["eval_s"]
    check(state.step == ENSEMBLE_TRAIN_STEPS and len(eval_s) == 1
          and len(timing["step_capture_s"]) == 1,
          f"{state.step} steps, {len(eval_s)} evals, "
          f"{len(timing['step_capture_s'])} step captures")

    midx = MultiTableIndexer(state.params["hashing"], corpus, device=DEVICE,
                             metric="cosine")
    kw = dict(hash_times=wl.ENSEMBLE_HASH_TIMES, probe_mode="flip")
    midx.calibrate(queries, **kw)
    ids, n_cand = midx.query(queries, k=wl.K, **kw)
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
    size = float(midx.exact_query_size(queries, **kw).mean())
    check(recall >= ENSEMBLE_RECALL_MIN,
          f"trained ensemble recall@10 {recall} < {ENSEMBLE_RECALL_MIN}")
    step_s = train_s - sum(eval_s)
    emit("train_ensemble", n_tables=8, steps=state.step, train_s=train_s,
         **timing, steps_per_s=state.step / step_s,
         step_ms=1e3 * step_s / state.step, launches=launches,
         eval_metrics=metrics, engine=midx.engine, recall_at_10=recall,
         mean_n_candidates=float(n_cand.mean()), mean_exact_query_size=size,
         max_bucket=[int(c) for c in midx.counts.max(dim=1).values],
         buckets_used=[int(c) for c in (midx.counts > 0).sum(dim=1)])
    del midx
    torch.cuda.empty_cache()
    return launches


def phase_train_cli(tmp: str) -> dict:
    """``python3 -m nlsh_tpu_torch.cli.train`` (its ``main``) on the
    synthetic dataset with the JSONL logger, on the card by default: it
    checkpoints at its evals, ``load_model`` of the last checkpoint
    serves the dataset, and ``--resume_from`` continues at the saved
    step.  Returns the launches of the run, the serve and the resume."""
    import contextlib
    import io

    from nlsh_tpu_torch.cli import train as cli
    from nlsh_tpu_torch.data import SyntheticDataset
    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.train.base import Trainer
    from nlsh_tpu_torch.utils.checkpoint import load_model
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    os.environ["NLSH_SYNTH_CACHE_DIR"] = os.path.join(tmp, "synth_cache")
    os.environ["NLSH_LOG_DIR"] = os.path.join(tmp, "train_logs")
    save_dir = os.path.join(tmp, "cli_models")
    common = ["--data_id", "synthetic", "--test_every_updates", "32",
              "--hash_times", "8", "--probe_mode", "flip"]
    check(cli.nlsh_argparse().parse_args(common).device == "cuda",
          "the training CLI defaults to the card")
    reset_launches()
    printed = io.StringIO()
    evaluate = Trainer._evaluate
    evals = _TimedEvals(evaluate)
    Trainer._evaluate = lambda self, *args, **kw: evals(self, *args, **kw)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed), _Captures() as captured:
            state = cli.main(common + ["--logger_type", "jsonl",
                                       "--max_steps", "64",
                                       "--model_save_dir", save_dir])
    finally:
        Trainer._evaluate = evaluate
    train_s = time.perf_counter() - t0
    saved = sorted((f for f in os.listdir(save_dir) if f.endswith(".state")),
                   key=lambda f: int(f.split("_")[-2]))
    check(state.step == 64 and bool(saved), f"CLI run: {state.step}, {saved}")
    base = os.path.join(save_dir, saved[-1][:-len(".state")])
    saved_step = int(saved[-1].split("_")[-2])
    logs = os.listdir(os.environ["NLSH_LOG_DIR"])
    with open(os.path.join(os.environ["NLSH_LOG_DIR"], logs[0])) as f:
        logged = [json.loads(line) for line in f]
    loss_steps = [r["step"] for r in logged if r.get("name") == "training/loss"]
    check(loss_steps == list(range(1, 65)), "the JSONL log's loss steps")

    hashing = load_model(base, device=DEVICE)
    data = SyntheticDataset(device=DEVICE).load()
    idx = Indexer(hashing, data.training, device=DEVICE)
    ids, n_cand = idx.query(data.testing, k=wl.K, hash_times=8,
                            probe_mode="flip")
    recall = float(calculate_recall(data.ground_truth[:, :wl.K], ids, np.mean))
    check(ids.shape == (data.testing.shape[0], wl.K) and 0.0 < recall <= 1.0,
          f"the checkpoint's serve: {ids.shape}, recall {recall}")

    with contextlib.redirect_stdout(io.StringIO()):
        resumed = cli.main(common + ["--debug", "--max_steps",
                                     str(saved_step + 32), "--resume_from",
                                     base + ".state", "--model_save_dir",
                                     os.path.join(tmp, "cli_resumed")])
    check(resumed.step == saved_step + 32
          and resumed.opt_state.count == saved_step + 32,
          f"resumed at {saved_step}: {resumed.step} steps")
    launches = read_launches("grouped_scores_topk")
    emit("train_cli", steps=state.step, train_s=train_s,
         **_fit_timing(evals, captured), checkpoints=saved,
         resumed_from=saved_step, resumed_to=resumed.step,
         serve_recall_at_10=recall, serve_mean_n_candidates=float(
             n_cand.mean()), launches=launches)
    return launches


# ---------------------------------------------------------------------------
# multi-device: the corpus-sharded index, the table-sharded ensemble,
# data-parallel training and BASELINE's config 5, on the one card through
# meshes that name it more than once
# ---------------------------------------------------------------------------

SHARDS = 4                   # entries of the repeated-device meshes
DP_ENTRIES = 2               # entries of train_dp's meshes
CONFIG5_N = 10_000_000       # benchmarks/configs.py config_5, seed 0
CONFIG5_QUERIES = 2_000
CONFIG5_BIG_BATCH = 16_384   # fresh queries of the same cluster model
CONFIG5_GATHER_QUERIES = 500
CONFIG5_BITS = 14
CONFIG5_STEPS = 400
CONFIG5_SUBSET = 131_072
# config 5's fit with its data-parallel steps run eagerly, before they
# were replayed: the range of train_s over five whole runs of this script
# on an H100 80GB HBM3 at 700 W
CONFIG5_EAGER_TRAIN_S = (3.16, 3.49)


# a bf16 row of a unit vector is off by at most 2**-9 of its norm, so a
# unit query's score of it is off by at most 2**-9, and the bf16 serve can
# rank a row above another only when their exact scores are within 2**-8
BF16_SCORE_BOUND = 2.0 ** -8 + 1e-6


def _bf16_regret(corpus, queries, ids, exact_ids) -> float:
    """The largest amount by which a bf16 serve's r-th best exact cosine
    (its ids re-scored in float64) falls below the exact engine's r-th,
    over every query and rank r."""
    def ranked(sel):
        rows = corpus[np.clip(sel, 0, None)].astype(np.float64)
        sims = np.einsum("qkd,qd->qk", rows, queries.astype(np.float64))
        return -np.sort(-np.where(sel >= 0, sims, -np.inf), axis=1)

    want, got = ranked(exact_ids), ranked(ids)
    both_empty = np.isneginf(want) & np.isneginf(got)
    return float(np.max(np.where(both_empty, 0.0, want - got)))


def _card_mesh(n: int, axis: str):
    """A mesh of ``n`` entries that all name the one card."""
    from nlsh_tpu_torch.parallel import Mesh

    return Mesh([f"{DEVICE}:0"] * n, axis)


def _slot_agreement(a: np.ndarray, b: np.ndarray) -> float:
    return float((a == b).mean())


class _Uncounted:
    """Kernel launches made inside are taken off the tallies again: the
    eager bodies a replay is compared with and timed against."""

    def __enter__(self):
        from nlsh_tpu_torch.ops.cuda import query_kernel as qk

        self.kept = dict(qk.KERNEL_LAUNCHES)

    def __exit__(self, *exc):
        from nlsh_tpu_torch.ops.cuda import query_kernel as qk

        qk.KERNEL_LAUNCHES.update(self.kept)


def _serve_replay(what: str, replay, body, q, graphs) -> dict:
    """A serve replayed (``replay()``: the packed result of
    ``query_async``, whose graph is captured; a one-card mesh's serve or
    a gather engine's) against its body run eagerly on the same batch
    (``body(q, None)``: flip probes), bit for bit; then the eager and the
    replayed pass (ms, fetched) and each one's busy share, and the
    graph's pool and capture seconds.  The eager runs' launches are not
    counted."""
    import torch

    packed = replay()
    with _Uncounted(), torch.no_grad():
        eager = body(q, None)
        check(bool(torch.equal(packed, eager)),
              f"{what}: the replay differs from the eager body")

        def eager_pass():
            with torch.no_grad():
                return body(q, None).cpu().numpy()

        def replay_pass():
            return replay().cpu().numpy()

        eager_ms = _pass_ms(eager_pass, FUSED_PASSES)
        busy_eager = _busy_share(eager_pass)
    replay_ms = _pass_ms(replay_pass, FUSED_PASSES)
    return {"replay_equals_eager": True, "eager_pass_ms": eager_ms,
            "eager_median_ms": float(np.median(eager_ms)),
            "replay_pass_ms": replay_ms,
            "replay_median_ms": float(np.median(replay_ms)),
            "busy": {"eager": busy_eager, "replay": _busy_share(replay_pass)},
            "graph_pool_mib": graphs.pool_bytes()[-1] / 2 ** 20,
            "capture_s": graphs.capture_s()[-1]}


def phase_sharded(corpus: np.ndarray, queries: np.ndarray, gt: np.ndarray,
                  tmp: str) -> dict:
    """``ShardedIndexer`` over ``make_mesh(1, "shard")`` and over 4 entries
    of the card, on the grouped (K1), windowed (K3), fixed-cap (K5) and
    gather engines, 16 flip probes, k = 10, against an ``Indexer`` built
    with ``probe_budget=None``: the sharded layouts take the largest
    bucket of any shard as their cap (543 -> 1,024 on one shard), not
    the serve's 512.  Every engine and mesh: recall and candidates in
    the single table's windows, candidates equal to that ``Indexer``'s
    query by query, ids on >= 0.999 of its slots.  Per-row int8 on the
    grouped engine: recall in the int8 window.  ``save``/``load`` at
    D = 4, and a load on a one-entry mesh refused.  ``build_s``, the
    median of 3 passes and QPS per mesh and engine.  Both meshes repeat
    one card, so every engine, gather included, replays one captured
    graph per batch: each replay equals the serve's body run eagerly bit
    for bit, with the eager and the replayed pass, their busy shares and
    the graph's pool (:func:`_serve_replay`).  Returns the launches of
    the sharded serves (captures' warm-ups and replays)."""
    import torch

    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.index.query import default_query_chunk
    from nlsh_tpu_torch.parallel import ShardedIndexer, make_mesh
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    kw = dict(k=wl.K, hash_times=wl.HASH_TIMES, probe_mode="flip")
    ref = Indexer(load_hashing(), corpus, device=DEVICE, metric="cosine")
    r_ids, r_cand = ref.query(queries, **kw)
    ref_cap = ref.layout.cap
    del ref
    torch.cuda.empty_cache()

    def held(ids, n_cand, what):
        recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
        mean_cand = float(n_cand.mean())
        check(RECALL_RANGE[0] <= recall <= RECALL_RANGE[1],
              f"{what}: recall@10 {recall} outside {RECALL_RANGE}")
        check(N_CAND_RANGE[0] <= mean_cand <= N_CAND_RANGE[1],
              f"{what}: mean n_candidates {mean_cand} outside {N_CAND_RANGE}")
        check(bool(np.array_equal(n_cand, r_cand)),
              f"{what}: candidates differ from the Indexer's")
        agree = id_agreement(ids, r_ids)
        check(agree >= 0.999, f"{what}: ids vs the Indexer {agree} < 0.999")
        return {"recall_at_10": recall, "mean_n_candidates": mean_cand,
                "id_agreement": agree,
                "slot_agreement": _slot_agreement(ids, r_ids)}

    q = torch.as_tensor(queries, device=DEVICE)
    reset_launches()
    out = {}
    for d, mesh in ((1, make_mesh(1, "shard")),
                    (SHARDS, _card_mesh(SHARDS, "shard"))):
        t0 = time.perf_counter()
        idx = ShardedIndexer(load_hashing(), corpus, mesh, metric="cosine")
        cap = idx._build_layouts()[0].cap
        torch.cuda.synchronize()
        row = {"build_s": time.perf_counter() - t0, "cap": cap,
               "n_local": idx.n_local, "engines": {}}
        for engine in ("grouped", "windowed", "fixed", "gather"):
            idx.engine = engine
            ids, n_cand = idx.query(queries, **kw)
            res = held(ids, n_cand, f"sharded D={d} {engine}")
            timed = _timed_passes(lambda: idx.query(queries, **kw), 3)
            row["engines"][engine] = {
                **res, "median_s": timed["median_s"],
                "qps": queries.shape[0] / timed["median_s"]}
            body = idx._serve_body(wl.K, wl.HASH_TIMES, "flip") \
                if engine != "gather" else idx._gather_body(
                    wl.K, wl.HASH_TIMES, "flip", default_query_chunk(
                        wl.HASH_TIMES, idx.probe_budget, q.shape[1]))
            row["engines"][engine].update(_serve_replay(
                f"sharded D={d} {engine}", lambda: idx.query_async(q, **kw),
                body, q, idx._graphs))
        if d == SHARDS:
            idx.engine = "grouped"
            path = os.path.join(tmp, "sharded.npz")
            g_ids, _ = idx.query(queries, **kw)
            idx.save(path)
            t0 = time.perf_counter()
            back = ShardedIndexer.load(path, load_hashing(), corpus, mesh)
            row["load_s"] = time.perf_counter() - t0
            b_ids, b_cand = back.query(queries, **kw)
            check(bool(np.array_equal(b_ids, g_ids)),
                  "sharded load: ids differ from the saved index's")
            check(bool(np.array_equal(b_cand, r_cand)),
                  "sharded load: candidates differ")
            refused = False
            try:
                ShardedIndexer.load(path, load_hashing(), corpus,
                                    make_mesh(1, "shard"))
            except ValueError:
                refused = True
            check(refused, "a 4-way index loaded on a one-entry mesh")
            row["file_bytes"] = os.path.getsize(path)
            del back
        del idx
        i8 = ShardedIndexer(load_hashing(), corpus, mesh, metric="cosine",
                            engine="grouped", serving_dtype=torch.int8)
        ids, n_cand = i8.query(queries, **kw)
        recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
        check(INT8_RECALL_RANGE[0] <= recall <= INT8_RECALL_RANGE[1],
              f"sharded D={d} int8 recall@10 {recall} outside "
              f"{INT8_RECALL_RANGE}")
        check(bool(np.array_equal(n_cand, r_cand)),
              f"sharded D={d} int8: candidates differ")
        row["int8_grouped_recall_at_10"] = recall
        del i8
        torch.cuda.empty_cache()
        out[str(d)] = row
    launches = read_launches("grouped_scores_topk", "windowed_scores_topk",
                             "bucket_scores_auto")
    emit("sharded", card=CARD["nvidia_smi"],
         n_queries=int(queries.shape[0]), k=wl.K,
         hash_times=wl.HASH_TIMES, indexer_cap=ref_cap, meshes=out,
         launches=launches)
    return launches


def phase_ensemble_sharded(corpus: np.ndarray, queries: np.ndarray,
                           gt: np.ndarray, mt_ids, mt_cand) -> dict:
    """The committed 8-table ensemble over 4 entries of the card (2 tables
    each), 4 flip probes per table, on the windowed (K3), grouped (K1)
    and fixed-cap (K5) engines: ids >= 0.999 of the unsharded ensemble's,
    recall and summed candidates in their windows (and equal to the
    unsharded serve's); on the gather engine (1,000 queries)
    ``n_candidates``, the psum of each entry's distinct count, is at
    least the exact distinct count.  The windowed and fixed-cap serves
    replay one captured graph per batch: each replay equals the body run
    eagerly bit for bit, with the eager and the replayed pass, their busy
    shares and the graph's pool (:func:`_serve_replay`).  Returns the
    launches."""
    import torch

    from nlsh_tpu_torch.parallel import MultiTableIndexer
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    kw = dict(k=wl.K, hash_times=wl.ENSEMBLE_HASH_TIMES, probe_mode="flip")
    q = torch.as_tensor(queries, device=DEVICE)
    reset_launches()
    t0 = time.perf_counter()
    midx = MultiTableIndexer(load_ensemble(), corpus, metric="cosine",
                             mesh=_card_mesh(SHARDS, "table"))
    midx._entry_layouts()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    per = {}
    for engine in ("windowed", "grouped", "fixed"):
        midx.engine = engine
        ids, n_cand = midx.query(queries, **kw)
        recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
        mean_cand = float(n_cand.mean())
        agree = id_agreement(ids, mt_ids)
        check(agree >= 0.999,
              f"table-sharded {engine} vs unsharded {agree} < 0.999")
        check(MT_RECALL_RANGE[0] <= recall <= MT_RECALL_RANGE[1],
              f"table-sharded {engine} recall@10 {recall} outside "
              f"{MT_RECALL_RANGE}")
        check(MT_N_CAND_RANGE[0] <= mean_cand <= MT_N_CAND_RANGE[1],
              f"table-sharded {engine} n_candidates {mean_cand} outside "
              f"{MT_N_CAND_RANGE}")
        check(bool(np.array_equal(n_cand, mt_cand)),
              f"table-sharded {engine}: summed candidates differ")
        timed = _timed_passes(lambda: midx.query(queries, **kw), 3)
        per[engine] = {"recall_at_10": recall, "mean_n_candidates": mean_cand,
                       "vs_unsharded": agree, "median_s": timed["median_s"],
                       "qps": queries.shape[0] / timed["median_s"]}
        if engine != "grouped":
            per[engine].update(_serve_replay(
                f"table-sharded {engine}", lambda: midx.query_async(q, **kw),
                midx._mesh_serve_body(wl.K, wl.ENSEMBLE_HASH_TIMES, "flip"), q,
                midx._graphs))
    launches = read_launches("grouped_scores_topk", "windowed_scores_topk",
                             "bucket_scores_auto")
    midx.engine = "gather"
    head = queries[:MT_GATHER_QUERIES]
    x_ids, x_cand = midx.query(head, **kw)
    exact = midx.exact_query_size(head, hash_times=wl.ENSEMBLE_HASH_TIMES,
                                  probe_mode="flip")
    check(bool((x_cand >= exact).all()),
          "table-sharded gather: n_candidates below the exact distinct count")
    gather_agree = id_agreement(x_ids, mt_ids[:MT_GATHER_QUERIES])
    check(gather_agree >= 0.98,
          f"table-sharded gather vs unsharded {gather_agree} < 0.98")
    emit("ensemble_sharded", card=CARD["nvidia_smi"],
         n_queries=int(queries.shape[0]), k=wl.K,
         hash_times=wl.ENSEMBLE_HASH_TIMES, entries=SHARDS,
         tables_per_entry=midx.n_tables // SHARDS, build_s=build_s,
         engines=per, gather_queries=MT_GATHER_QUERIES,
         gather_mean_n_candidates=float(x_cand.mean()),
         gather_mean_exact=float(exact.mean()),
         gather_vs_unsharded=gather_agree, launches=launches)
    del midx
    torch.cuda.empty_cache()
    return launches


def phase_train_dp(data) -> None:
    """The bench's training step over a 2-entry mesh of the card against
    the same data-parallel runner over 2 CPU entries, from the committed
    params on the same injected arrays: step 1's ``pmean``-ed loss and
    every gradient within ``TRAIN_STEP_RTOL``, the first 20 losses within
    ``TRAIN_LOSSES_RTOL``.  On the card the 20 steps replayed (every step
    a replay of the captured ``DPStepProgram``) against the eager body's
    (``_run_segment_eager``; :func:`_replay_vs_eager`), both held to the
    CPU's losses; then the step's time eager and replayed, each one's
    busy share, the capture's seconds and the graph's pool
    (:func:`_step_numbers`)."""
    import torch

    from nlsh_tpu_torch.parallel import Mesh
    from nlsh_tpu_torch.parallel.dp import build_dp_segment_runner
    from nlsh_tpu_torch.train import TripletTrainer
    from nlsh_tpu_torch.train.base import device_arrays

    bs = wl.TRAIN_CFG["batch_size"]
    lr = wl.TRAIN_CFG["learning_rate"]
    arrays = _step_arrays(data, TRAIN_STEP_CHECK + TRAIN_FUSED_STEPS, bs,
                          seed=1)
    trainer = TripletTrainer(bench_head(), data, **_train_cfg())
    out = {}
    for device, mesh in (("cpu", Mesh(["cpu"] * DP_ENTRIES, "data")),
                         (DEVICE, _card_mesh(DP_ENTRIES, "data"))):
        home = mesh.devices[0]
        corpus = torch.as_tensor(data.training, device=home)
        knn = torch.as_tensor(data.training_self_knn.astype(np.int64),
                              device=home)
        dev_arrays = device_arrays(arrays, home)
        run = build_dp_segment_runner(trainer, bs, mesh)

        def make_state():
            return trainer.make_state(
                {"hashing": load_hashing().to(home).train(), "extra": {}}, lr)

        loss, grads = run.loss_and_grads(make_state(), corpus, knn,
                                         dev_arrays, 0)
        t0 = time.perf_counter()
        _, losses = run(make_state(), corpus, knn, dev_arrays, 0,
                        TRAIN_STEP_CHECK)
        losses = losses.cpu()
        out[device] = (loss, grads, losses, time.perf_counter() - t0)
    (l0, g0, s0, cpu_s), (l1, g1, s1, card_s) = out["cpu"], out[DEVICE]
    runs = (lambda state, s, n: run._run_segment_eager(
                state, corpus, knn, dev_arrays, s, n)[1],
            lambda state, s, n: run(state, corpus, knn, dev_arrays, s, n)[1])
    graphed, eager, replay, (replayed_losses, eager_losses) = \
        _replay_vs_eager("train_dp", *runs, make_state)
    loss_err = _rel_err(l1, l0)
    grad_err = max(_rel_err(a, b) for a, b in zip(g1, g0))
    check(loss_err <= TRAIN_STEP_RTOL and grad_err <= TRAIN_STEP_RTOL,
          f"data-parallel step 1 card vs CPU: loss {loss_err}, gradients "
          f"{grad_err}")
    vs_cpu = {}
    for name, got in (("losses", s1), ("replayed_losses", replayed_losses),
                      ("eager_losses", eager_losses)):
        vs_cpu[name] = float(((got.cpu() - s0).abs() / s0.abs()).max())
        check(vs_cpu[name] <= TRAIN_LOSSES_RTOL,
              f"data-parallel {TRAIN_STEP_CHECK} {name} card vs CPU: "
              f"{vs_cpu[name]}")
    numbers = _step_numbers(*runs, eager, graphed)
    emit("train_dp", card=CARD["nvidia_smi"], entries=DP_ENTRIES,
         batch_size=bs, steps=TRAIN_STEP_CHECK, step1_loss=float(l1),
         step1_loss_rel_err=loss_err, step1_grad_rel_err=grad_err,
         losses_rel_err=vs_cpu["losses"],
         replayed_losses_rel_err=vs_cpu["replayed_losses"],
         eager_losses_rel_err=vs_cpu["eager_losses"], losses=s1.tolist(),
         card_s=card_s, cpu_s=cpu_s, **replay, **numbers)
    del graphed, eager
    torch.cuda.empty_cache()


class _SubsetData:
    """A configuration's training set: the subset, its self-kNN, 256
    queries (config 5's and config 2's)."""

    def __init__(self, subset, sub_knn, queries, gt, metric="cosine"):
        self.training, self.training_self_knn = subset, sub_knn
        self.testing, self.ground_truth = queries[:256], gt[:256]
        self.metric, self.prepared, self.dim = metric, True, subset.shape[1]

    def load(self):
        return self


def phase_config5(tmp: str) -> dict:
    """BASELINE's config 5 at full width: ``benchmarks/configs.py``'s
    deep-image-96 workload (10,000,000 x 96, 2,000 queries, seed 0; its
    float64 noise is a ~7.7 GB transient on the host), exact ground truth
    of the queries on the card, a 14-bit SIREN 96->256->256 fitted as
    ``config_5`` fits it (131,072-row subset, self-kNN k = 20, triplet
    margin 0.5, positive_k 20, balance 1.5, batch 2048, lr 1e-3, 400
    steps) through ``fit(mesh=make_mesh(axis="data"))``, then the bf16
    grouped serve at 16 flip probes through ``make_mesh(axis="shard")``
    with ``layout_mode="host"`` (the lazy corpus: the raw rows never on
    the card) and through 4 entries of the card, built on the card:
    candidates equal between the two, ids >= 0.999; on 500 queries K1
    against its plain version (>= 0.999) and the exact f32 gather engine
    (candidates equal; the r-th best exact cosine never more than
    ``BF16_SCORE_BOUND`` below the gather's: bf16 rows reorder near-ties,
    0.962 of the ids agree).  No recall window: the port's training streams
    are its own.  Recall, candidates, ``build_s``, QPS at 2,000 and
    16,384 queries, peak device memory.  Returns the serves' launches."""
    import torch

    from nlsh_tpu_torch.models import get_encoder, get_hashing
    from nlsh_tpu_torch.ops.knn import knn, self_knn
    from nlsh_tpu_torch.parallel import ShardedIndexer, make_mesh
    from nlsh_tpu_torch.train import TripletTrainer
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    centers, corpus, queries = wl.deepimage96_workload(
        rng, CONFIG5_N, n_test=CONFIG5_QUERIES, dim=96)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, gt = knn(queries, corpus, k=wl.K, metric="cosine", device=DEVICE,
                query_tile=1024, corpus_chunk=131_072)
    gt = gt.cpu().numpy()
    torch.cuda.empty_cache()
    gt_s = time.perf_counter() - t0

    sub = rng.choice(CONFIG5_N, CONFIG5_SUBSET, replace=False)
    subset = corpus[sub]
    sub_knn = self_knn(subset, k=20, metric="cosine",
                       device=DEVICE).cpu().numpy()
    head = get_hashing("MultivariateBernoulli",
                       get_encoder("siren", 96, [256, 256]), CONFIG5_BITS)
    trainer = TripletTrainer(head, _SubsetData(subset, sub_knn, queries, gt),
                             os.path.join(tmp, "config5"), margin=0.5,
                             positive_k=20, balance_lambda=1.5)
    t0 = time.perf_counter()
    with _Captures() as captured:
        state = trainer.fit(K=wl.K, batch_size=2048, learning_rate=1e-3,
                            epochs=100, test_every_updates=10 ** 9,
                            max_steps=CONFIG5_STEPS, hash_times=10,
                            mesh=make_mesh(axis="data"))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(len(captured.graphs) == 1,
          f"config 5 fit: {len(captured.graphs)} step graphs, not one")
    check(state.step == CONFIG5_STEPS, f"config 5 fit: {state.step} steps")
    hashing = state.params["hashing"].eval()

    kw = dict(k=wl.K, hash_times=wl.HASH_TIMES, probe_mode="flip")
    big = wl.deepimage96_points(centers, rng, CONFIG5_BIG_BATCH, dim=96)
    reset_launches()
    serves = {}
    answers = {}
    for name, mesh, mode in (("lazy_1", make_mesh(axis="shard"), "host"),
                             (f"device_{SHARDS}",
                              _card_mesh(SHARDS, "shard"), "device")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = ShardedIndexer(hashing, corpus, mesh, metric="cosine",
                             engine="grouped", serving_dtype=torch.bfloat16,
                             layout_mode=mode)
        lay = idx._build_layouts()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if mode == "host":
            check(idx._corpus_local is None,
                  "the lazy corpus went to the card")
        ids, n_cand = idx.query(queries, **kw)
        answers[name] = (ids, n_cand)
        timed = _timed_passes(lambda: idx.query(queries, **kw), 3)
        big_timed = _timed_passes(lambda: idx.query(big, **kw), 3)
        serves[name] = {
            "build_s": build_s, "cap": lay[0].cap,
            "layout_gib": sum(x.data.numel() * x.data.element_size()
                              for x in lay) / 2 ** 30,
            "recall_at_10": float(calculate_recall(gt[:, :wl.K], ids,
                                                   np.mean)),
            "mean_n_candidates": float(n_cand.mean()),
            "median_s": timed["median_s"],
            "qps": queries.shape[0] / timed["median_s"],
            "big_batch_median_s": big_timed["median_s"],
            "big_batch_qps": CONFIG5_BIG_BATCH / big_timed["median_s"]}
        if mode == "device":
            n = CONFIG5_GATHER_QUERIES
            p_ids, p_cand = idx.query(queries[:n], plain=True, **kw)
            vs_plain = id_agreement(ids[:n], p_ids)
            check(bool(np.array_equal(p_cand, n_cand[:n])) and
                  vs_plain >= 0.999,
                  f"config 5: bf16 K1 vs its plain version {vs_plain}")
            idx.engine = "gather"
            x_ids, x_cand = idx.query(queries[:n], **kw)
            check(bool(np.array_equal(x_cand, n_cand[:n])),
                  "config 5: gather candidates differ from grouped")
            regret = _bf16_regret(corpus, queries[:n], ids[:n], x_ids)
            check(regret <= BF16_SCORE_BOUND,
                  f"config 5: bf16 grouped ranks {regret} below the exact "
                  f"f32 gather, over the bf16 bound {BF16_SCORE_BOUND}")
            serves[name].update(
                k1_vs_plain=vs_plain,
                gather_vs_grouped=id_agreement(ids[:n], x_ids),
                gather_slot_agreement=_slot_agreement(ids[:n], x_ids),
                max_rank_regret=regret)
        del idx, lay
        torch.cuda.empty_cache()
    launches = read_launches("grouped_scores_topk")
    (a_ids, a_cand), (b_ids, b_cand) = answers.values()
    check(bool(np.array_equal(a_cand, b_cand)),
          "config 5: candidates differ between the lazy and 4-entry serves")
    agree = id_agreement(a_ids, b_ids)
    check(agree >= 0.999, f"config 5: lazy vs 4-entry ids {agree} < 0.999")
    emit("config5", card=CARD["nvidia_smi"], n_corpus=CONFIG5_N, dim=96,
         n_queries=CONFIG5_QUERIES,
         bits=CONFIG5_BITS, hash_times=wl.HASH_TIMES, k=wl.K, data_s=data_s,
         gt_s=gt_s, train_steps=state.step, train_s=train_s,
         train_s_eager_before=CONFIG5_EAGER_TRAIN_S,
         step_capture_s=captured.graphs[0].capture_s,
         step_graph_pool_mib=captured.graphs[0].pool_bytes / 2 ** 20,
         serves=serves, lazy_vs_device=agree, big_batch=CONFIG5_BIG_BATCH,
         peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches)
    return launches


# the windows of the configurations (``nlsh_tpu_torch.data.configs``) on
# the card: the JAX package's fits served by the port's plain CPU serve
# (``train_anchor.py --config <name>``), their range widened by about its
# width.
# Config 1 (seeds 0-3, CPU probe seeds 0-2): recall 0.88050-0.90160,
# candidates 3915.56-4487.00; config 2 (seeds 0-3): recall 0.98643-0.99294
# (0.99276, 0.99216, 0.99294, 0.98643), candidates 3873.47-3893.46.
# Config 4 (seeds 0-3; its candidates are ``exact_query_size``'s distinct
# count, the quantity ``config_4`` reports): recall 0.99961-0.99975,
# candidates 2462.07-2733.62 (summed over the tables 4412.32-4744.97).
# Config pq (seeds 0-3, CPU probe seeds 0-2, the bf16 layout): recall
# 0.81360-0.82940, candidates 3639.68-6177.17 (the fits spread: 265 to 452
# buckets used).
CONFIG_WINDOWS = {
    "1": {"recall": (0.86, 0.925), "n_cand": (3500.0, 5000.0)},
    "2": {"recall": (0.980, 0.997), "n_cand": (3700.0, 4050.0)},
    "4": {"recall": (0.9994, 1.0), "n_cand": (2190.0, 3010.0)},
    "pq": {"recall": (0.797, 0.846), "n_cand": (1100.0, 8720.0)},
}
CONFIG_PROBE_SEED = 1        # the card generator of the sampled probes
CONFIG_PLAIN_QUERIES = 1_000  # queries of the K1 / K3 vs plain serves
CONFIG_PASSES = 5


def _config_fit(name: str, tmp: str):
    """The configuration's data and fit on the card: ``config_data``
    (ground truth and, up to 200,000 rows, the self-kNN on the card; for
    a ``subset`` its rows drawn with ``default_rng(0)`` and their
    self-kNN from ``ops.knn.self_knn``), then ``config_head`` fitted by
    ``TripletTrainer.fit`` as ``benchmarks/configs.py``'s ``_train`` fits
    it (margin 0.5, positive_k 20, lr 1e-3), through
    ``MultiTableTrainer`` for an ensemble.  Returns the data, the fitted
    state and the stages' seconds and peak device memory."""
    import torch

    from nlsh_tpu_torch import models
    from nlsh_tpu_torch.data.configs import CONFIGS, config_data, config_head
    from nlsh_tpu_torch.ops.knn import self_knn
    from nlsh_tpu_torch.train import MultiTableTrainer, TripletTrainer

    cfg = CONFIGS[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = config_data(*cfg["data"], device=DEVICE)
    torch.cuda.synchronize()
    stats = {"data_s": time.perf_counter() - t0, "subset_knn_s": None}
    peak_gib = {"data": torch.cuda.max_memory_allocated() / 2 ** 30}
    train_data = data
    if cfg["subset"]:
        corpus = data.training
        sub = np.random.default_rng(0).choice(corpus.shape[0], cfg["subset"],
                                              replace=False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sub_knn = self_knn(corpus[sub], k=20, metric=data.metric,
                           device=DEVICE).cpu().numpy()
        stats["subset_knn_s"] = time.perf_counter() - t0
        peak_gib["subset_knn"] = torch.cuda.max_memory_allocated() / 2 ** 30
        train_data = _SubsetData(corpus[sub], sub_knn, data.testing,
                                 data.ground_truth, data.metric)
    check(train_data.training_self_knn.shape == (train_data.training.shape[0],
                                                 20), "the self-kNN's shape")
    trainer = TripletTrainer(config_head(models, cfg, data.dim), train_data,
                             os.path.join(tmp, f"config{name}"),
                             margin=0.5, positive_k=20,
                             balance_lambda=cfg["balance_lambda"])
    if cfg["n_tables"]:
        trainer = MultiTableTrainer(trainer, cfg["n_tables"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Captures() as captured:
        state = trainer.fit(K=wl.K, batch_size=cfg["batch_size"],
                            learning_rate=1e-3, epochs=1000,
                            test_every_updates=10 ** 9,
                            max_steps=cfg["steps"],
                            hash_times=cfg["train_hash_times"], device=DEVICE)
    torch.cuda.synchronize()
    stats["train_s"] = time.perf_counter() - t0
    check(state.step == cfg["steps"], f"config {name} fit: {state.step} steps")
    check(len(captured.graphs) == 1,
          f"config {name} fit: {len(captured.graphs)} step graphs, not one")
    peak_gib["fit"] = torch.cuda.max_memory_allocated() / 2 ** 30
    stats.update(train_steps=state.step,
                 step_capture_s=captured.graphs[0].capture_s,
                 step_graph_pool_mib=captured.graphs[0].pool_bytes / 2 ** 20,
                 peak_device_gib=peak_gib)
    return cfg, data, state, stats


def _in_window(name: str, what: str, value: float) -> None:
    lo, hi = CONFIG_WINDOWS[name][what]
    check(lo <= value <= hi,
          f"config {name} {what} {value} outside {(lo, hi)}")


def phase_config(name: str, tmp: str) -> dict:
    """BASELINE's single-table configuration ``name``
    (``data.configs.CONFIGS``: 1, 2 or pq) on the card through the port's
    entry points: the data and fit of :func:`_config_fit` (config 1:
    ``MultivariateBernoulli(TwoLayer256Relu(25), 8)``; config 2: a
    12-bit SIREN 128->256->256 on its 131,072-row subset; pq: a 12-bit
    ``ProductQuantization`` head, 3 bands of 4 bits, on SIREN
    100->256->256), an ``Indexer`` of the full corpus (grouped, the
    table's layout dtype: f32, or bf16 for pq; the largest bucket as
    probe budget) and every query served at the configuration's probes
    (configs 1 and pq sampled from a CUDA generator seeded
    ``CONFIG_PROBE_SEED``, config 2 flip).  Recall@10 and mean candidates
    in ``CONFIG_WINDOWS``; the gather engine on the same draws (a fresh
    generator of the same seed): candidates equal per query, and on an f32
    layout ids >= 0.98, on the bf16 layout (the gather scores the exact
    f32 corpus, so bf16 rows reorder near-ties) each query's r-th best
    exact cosine never more than ``BF16_SCORE_BOUND`` below the gather's;
    K1 against its plain version on the same layout on
    ``CONFIG_PLAIN_QUERIES`` queries: candidates equal, ids >= 0.999; K1's
    times at the serve's shapes.  Peak device memory of each stage: the
    data (its kNN), the subset's self-kNN, the fit, the build and serve,
    the checks; the phase's wall time.  Returns the serve's launches."""
    import torch

    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    t_phase = time.perf_counter()
    cfg, data, state, stats = _config_fit(name, tmp)
    peak_gib = stats.pop("peak_device_gib")
    corpus, queries, gt = data.training, data.testing, data.ground_truth
    dtype = getattr(torch, cfg["serving_dtype"])

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = Indexer(state.params["hashing"], corpus, device=DEVICE,
                  metric=data.metric, engine=cfg["engine"],
                  serving_dtype=dtype)
    lay = idx.layout
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(lay.data.dtype == dtype, f"config {name}: a {lay.data.dtype} layout")
    sampled = cfg["probe_mode"] == "sample"

    def draws():
        """A fresh generator: every engine serves the same probes."""
        return (torch.Generator(device=DEVICE).manual_seed(CONFIG_PROBE_SEED)
                if sampled else None)

    kw = dict(k=wl.K, hash_times=cfg["hash_times"],
              probe_mode=cfg["probe_mode"])
    reset_launches()
    ids, n_cand = idx.query(queries, generator=draws(), **kw)
    timed = _timed_passes(lambda: idx.query(queries, generator=draws(), **kw),
                          CONFIG_PASSES)
    launches = read_launches("grouped_scores_topk")
    peak_gib["build_serve"] = torch.cuda.max_memory_allocated() / 2 ** 30
    check(ids.shape == (queries.shape[0], wl.K), "result shape")
    check(bool(((ids >= -1) & (ids < corpus.shape[0])).all()), "id range")
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
    mean_cand = float(n_cand.mean())
    _in_window(name, "recall", recall)
    _in_window(name, "n_cand", mean_cand)

    torch.cuda.reset_peak_memory_stats()
    n = CONFIG_PLAIN_QUERIES
    k_ids, k_cand = idx.query(queries[:n], generator=draws(), **kw)
    p_ids, p_cand = idx.query(queries[:n], generator=draws(), plain=True,
                              **kw)
    vs_plain = id_agreement(k_ids, p_ids)
    check(bool(np.array_equal(k_cand, p_cand)) and vs_plain >= 0.999,
          f"config {name}: K1 vs its plain version {vs_plain}")
    idx.engine = "gather"
    g_ids, g_cand = idx.query(queries, generator=draws(), **kw)
    idx.engine = cfg["engine"]
    check(bool(np.array_equal(g_cand, n_cand)),
          f"config {name}: gather candidates differ from grouped")
    vs_gather = id_agreement(ids, g_ids)
    gather = {"grouped_vs_gather": vs_gather}
    if dtype == torch.float32:
        check(vs_gather >= 0.98,
              f"config {name}: grouped vs gather {vs_gather} < 0.98")
    else:
        regret = _bf16_regret(corpus, queries, ids, g_ids)
        check(regret <= BF16_SCORE_BOUND,
              f"config {name}: the bf16 serve ranks {regret} below the "
              f"exact f32 gather, over the bf16 bound {BF16_SCORE_BOUND}")
        gather.update(gather_slot_agreement=_slot_agreement(ids, g_ids),
                      max_rank_regret=regret)

    q = torch.as_tensor(queries, device=DEVICE)
    with torch.no_grad():
        pid, pv = idx.hashing.hash(q, n_probes=cfg["hash_times"],
                                   generator=draws(),
                                   probe_mode=cfg["probe_mode"])
    k1 = _grouped_times(lay, q, pid, pv, panel=False)
    peak_gib["checks"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(f"config{name}", card=CARD["nvidia_smi"],
         n_corpus=int(corpus.shape[0]), dim=data.dim, metric=data.metric,
         n_queries=int(queries.shape[0]), head=cfg["head"], bits=cfg["bits"],
         serving_dtype=cfg["serving_dtype"], probe_mode=cfg["probe_mode"],
         hash_times=cfg["hash_times"], k=wl.K, **stats, build_s=build_s,
         max_bucket=idx.table.max_count(), buckets_used=idx.n_buckets_used(),
         cap=lay.cap, block_rows=lay.br, d_pad=lay.d_pad,
         layout_gib=lay.data.numel() * lay.data.element_size() / 2 ** 30,
         recall_at_10=recall, mean_n_candidates=mean_cand,
         window=CONFIG_WINDOWS[name], **timed,
         qps=queries.shape[0] / timed["median_s"], k1_vs_plain=vs_plain,
         **gather, peak_device_gib=peak_gib, launches=launches, k1_times=k1,
         phase_s=time.perf_counter() - t_phase)
    del idx, lay, q
    torch.cuda.empty_cache()
    return launches


def phase_config4(tmp: str) -> dict:
    """BASELINE's configuration 4, the L=8 jointly trained ensemble, on
    the card through the port's entry points: the data and fit of
    :func:`_config_fit` (200,000 x 100 glove-100 shape, eight 10-bit
    ``MultivariateBernoulli`` tables on SIREN 100->128->128 through
    ``MultiTableTrainer``), a ``MultiTableIndexer`` of the full corpus
    (one f32 flat layout of the eight tables, the windowed engine, the
    largest bucket as probe budget) calibrated on the first 10,000 corpus
    rows at one probe a table, and the 10,000 queries served at one probe
    a table (each table's hard code), the guard inside the replay picking
    the calibrated group table or the static one.  Recall@10 and the mean
    exact distinct candidates (``exact_query_size``, what ``config_4``
    reports) in ``CONFIG_WINDOWS``; the summed per-table candidates beside
    them; the branch the batch took (its needed group count against the
    calibration) and the same batch on each branch (a calibration on the
    queries themselves, and a starved one on 4 queries): ids and
    candidates equal to the first serve's; K3 against its plain version
    on ``CONFIG_PLAIN_QUERIES`` queries: candidates equal, ids >= 0.999;
    the gather engine on the same probes: its distinct candidates equal
    ``exact_query_size`` per query, ids >= 0.98; K3's times at the
    serve's shapes.  Peak device memory of each stage and the phase's
    wall time.  Returns the serve's launches."""
    import torch

    from nlsh_tpu_torch.parallel import MultiTableIndexer
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    t_phase = time.perf_counter()
    cfg, data, state, stats = _config_fit("4", tmp)
    peak_gib = stats.pop("peak_device_gib")
    corpus, queries, gt = data.training, data.testing, data.ground_truth
    kw = dict(hash_times=cfg["hash_times"], probe_mode=cfg["probe_mode"])

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    midx = MultiTableIndexer(state.params["hashing"], corpus, device=DEVICE,
                             metric=data.metric, engine=cfg["engine"],
                             serving_dtype=getattr(torch,
                                                   cfg["serving_dtype"]))
    layout = midx._serving_layout()
    g_cal = midx.calibrate(corpus[:cfg["calibrate_rows"]], **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(midx.n_tables == cfg["n_tables"] and midx.engine == "windowed",
          f"config 4: {midx.n_tables} tables on {midx.engine}")
    q = torch.as_tensor(queries, device=DEVICE)
    with torch.no_grad():
        gp, gv = midx._flat_probes(*midx._probes(
            q, cfg["hash_times"], probe_mode=cfg["probe_mode"]))
    override, needed = midx.windowed_group_bound(layout, gp, gv)
    static = _static_groups(layout, gp)
    branch = "calibrated" if override is not None else "static"

    reset_launches()
    ids, n_cand = midx.query(queries, k=wl.K, **kw)
    timed = _timed_passes(lambda: midx.query(queries, k=wl.K, **kw),
                          CONFIG_PASSES)
    launches = read_launches("windowed_scores_topk")
    peak_gib["build_serve"] = torch.cuda.max_memory_allocated() / 2 ** 30
    check(ids.shape == (queries.shape[0], wl.K), "config 4 result shape")
    check(bool(((ids >= -1) & (ids < corpus.shape[0])).all()),
          "config 4 id range")
    for row in ids[:200]:
        real = row[row >= 0]
        check(len(set(real)) == len(real), "duplicate ids after the dedupe")
    recall = float(calculate_recall(gt[:, :wl.K], ids, np.mean))
    size = midx.exact_query_size(queries, **kw)
    mean_size = float(size.mean())
    _in_window("4", "recall", recall)
    _in_window("4", "n_cand", mean_size)
    check(bool((n_cand >= size).all()),
          "config 4: summed candidates below the distinct count")

    torch.cuda.reset_peak_memory_stats()
    n = CONFIG_PLAIN_QUERIES
    p_ids, p_cand = midx.query(queries[:n], k=wl.K, plain=True, **kw)
    vs_plain = id_agreement(ids[:n], p_ids)
    check(bool(np.array_equal(p_cand, n_cand[:n])) and vs_plain >= 0.999,
          f"config 4: K3 vs its plain version {vs_plain}")
    g_used = override if override is not None else static
    k3 = _windowed_times(layout, q, gp, gv, g_used, panel_reps=None)
    branches = {}
    for what, rows in (("calibrated", queries), ("static", queries[:4])):
        g = midx.calibrate(rows, **kw)
        b_override, _ = midx.windowed_group_bound(layout, gp, gv)
        check((b_override is not None) == (what == "calibrated"),
              f"config 4: the {what} branch was not taken ({g} groups "
              f"calibrated, {needed} needed)")
        b_ids, b_cand = midx.query(queries, k=wl.K, **kw)
        check(bool(np.array_equal(b_ids, ids))
              and bool(np.array_equal(b_cand, n_cand)),
              f"config 4: the {what} branch answers otherwise")
        branches[what] = {"groups_calibrated": g, "ids_equal": True,
                          "n_candidates_equal": True}
    midx.engine = "gather"
    x_ids, x_cand = midx.query(queries, k=wl.K, **kw)
    check(bool(np.array_equal(x_cand, size)),
          "config 4: gather candidates differ from exact_query_size")
    vs_gather = id_agreement(ids, x_ids)
    check(vs_gather >= 0.98, f"config 4: windowed vs gather {vs_gather} < 0.98")
    peak_gib["checks"] = torch.cuda.max_memory_allocated() / 2 ** 30
    emit("config4", card=CARD["nvidia_smi"], n_corpus=int(corpus.shape[0]),
         dim=data.dim, metric=data.metric, n_queries=int(queries.shape[0]),
         head=cfg["head"], bits=cfg["bits"], n_tables=cfg["n_tables"],
         serving_dtype=cfg["serving_dtype"], probe_mode=cfg["probe_mode"],
         hash_times=cfg["hash_times"], k=wl.K, **stats, build_s=build_s,
         max_bucket=[int(c) for c in midx.counts.max(dim=1).values],
         buckets_used=[int(c) for c in (midx.counts > 0).sum(dim=1)],
         probe_budget=midx.probe_budget, cap=layout.cap, align=layout.align,
         block_rows=layout.br, layout_rows=layout.n_rows,
         layout_gib=layout.data.numel() * layout.data.element_size() / 2 ** 30,
         calibrate_rows=cfg["calibrate_rows"], groups_calibrated=g_cal,
         groups_needed=needed, groups_static=static, branch=branch,
         branches=branches, recall_at_10=recall,
         mean_exact_query_size=mean_size,
         mean_summed_candidates=float(n_cand.mean()),
         window=CONFIG_WINDOWS["4"], **timed,
         qps=queries.shape[0] / timed["median_s"], k3_vs_plain=vs_plain,
         windowed_vs_gather=vs_gather, peak_device_gib=peak_gib,
         launches=launches, k3_times=k3,
         phase_s=time.perf_counter() - t_phase)
    del midx, layout, q
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile 3 fixed-cap and 3 ensemble serve "
                             "passes, and the training step (3 passes of "
                             "one step), eager and replayed")
    args = parser.parse_args()
    missing = [p for p in ARTIFACTS if not os.path.exists(p)]
    check(not missing, f"committed artifacts missing: {missing}")

    info = phase_device()
    phase_build()
    phase_kernels()
    phase_fixed_kernels()
    launches, times = {}, {}
    k7_launches, times["int8_block_scores"] = phase_int8_probe()
    launches.update(k7_launches)

    # the subset is drawn from the same generator straight after the
    # workload, as the committed GT's sub_knn was
    corpus, queries, sub_idx = wl.glove100_bench()
    with np.load(GT) as z:
        gt, sub_knn = z["gt"], z["sub_knn"]
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
    phase_bf16(idx, queries, gt, n_cand)
    # the one-dispatch serves: their kernels from replayed graphs
    new_callers = {"fused": phase_fused(idx, queries, gt, n_cand)}

    midx, mt_build_s = phase_ensemble_index(corpus)
    mt_ids, mt_cand, mt_launches = phase_ensemble_serve(midx, queries, gt)
    launches.update(mt_launches)
    if args.profile:
        phase_ensemble_profile(midx, queries)
    times.update(phase_ensemble_kernel_times(midx, queries))
    phase_ensemble_parity(midx, queries, mt_ids, mt_cand)
    phase_ensemble_guard(midx, queries, mt_ids, mt_cand)
    new_callers["ensemble_fused"] = phase_ensemble_fused(
        midx, queries, gt, mt_ids, mt_cand)

    # the serving process: every path below runs kernels launched above
    # from new callers, with the counts set to 0 just before each
    with tempfile.TemporaryDirectory() as tmp:
        # the synthetic sets' kNN cache (config 2's is 0.5 GB) lives and
        # dies with the run
        os.environ["NLSH_SYNTH_CACHE_DIR"] = tmp
        phase_artifact(corpus, tmp)
        restored, new_callers["persist"] = phase_persist(
            idx, midx, corpus, queries, gt, (ids, n_cand, build_s),
            (mt_ids, mt_cand, mt_build_s), tmp)
        phase_host_layout(idx, queries, ids, n_cand)
        del idx
        new_callers["ensemble_fixed"], new_callers["ensemble_int8"] = \
            phase_ensemble_engines(midx, queries, gt, mt_ids, mt_cand)
        del midx
        new_callers["ensemble_sharded"] = phase_ensemble_sharded(
            corpus, queries, gt, mt_ids, mt_cand)
        serve_s = float(np.median(_timed_passes(lambda: restored.query(
            queries, k=wl.K, hash_times=wl.HASH_TIMES, probe_mode="flip"),
            3)["pass_s"]))
        new_callers["updates"] = phase_updates(corpus, queries, gt, serve_s)
        new_callers["heads"] = phase_heads(corpus, queries)
        new_callers["serve_cli"] = phase_serve_cli(restored, queries, tmp)
        del restored

        # offline evaluation: the sweep on every engine, and the HNSW
        # baseline
        flip_rows, new_callers["eval_flip"] = phase_eval_flip(corpus, queries,
                                                              gt)
        new_callers["eval_sample"] = phase_eval_sample(corpus, queries, gt,
                                                       flip_rows)
        new_callers["eval_ensemble"] = phase_eval_ensemble(corpus, queries, gt)
        new_callers["eval_cli"] = phase_eval_cli(tmp)
        phase_hnsw(corpus, queries, tmp)

        # training at the bench's configuration, on its subset
        data = wl.BenchData(corpus[sub_idx], queries[:256], gt[:256],
                            sub_knn, "cosine")
        phase_train_knn(data.training, sub_knn)
        phase_train_step(data, args.profile)
        phase_train_fused(data)
        new_callers["train"] = phase_train(data, corpus, queries, gt, tmp)
        new_callers["train_ensemble"] = phase_train_ensemble(
            data, corpus, queries, gt, tmp)
        new_callers["train_cli"] = phase_train_cli(tmp)

        # multi-device on the one card: data parallelism, the corpus-sharded
        # index, and config 5 at full width
        phase_train_dp(data)
        new_callers["sharded"] = phase_sharded(corpus, queries, gt, tmp)
        del corpus
        new_callers["config5"] = phase_config5(tmp)
        # BASELINE's configurations 1, 2 and 4 and the product-quantisation
        # one, trained and served
        for name in ("1", "2"):
            new_callers[f"config{name}"] = phase_config(name, tmp)
        new_callers["config4"] = phase_config4(tmp)
        new_callers["configpq"] = phase_config("pq", tmp)

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
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "nlsh_tpu", "bench", "benchmarks"))
    check(not foreign, f"imported outside the port: {foreign}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
