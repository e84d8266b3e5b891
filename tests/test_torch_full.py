"""The port's serving paths at full size on the CPU (``slow``; run by hand).

The bench workload (1,183,514 x 100, 10,000 queries, seed 0), f32, k = 10:

* through ``nlsh_tpu_torch.Indexer`` with the committed trained params,
  16 flip probes, cap 512: the JAX package's exact-f32 CPU values,
  recall@10 0.74264 and mean n_candidates 4670.30, on the grouped and on
  the fixed-cap engine (both serve the first 512 rows of each probed
  bucket);
* the same index on the per-row int8 layout, grouped engine: recall@10
  0.72406 (the int8 target of ``chip_smoke.py``; see the test for how it
  was derived) and the f32 candidates;
* the same index on the bf16 layout, grouped engine: recall@10 0.73468
  (the bf16 target of ``chip_smoke.py``; see the test for how it was
  derived) and the f32 candidates;
* through ``nlsh_tpu_torch.parallel.MultiTableIndexer`` with the
  committed 8-table ensemble, 4 flip probes per table, the windowed
  engine after ``calibrate``: recall@10 0.99211, mean n_candidates
  (summed per-table occupancy) 9539.69 and mean exact query_size
  8881.76, the JAX package's exact-f32 CPU values;
* the same ensemble on the per-row int8 stacked layout: recall@10
  0.93833 (the int8 window of ``chip_smoke.py``'s ``ensemble_int8``
  phase) and the f32 candidates.

Exact f32 throughout.  Imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m slow tests/test_torch_full.py
"""

import numpy as np
import pytest


def _workload():
    from nlsh_tpu_torch.data import workloads as wl
    from nlsh_tpu_torch.tools.common import GT

    corpus, queries = wl.glove100_workload(np.random.default_rng(wl.SEED))
    with np.load(GT) as z:
        return corpus, queries, z["gt"]


@pytest.mark.slow
def test_full_bench_workload_on_cpu():
    import torch

    from nlsh_tpu_torch.data.workloads import CAP
    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.tools.common import load_hashing
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    corpus, queries, gt = _workload()
    idx = Indexer(load_hashing(), torch.from_numpy(corpus), device="cpu",
                  metric="cosine", probe_budget=CAP)
    assert idx.table.max_count() == 543
    assert idx.n_buckets_used() == 4096
    ids, n_cand = idx.query(queries, k=10, hash_times=16, probe_mode="flip")
    recall = calculate_recall(gt, ids, np.mean)
    assert abs(recall - 0.74264) <= 0.0005, recall
    assert abs(n_cand.mean() - 4670.30) <= 0.5, n_cand.mean()


def _full_indexer(**kw):
    import torch

    from nlsh_tpu_torch.data.workloads import CAP
    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.tools.common import load_hashing

    corpus, queries, gt = _workload()
    idx = Indexer(load_hashing(), torch.from_numpy(corpus), device="cpu",
                  metric="cosine", probe_budget=CAP, **kw)
    return idx, queries, gt


@pytest.mark.slow
def test_full_fixed_cap_engine_on_cpu():
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    idx, queries, gt = _full_indexer(engine="fixed")
    assert idx.layout.n_rows == 2_099_712
    ids, n_cand = idx.query(queries, k=10, hash_times=16, probe_mode="flip")
    recall = calculate_recall(gt, ids, np.mean)
    assert abs(recall - 0.74264) <= 0.0005, recall
    assert abs(n_cand.mean() - 4670.30) <= 0.5, n_cand.mean()


# The per-row int8 grouped serve of the bench's table.  The port's int8
# layout is checked against the JAX package's (bytes, row_map, scales)
# by tests/test_torch_int8.py and tests/test_torch_index.py; this value
# is the port's serve on the CPU (plain kernels, exact f32 arithmetic on
# the stored int8 rows) and is the int8 window of chip_smoke.py.
INT8_RECALL = 0.72406


@pytest.mark.slow
def test_full_int8_per_row_grouped_on_cpu():
    import torch

    from nlsh_tpu_torch.utils.metrics import calculate_recall

    idx, queries, gt = _full_indexer(serving_dtype=torch.int8)
    assert idx.layout.scale.shape == (2_099_712,)
    ids, n_cand = idx.query(queries, k=10, hash_times=16, probe_mode="flip")
    recall = calculate_recall(gt, ids, np.mean)
    assert abs(recall - INT8_RECALL) <= 0.0005, recall
    assert abs(n_cand.mean() - 4670.30) <= 0.5, n_cand.mean()


# The bf16 grouped serve of the bench's table.  The port's bf16 layout is
# held bit for bit to the JAX package's by
# tests/test_torch_index.py::test_layout_matches_jax_bitwise (its
# dtype="bfloat16" cases), and the JAX package's bf16 grouped serve of
# this head gives the port's candidates and ids, every one, on the
# bench's draws cut to 65,536 rows (tests/test_torch_bench_bf16.py).
# This value is the port's serve on the CPU at full size (plain kernels,
# exact f32 arithmetic on the stored bf16 rows and the f32 queries:
# 0.7346799969673157 as an f32 mean, candidates 4670.3042 as the f32
# serve's); the JAX package's interpreted Pallas serve of the full
# 2.1M-row layout is not run.  It is the bf16 window of chip_smoke.py.
BF16_RECALL = 0.73468


@pytest.mark.slow
def test_full_bf16_grouped_on_cpu():
    import torch

    from nlsh_tpu_torch.utils.metrics import calculate_recall

    idx, queries, gt = _full_indexer(serving_dtype=torch.bfloat16)
    assert idx.layout.data.dtype == torch.bfloat16
    ids, n_cand = idx.query(queries, k=10, hash_times=16, probe_mode="flip")
    recall = calculate_recall(gt, ids, np.mean)
    assert abs(recall - BF16_RECALL) <= 0.0005, recall
    # the layout's type does not change which rows a bucket holds
    assert abs(n_cand.mean() - 4670.30) <= 0.5, n_cand.mean()


@pytest.mark.slow
def test_full_ensemble_on_cpu():
    import torch

    from nlsh_tpu_torch.parallel import MultiTableIndexer
    from nlsh_tpu_torch.tools.common import load_ensemble
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    corpus, queries, gt = _workload()
    idx = MultiTableIndexer(load_ensemble(), torch.from_numpy(corpus),
                            device="cpu", metric="cosine")
    assert idx.engine == "windowed"
    assert idx.probe_budget == 586
    assert int((idx.counts > 0).sum()) == 8 * 4096
    kw = dict(hash_times=4, probe_mode="flip")
    idx.calibrate(queries, **kw)
    ids, n_cand = idx.query(queries, k=10, **kw)
    recall = calculate_recall(gt, ids, np.mean)
    assert abs(recall - 0.99211) <= 0.0005, recall
    assert abs(n_cand.mean() - 9539.69) <= 0.5, n_cand.mean()
    size = idx.exact_query_size(queries, **kw)
    assert abs(size.mean() - 8881.76) <= 0.5, size.mean()


# The ensemble on the per-row int8 stacked layout, windowed engine: the
# port's plain serve on the CPU, as INT8_RECALL above; the int8 window of
# chip_smoke.py's `ensemble_int8` phase.
MT_INT8_RECALL = 0.93833


@pytest.mark.slow
def test_full_ensemble_int8_per_row_on_cpu():
    import torch

    from nlsh_tpu_torch.parallel import MultiTableIndexer
    from nlsh_tpu_torch.tools.common import load_ensemble
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    corpus, queries, gt = _workload()
    idx = MultiTableIndexer(load_ensemble(), torch.from_numpy(corpus),
                            device="cpu", metric="cosine",
                            serving_dtype=torch.int8)
    kw = dict(hash_times=4, probe_mode="flip")
    idx.calibrate(queries, **kw)
    layout = idx._serving_layout()
    assert layout.data.dtype == torch.int8
    assert layout.scale.shape == (layout.n_rows,)
    ids, n_cand = idx.query(queries, k=10, **kw)
    recall = calculate_recall(gt, ids, np.mean)
    assert abs(recall - MT_INT8_RECALL) <= 0.0005, recall
    assert abs(n_cand.mean() - 9539.69) <= 0.5, n_cand.mean()
