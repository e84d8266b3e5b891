"""The port's main path at full size on the CPU (``slow``; run by hand).

The bench workload (1,183,514 x 100, 10,000 queries, seed 0) through
``nlsh_tpu_torch.Indexer`` with the committed trained params: 16 flip
probes, cap 512, k = 10, f32.  Exact f32 throughout, so it must give the
JAX package's exact-f32 CPU values: recall@10 0.74264 and mean
n_candidates 4670.30.  Imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m slow tests/test_torch_full.py
"""

import os

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(_ROOT, "benchmarks", "artifacts", "bench_cache")


@pytest.mark.slow
def test_full_bench_workload_on_cpu():
    import sys

    import torch

    sys.path.insert(0, _ROOT)
    import bench
    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.models import get_encoder, get_hashing
    from nlsh_tpu_torch.utils.checkpoint import params_from_jax, read_msgpack
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    corpus, queries = bench.glove100_workload(np.random.default_rng(bench.SEED))
    with np.load(os.path.join(
            _CACHE, "gt_s0_n1183514_d100_q10000_k10_ts131072_v2.npz")) as z:
        gt = z["gt"]
    hashing = get_hashing("MultivariateBernoulli",
                          get_encoder("siren", 100, [256, 256]), 12)
    params_from_jax(hashing, read_msgpack(os.path.join(
        _CACHE, "params_s0_n1183514_d100_q10000_k10_ts131072_v2_4da04f430c.msgpack")))
    idx = Indexer(hashing, torch.from_numpy(corpus), device="cpu",
                  metric="cosine", probe_budget=512)
    assert idx.table.max_count() == 543
    assert idx.n_buckets_used() == 4096
    ids, n_cand = idx.query(queries, k=10, hash_times=16, probe_mode="flip")
    recall = calculate_recall(gt, ids, np.mean)
    assert abs(recall - 0.74264) <= 0.0005, recall
    assert abs(n_cand.mean() - 4670.30) <= 0.5, n_cand.mean()
