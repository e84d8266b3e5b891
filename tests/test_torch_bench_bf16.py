"""The bench's bf16 operating point, the JAX package against the port.

The bench's committed 12-bit SIREN head, the bench's draws cut to 65,536
rows and 128 queries, cosine, the bf16 layout, the grouped engine, 16
flip probes: the JAX package's ``Indexer`` (Pallas in interpret mode)
and the port's (plain kernels) serve the same candidates and the same
ids, every one.  Probe budget and block rows are 64, so the layout holds
262,208 rows and not the full-size cap's 2.1M.  Both give recall@10
0.653125, and the f32 layout gives other ids, so the check sees the
rounding of the stored rows.  ``BF16_RECALL`` in
``tests/test_torch_full.py`` is the port's serve of the same head at
full size."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from nlsh_tpu.index.indexer import Indexer as JIndexer
from nlsh_tpu.models import get_encoder as j_encoder
from nlsh_tpu.models import get_hashing as j_hashing
from nlsh_tpu_torch.data import workloads as wl
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.tools.common import PARAMS, load_hashing
from nlsh_tpu_torch.utils.metrics import calculate_recall

N_CORPUS, N_QUERIES, BUDGET = 65_536, 128, 64


def _exact_top10(corpus, queries):
    c = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    q = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    return np.argsort(-(q @ c.T), axis=1, kind="stable")[:, :wl.K]


def test_bench_bf16_serve_matches_jax():
    corpus, queries = wl.glove100_workload(
        np.random.default_rng(wl.SEED), n_corpus=N_CORPUS,
        n_queries=N_QUERIES)
    gt = _exact_top10(corpus, queries)
    jh = j_hashing("MultivariateBernoulli",
                   j_encoder(wl.TRAIN_CFG["encoder"], wl.DIM,
                             list(wl.TRAIN_CFG["hidden"])), wl.HASH_SIZE)
    with open(PARAMS, "rb") as f:
        params = serialization.from_bytes(jh.init(jax.random.PRNGKey(0)),
                                          f.read())
    kw = dict(k=wl.K, hash_times=wl.HASH_TIMES, probe_mode="flip")
    knobs = dict(metric="cosine", probe_budget=BUDGET, block_rows=BUDGET)
    ji = JIndexer(jh, params, jnp.asarray(corpus), engine="pallas-grouped",
                  serving_dtype=jnp.bfloat16, **knobs)
    j_ids, j_cand = (np.asarray(x) for x in ji.query(jnp.asarray(queries),
                                                     **kw))
    ti = Indexer(load_hashing(), corpus, device="cpu",
                 serving_dtype=torch.bfloat16, **knobs)
    assert ti.layout.data.dtype == torch.bfloat16
    assert ti.layout.n_rows == 262_208
    t_ids, t_cand = ti.query(queries, **kw)
    np.testing.assert_array_equal(t_cand, j_cand)
    np.testing.assert_array_equal(t_ids, j_ids)
    recall = float(calculate_recall(gt, j_ids, np.mean))
    assert abs(recall - 0.653125) <= 1e-6, recall
    # the same table on the f32 layout: the same candidates, other ids
    ti.serving_dtype = torch.float32
    f_ids, f_cand = ti.query(queries, **kw)
    np.testing.assert_array_equal(f_cand, t_cand)
    assert not np.array_equal(f_ids, t_ids)
