"""Shared by ``tests/test_torch_fused.py`` and
``tests/test_torch_fused_int8.py`` (not a test module): the small
single-table case in both packages and the bitwise check of
``_fused_serve`` against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nlsh_tpu.index.indexer import Indexer as JIndexer
from nlsh_tpu.index.indexer import _fused_serve as j_fused
from nlsh_tpu.models.encoders import MLPEncoder as JMLP
from nlsh_tpu.models.hashings import MultivariateBernoulli as JMVB
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.index.indexer import _fused_serve
from nlsh_tpu_torch.models import MLPEncoder, MultivariateBernoulli
from nlsh_tpu_torch.utils.checkpoint import params_from_jax

DIM, BITS, BR, K, P = 16, 5, 128, 5, 4
J_ENGINES = {"grouped": "pallas-grouped", "windowed": "pallas-windowed",
             "fixed": "pallas"}


def _single(seed: int, n: int = 768, nq: int = 32):
    """A clustered corpus of small dyadic values (exact f32 norms, so the
    int8 layouts compare bitwise), queries from the same clusters, and
    one 5-bit head in both packages with the same params."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, DIM))
    pts = centers[rng.integers(0, 16, n + nq)] + 0.4 * rng.normal(
        size=(n + nq, DIM))
    pts = (np.round(pts * 8) / 8).astype(np.float32)
    jh = JMVB(JMLP(DIM, (32,)), BITS)
    params = jh.init(jax.random.PRNGKey(seed))
    th = MultivariateBernoulli(MLPEncoder(DIM, (32,)), BITS)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    return pts[:n], pts[n:], jh, params, th


def _pair(engine: str, int8: bool, seed: int = 3):
    corpus, queries, jh, params, th = _single(seed)
    metric = "euclidean" if int8 else "cosine"
    ji = JIndexer(jh, params, jnp.asarray(corpus), metric=metric,
                  engine=J_ENGINES[engine], block_rows=BR,
                  serving_dtype=jnp.int8 if int8 else None)
    ti = Indexer(th, corpus, device="cpu", metric=metric, engine=engine,
                 block_rows=BR,
                 serving_dtype=torch.int8 if int8 else torch.float32)
    return queries, (jh, params, ji), ti


def check_fused_serve_matches_jax(engine: str, int8: bool):
    """ONE packed ``(nq, k+1)`` int32 ``[topk_ids | n_candidates]``,
    bitwise the JAX package's, and ``Indexer.query`` serves it (the int8
    cases are ``tests/test_torch_fused_int8.py``)."""
    queries, (jh, params, ji), ti = _pair(engine, int8)
    if int8:
        np.testing.assert_array_equal(ti.layout.data.numpy(),
                                      np.asarray(ji.layout.data))
    want = np.asarray(j_fused(
        jh, params, ji.layout, ji.table.counts, jnp.asarray(queries),
        jax.random.PRNGKey(0), k=K, hash_times=P, probe_mode="flip",
        grouped=engine))
    got = _fused_serve(ti.hashing, ti.layout, ti.table.counts,
                       torch.from_numpy(queries), k=K, hash_times=P,
                       probe_mode="flip", grouped=engine)
    assert got.dtype == torch.int32 and got.shape == (queries.shape[0], K + 1)
    assert (got[:, :-1] >= 0).float().mean() > 0.9
    np.testing.assert_array_equal(got.numpy(), want)
    ids, cand = ti.query(queries, k=K, hash_times=P, probe_mode="flip")
    np.testing.assert_array_equal(ids, want[:, :-1])
    np.testing.assert_array_equal(cand, want[:, -1])
