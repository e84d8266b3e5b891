"""Shared helpers of the sharded-index parity tests
(``tests/test_torch_sharded*.py``): the seeded corpus, the head in both
packages, both packages' indexers (the JAX package's built once per
configuration and module), and the answer comparison.  Not a test
module."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nlsh_tpu.models.encoders import MLPEncoder
from nlsh_tpu.models.hashings import MultivariateBernoulli
from nlsh_tpu.parallel import ShardedIndexer as JSharded
from nlsh_tpu.parallel import make_mesh as j_make_mesh
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.parallel import ShardedIndexer, make_mesh
from nlsh_tpu_torch.utils.checkpoint import params_from_jax

N, NQ, DIM, BITS, K, PROBES = 1021, 128, 8, 5, 5, 4
J_ENGINE = {"grouped": "pallas-grouped", "windowed": "pallas-windowed",
            "fixed": "pallas", "gather": "xla"}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}


def _data(seed=0):
    """Clustered rows (the JAX fixtures' 32 clusters in 8 dims)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, DIM))
    pts = centers[rng.integers(0, 32, N + NQ)] + 0.3 * rng.normal(
        size=(N + NQ, DIM))
    return pts[:N].astype(np.float32), pts[N:].astype(np.float32)


CORPUS, QUERIES = _data()


def make_heads():
    """The JAX head, its params, and the port's head loaded with them."""
    jh = MultivariateBernoulli(MLPEncoder(DIM, (16,)), BITS)
    params = jh.init(jax.random.PRNGKey(0))
    th = get_hashing("MultivariateBernoulli", get_encoder("mlp", DIM, [16]),
                     BITS)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    return jh, params, th


_JAX_CACHE = {}


def jax_index(heads, n_dev, engine, metric="cosine", dtype="f32", **kw):
    """The JAX package's sharded index of a configuration and its answer
    (:func:`jquery`), built once per process."""
    key = (n_dev, engine, metric, dtype, tuple(sorted(kw.items())))
    if key not in _JAX_CACHE:
        jh, params, _ = heads
        idx = JSharded(jh, params, CORPUS, j_make_mesh(n_dev, axis="shard"),
                       metric=metric, engine=J_ENGINE[engine],
                       serving_dtype=DTYPES[dtype][1], **kw)
        _JAX_CACHE[key] = (idx, jquery(idx))
    return _JAX_CACHE[key]


def port_index(heads, n_dev, engine, metric="cosine", dtype="f32", **kw):
    return ShardedIndexer(heads[2], CORPUS,
                          make_mesh(n_dev, "shard", platform="cpu"),
                          metric=metric, engine=engine,
                          serving_dtype=DTYPES[dtype][0], **kw)


def jquery(idx):
    ids, cand = idx.query(jnp.asarray(QUERIES), k=K, hash_times=PROBES,
                          probe_mode="flip")
    return np.asarray(ids), np.asarray(cand)


def tquery(idx):
    return idx.query(QUERIES, k=K, hash_times=PROBES, probe_mode="flip")


def _dist(ids, metric):
    c, q = CORPUS.astype(np.float64), QUERIES.astype(np.float64)
    rows = c[np.clip(ids, 0, N - 1)]
    if metric == "cosine":
        rows = rows / np.linalg.norm(rows, axis=-1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = 1 - np.einsum("qkd,qd->qk", rows, qn)
    else:
        d = np.sum((rows - q[:, None]) ** 2, axis=-1)
    return np.where(ids >= 0, d, np.inf)


def assert_same_answers(got, want, metric="cosine", min_agree=0.99,
                        ties=True):
    """Candidates equal; ids equal on ``min_agree`` of the slots and, with
    ``ties``, a differing slot holds two rows at one distance (1e-5)."""
    (t_ids, t_cand), (j_ids, j_cand) = got, want
    j_ids, j_cand = np.asarray(j_ids), np.asarray(j_cand)
    np.testing.assert_array_equal(t_cand, j_cand)
    assert t_ids.shape == j_ids.shape and (t_ids < N).all()
    assert (t_ids == j_ids).mean() >= min_agree
    if ties:
        diff = t_ids != j_ids
        np.testing.assert_allclose(_dist(t_ids, metric)[diff],
                                   _dist(j_ids, metric)[diff], atol=1e-5)
