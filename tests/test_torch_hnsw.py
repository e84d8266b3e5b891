"""The port's HNSW baseline: ``nlsh_tpu_torch.native.NativeHNSW`` against
the JAX package's ``nlsh_tpu.native.NativeHNSW`` (the same ``hnsw.cpp``
and flags, each built into its own library), and
``nlsh_tpu_torch.train.HNSWBaseline`` against ``nlsh_tpu.train.hnsw``.

On the same data, ``M``, ``ef_construction``, ``ef`` and insertion order
the graphs answer identically: ids, distances and visit counts bit for
bit, cosine and l2.  The label mapping across batches and the misuse
guards follow ``tests/test_hnsw.py``.  The baseline's recall and
``query_size`` equal the JAX package's when both shuffle with
``RandomState(s)`` (the JAX package through ``np.random``'s global
state)."""

import numpy as np
import pytest
import torch

from nlsh_tpu import native as jnative
from nlsh_tpu.train.hnsw import HNSWBaseline as JHNSWBaseline
from nlsh_tpu_torch import native
from nlsh_tpu_torch.train import HNSWBaseline


def _clustered(rng, n, d, n_clusters=32):
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    return (centers[rng.integers(0, n_clusters, n)]
            + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("space, M, ef_construction, ef",
                         [("cosine", 10, 100, 40), ("l2", 6, 64, 16),
                          ("cosine", 4, 32, 100)])
def test_graphs_answer_as_the_jax_package_s(space, M, ef_construction, ef):
    rng = np.random.default_rng(7)
    n, d = 2048, 24
    corpus = _clustered(rng, n, d)
    queries = _clustered(rng, 200, d)
    order = rng.permutation(n)
    out = []
    for mod in (native, jnative):
        idx = mod.NativeHNSW(space=space, dim=d)
        idx.init_index(max_elements=n, M=M, ef_construction=ef_construction)
        for s in range(0, n, 500):   # shuffled batches, labels = row ids
            sel = order[s:s + 500]
            idx.add_items(corpus[sel], sel)
        idx.set_ef(ef)
        out.append(idx.knn_query(queries, k=10))
    for got, want in zip(*out):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    ids, dists, counts = out[0]
    assert (ids >= 0).all() and (counts > 0).all()
    assert (np.diff(dists, axis=1) >= 0).all()


def test_label_mapping_across_batches():
    rng = np.random.default_rng(2)
    n, d = 1000, 8
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.permutation(n).astype(np.int64) + 10_000
    idx = native.NativeHNSW(space="l2", dim=d)
    idx.init_index(max_elements=n, M=8, ef_construction=100)
    for s in range(0, n, 256):
        idx.add_items(corpus[s:s + 256], labels[s:s + 256])
    assert idx.get_current_count() == n
    idx.set_ef(64)
    ids, dists, _ = idx.knn_query(corpus[:100], k=1)
    assert (ids[:, 0] == labels[:100]).all()
    assert (dists[:, 0] < 1e-5).all()
    with pytest.raises(RuntimeError, match="full"):
        idx.add_items(corpus[:1])   # max_elements exceeded


def test_guards_and_re_init():
    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(50, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="space"):
        native.NativeHNSW(space="ip", dim=8)
    idx = native.NativeHNSW(space="l2", dim=8)
    with pytest.raises(RuntimeError, match="init_index"):
        idx.knn_query(corpus[:1])
    with pytest.raises(RuntimeError, match="init_index"):
        idx.add_items(corpus[:1])
    with pytest.raises(ValueError, match="max_elements"):
        idx.init_index(max_elements=0)
    idx.init_index(max_elements=50, M=4, ef_construction=32)
    assert idx.ef == 10     # init_index resets ef, as hnswlib does
    with pytest.raises(ValueError):
        idx.add_items(corpus[:, :4])                    # wrong dim
    with pytest.raises(ValueError):
        idx.add_items(corpus[:5], labels=np.arange(3))  # wrong count
    idx.add_items(corpus, labels=np.arange(100, 150))
    ids, _, _ = idx.knn_query(corpus[:3], k=1)
    assert (ids[:, 0] == np.arange(100, 103)).all()
    idx.set_ef(30)
    # a re-init drops the old graph, its labels and ef
    idx.init_index(max_elements=50, M=4, ef_construction=32)
    assert idx.get_current_count() == 0 and idx.ef == 10
    idx.add_items(corpus[:10], labels=np.arange(200, 210))
    ids, _, _ = idx.knn_query(corpus[:3], k=1)
    assert (ids[:, 0] == np.arange(200, 203)).all()
    with pytest.raises(ValueError):
        idx.knn_query(corpus[:2, :5])                   # wrong query dim


class _Data:
    """A prepared dataset of fixed arrays."""
    prepared = True

    def __init__(self, training, testing, ground_truth, metric):
        self.training, self.testing = training, testing
        self.ground_truth, self.metric = ground_truth, metric


class _Recorder:
    def __init__(self):
        self.logged, self.params = {}, {}

    def meta(self, params=None, **_):
        self.params.update(params or {})

    def log(self, name, value, step):
        self.logged[name] = (value, step)


@pytest.mark.parametrize("metric, seed", [("cosine", 0), ("euclidean", 3)])
def test_baseline_fit_matches_the_jax_package(metric, seed):
    rng = np.random.default_rng(11)
    corpus, queries = _clustered(rng, 3000, 16), _clustered(rng, 150, 16)
    if metric == "cosine":
        c = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        gt = np.argsort(-(qn @ c.T), axis=1, kind="stable")[:, :10]
    else:
        d2 = ((queries[:, None, :] - corpus[None]) ** 2).sum(-1)
        gt = np.argsort(d2, axis=1, kind="stable")[:, :10]
    kw = dict(max_connections=6, ef_construction=40, ef=12)
    ours, theirs = _Recorder(), _Recorder()
    data = _Data(torch.from_numpy(corpus), torch.from_numpy(queries), gt,
                 metric)
    model = HNSWBaseline(data, ours, rng=np.random.RandomState(seed), **kw)
    assert model.backend == "native" and ours.params["hnsw_backend"] == \
        "native"
    got = model.fit(K=10, batch_size=1000)
    np.random.seed(seed)
    want = JHNSWBaseline(_Data(corpus, queries, gt, metric), theirs,
                         **kw).fit(K=10, batch_size=1000)
    assert got == want and 0.3 < got < 1.0
    assert set(ours.logged) == set(theirs.logged) == {
        "test/recall", "test/query_size", "test/qps"}
    for name in ("test/recall", "test/query_size"):
        assert ours.logged[name] == theirs.logged[name]
    # the default order is RandomState(seed)
    again = HNSWBaseline(data, _Recorder(), seed=seed, **kw).fit(
        K=10, batch_size=1000)
    assert again == got
