"""Port parity of the tiled brute-force kNN and of the datasets built on it.

``knn`` / ``self_knn`` of the port against ``nlsh_tpu.ops.knn`` on the
same numpy inputs: ids equal wherever the k-th and (k+1)-th distances are
not within f32 rounding of each other (the test names those slots and
skips only them), distances atol 1e-5; on integer-valued data, where
every distance is exact and ties are real, ids equal bitwise (lowest id
first).  ``SyntheticDataset`` gives the JAX package's arrays, with the
cache file disabled so that each package computes its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.data import SyntheticDataset as JSynthetic
from nlsh_tpu.data import get_data_by_id as j_get_data
from nlsh_tpu.ops import knn as jknn
from nlsh_tpu_torch.data import SyntheticDataset, get_data_by_id
from nlsh_tpu_torch.index.query import smallest_k
from nlsh_tpu_torch.ops.knn import knn, self_knn

METRICS = ["cosine", "euclidean", "sq_euclidean"]


def _data(seed=0, n=700, nq=90, d=12):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nq, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _ids_equal_off_near_ties(got_i, want_i, want_d, tol=1e-5):
    """ids equal except where a neighbouring distance is within ``tol``."""
    diff = got_i != want_i
    if not diff.any():
        return
    gap = np.abs(np.diff(want_d, axis=1))
    near = np.zeros_like(diff)
    near[:, :-1] |= gap < tol
    near[:, 1:] |= gap < tol
    near[:, -1] = True      # the k-th may trade places with the (k+1)-th
    assert not (diff & ~near).any()
    assert diff.mean() < 0.01


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("tile,chunk", [(512, 65536), (32, 100), (7, 64)])
def test_knn_matches_jax(metric, tile, chunk):
    queries, corpus = _data()
    k = 10
    want_d, want_i = jknn.knn(jnp.asarray(queries), jnp.asarray(corpus), k,
                              metric=metric, query_tile=tile,
                              corpus_chunk=chunk)
    got_d, got_i = knn(queries, corpus, k, metric=metric, device="cpu",
                       query_tile=tile, corpus_chunk=chunk)
    assert got_i.dtype == torch.int32 and got_i.shape == (90, k)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5,
                               rtol=0)
    _ids_equal_off_near_ties(got_i.numpy(), np.asarray(want_i),
                             np.asarray(want_d))
    assert (np.diff(got_d.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("metric", ["euclidean", "sq_euclidean"])
def test_knn_ties_keep_the_lowest_id(metric):
    """Integer coordinates: distances are exact, many rows tie (and some
    are duplicates), and both packages answer the lowest ids first across
    chunk boundaries."""
    rng = np.random.default_rng(3)
    corpus = rng.integers(-2, 3, (400, 4)).astype(np.float32)
    queries = rng.integers(-2, 3, (50, 4)).astype(np.float32)
    for chunk in (65536, 37):
        want_d, want_i = jknn.knn(jnp.asarray(queries), jnp.asarray(corpus),
                                  12, metric=metric, corpus_chunk=chunk)
        got_d, got_i = knn(queries, corpus, 12, metric=metric, device="cpu",
                           corpus_chunk=chunk)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    # within a run of equal distances the ids ascend
    d, i = got_d.numpy(), got_i.numpy()
    same = d[:, 1:] == d[:, :-1]
    assert same.any() and (i[:, 1:][same] > i[:, :-1][same]).all()


@pytest.mark.parametrize("metric", METRICS)
def test_self_knn_matches_jax_and_excludes_self(metric):
    _, corpus = _data(seed=5, n=500)
    corpus[10] = corpus[3]                    # a duplicate row is a neighbour
    want = np.asarray(jknn.self_knn(jnp.asarray(corpus), 8, metric=metric,
                                    query_tile=64, corpus_chunk=128))
    got = self_knn(corpus, 8, metric=metric, device="cpu", query_tile=64,
                   corpus_chunk=128).numpy()
    assert got.dtype == np.int32 and got.shape == (500, 8)
    assert (got != np.arange(500)[:, None]).all()
    assert got[3, 0] == 10 and got[10, 0] == 3
    d_want, _ = jknn.knn(jnp.asarray(corpus), jnp.asarray(corpus), 8,
                         metric=metric, exclude_self=True,
                         query_ids=jnp.arange(500, dtype=jnp.int32))
    _ids_equal_off_near_ties(got, want, np.asarray(d_want))


def test_running_top_k_owns_only_its_rows():
    """``knn`` keeps one top-k per query tile until the end; were they
    views of each tile's sorted ``(tile, chunk + k)`` block, every block
    would stay alive (a 131,072-row self-kNN held 33.8 GiB on the card)."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(8, 1000)).astype(np.float32))
    v, i = smallest_k(x, 5)
    assert v.untyped_storage().nbytes() == 8 * 5 * 4
    assert i.untyped_storage().nbytes() == 8 * 5 * 8
    want = torch.sort(x, dim=1, stable=True)
    assert torch.equal(v, want.values[:, :5])
    assert torch.equal(i, want.indices[:, :5])


def test_knn_takes_tensors_and_small_corpora():
    queries, corpus = _data(n=6, nq=3)
    d, i = knn(torch.from_numpy(queries), torch.from_numpy(corpus), 4,
               device="cpu")
    want_d, want_i = jknn.knn(jnp.asarray(queries), jnp.asarray(corpus), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), atol=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_synthetic_dataset_arrays_equal_jax(monkeypatch, metric):
    monkeypatch.setenv("NLSH_SYNTH_CACHE_DIR", "")      # no shared cache
    kw = dict(n_train=900, n_test=60, dim=16, n_clusters=12, metric=metric,
              k_ground_truth=20, seed=3)
    want = JSynthetic(**kw).load()
    got = SyntheticDataset(device="cpu", **kw).load()
    assert got.dim == want.dim == 16 and got.metric == metric
    np.testing.assert_array_equal(got.training, want.training)
    np.testing.assert_array_equal(got.testing, want.testing)
    assert got.ground_truth.shape == want.ground_truth.shape == (60, 20)
    assert got.training_self_knn.shape == (900, 20)
    for mine, theirs in ((got.ground_truth, want.ground_truth),
                         (got.training_self_knn, want.training_self_knn)):
        assert mine.dtype == np.int32
        # equal off near-ties at f32 rounding: under 1% of slots, and the
        # same set of neighbours in nearly every row
        assert (mine == theirs).mean() >= 0.99


def test_synthetic_cache_is_shared_by_both_packages(tmp_path, monkeypatch):
    """One cache file name in both packages: what one writes, the other
    reads."""
    monkeypatch.setenv("NLSH_SYNTH_CACHE_DIR", str(tmp_path))
    kw = dict(n_train=300, n_test=20, dim=8, n_clusters=5, k_ground_truth=10,
              compute_self_knn=False)
    mine = SyntheticDataset(device="cpu", **kw)
    theirs = JSynthetic(**kw)
    assert mine._cache_path() == theirs._cache_path()
    mine.load()
    (cache,) = list(tmp_path.iterdir())
    assert str(cache) == mine._cache_path()
    theirs.load()                                       # reads the port's file
    np.testing.assert_array_equal(theirs.ground_truth, mine.ground_truth)
    again = SyntheticDataset(device="cpu", **kw).load()
    np.testing.assert_array_equal(again.training, mine.training)
    with pytest.raises(ValueError, match="train_knn missing"):
        again.training_self_knn


def test_get_data_by_id_resolves_like_jax(monkeypatch):
    monkeypatch.setenv("NLSH_PROCESSED_GLOVE_100_PATH", "glove-100-angular.hdf5")
    monkeypatch.setenv("NLSH_PROCESSED_SIFT_PATH", "sift-128-euclidean.hdf5")
    for data_id in ("synthetic", "synthetic_euclidean",
                    "glove_100_norm_sphere", "glove_100", "sift_norm"):
        mine, theirs = get_data_by_id(data_id, device="cpu"), j_get_data(data_id)
        assert type(mine).__name__ == type(theirs).__name__
        assert mine.metric == theirs.metric
        assert mine._path == theirs._path
        assert (mine._unit_norm, mine._unit_ball) == (theirs._unit_norm,
                                                      theirs._unit_ball)
        with pytest.raises(ValueError, match="not prepared"):
            mine.training
    for bad in ("nope", "bigann_10X"):
        monkeypatch.setenv("NLSH_BIGANN_BASE_PATH", "base.u8bin")
        monkeypatch.setenv("NLSH_BIGANN_QUERY_PATH", "query.u8bin")
        with pytest.raises(ValueError, match="unknown data id"):
            get_data_by_id(bad, device="cpu")
