"""The port's bench workloads (``nlsh_tpu_torch.data.workloads``) against
the JAX package's bench (``bench.py``, ``benchmarks/configs.py``): every
array bit for bit at small sizes, the keys, the trainer's configuration,
the committed artifacts' names and ``id_agreement``.  Both sides import
numpy only, so nothing here imports JAX."""

import os

import numpy as np
import pytest

import bench
import benchmarks.configs as bconfigs
from nlsh_tpu_torch.data import workloads as wl

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n_corpus,n_queries,dim", [(2000, 100, 100),
                                                    (513, 31, 24)])
def test_glove100_workload_bitwise(seed, n_corpus, n_queries, dim):
    want = bench.glove100_workload(np.random.default_rng(seed), n_corpus,
                                   n_queries, dim)
    got = wl.glove100_workload(np.random.default_rng(seed), n_corpus,
                               n_queries, dim)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 3])
def test_training_subset_is_the_draw_after_the_workload(seed):
    rng = np.random.default_rng(seed)
    corpus, queries = bench.glove100_workload(rng, 2000, 100)
    want = rng.choice(2000, 256, replace=False)

    c, q, sub = wl.glove100_bench(seed, 2000, 100, 256)
    assert np.array_equal(c, corpus) and np.array_equal(q, queries)
    assert np.array_equal(sub, want)
    rng = np.random.default_rng(seed)
    wl.glove100_workload(rng, 2000, 100)
    assert np.array_equal(wl.training_subset(rng, 2000, 256), want)


@pytest.mark.parametrize("repeats,n_queries,seed", [(2, 64, 0), (3, 17, 5)])
def test_glove100_fresh_pool_bitwise(repeats, n_queries, seed):
    want = bench.glove100_fresh_pool(repeats, n_queries=n_queries, seed=seed)
    got = wl.glove100_fresh_pool(repeats, n_queries=n_queries, seed=seed)
    assert got.shape == (repeats, n_queries, wl.DIM)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 2])
def test_deepimage96_bitwise(seed):
    want = bconfigs.deepimage96_workload(np.random.default_rng(seed), 3000,
                                         n_test=50)
    got = wl.deepimage96_workload(np.random.default_rng(seed), 3000,
                                  n_test=50)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    centers = got[0]
    pts = [f(centers, np.random.default_rng(seed + 10), 200) for f in
           (bconfigs.deepimage96_points, wl.deepimage96_points)]
    assert np.array_equal(pts[1], pts[0])


@pytest.mark.parametrize("name", [
    "N_CORPUS", "DIM", "N_QUERIES", "K", "HASH_SIZE", "HASH_TIMES",
    "TRAIN_SUBSET", "TRAIN_STEPS", "SEED", "TRAIN_CFG", "N_CLUSTERS",
    "CLUSTER_NOISE", "CFG5_CLUSTERS", "CFG5_NOISE"])
def test_constants_equal_the_bench(name):
    src = bconfigs if name.startswith("CFG5") else bench
    assert getattr(wl, name) == getattr(src, name)


def test_defaults_are_the_bench_constants():
    import inspect

    for fn, names in ((wl.glove100_workload, ("n_corpus", "n_queries", "dim")),
                      (wl.glove100_fresh_pool, ("n_queries", "dim", "seed"))):
        params = inspect.signature(fn).parameters
        want = inspect.signature(getattr(bench, fn.__name__)).parameters
        for name in names:
            assert params[name].default == want[name].default


def test_keys_and_committed_artifacts():
    assert wl.workload_key() == bench._workload_key()
    assert wl.train_key() == bench._train_key()
    assert wl.params_file() == f"params_{bench._train_key()}.msgpack"
    assert wl.gt_file() == f"gt_{bench._workload_key()}.npz"
    assert (os.path.join(_ROOT, wl.ARTIFACT_DIR)
            == os.path.abspath(bench.REPO_CACHE_DIR))
    for name in (wl.params_file(), wl.gt_file(), wl.ensemble_params_file()):
        assert os.path.isfile(wl.artifact_path(name, _ROOT)), name


def test_id_agreement_equals_the_bench():
    rng = np.random.default_rng(0)
    for _ in range(5):
        a = rng.integers(0, 30, (40, 10))
        b = rng.integers(0, 30, (40, 10))
        a[rng.random(a.shape) < 0.2] = -1
        b[rng.random(b.shape) < 0.2] = -1
        a[3] = -1  # a query with no id
        assert wl.id_agreement(a, b) == bench._id_agreement(a, b)
        assert wl.id_agreement(b, a) == bench._id_agreement(b, a)


def test_bench_data_attributes():
    rng = np.random.default_rng(0)
    training = rng.normal(size=(64, 12)).astype(np.float32)
    args = (training, training[:4], np.zeros((4, 10), np.int64),
            np.zeros((64, 20), np.int64), "cosine")
    got, want = wl.BenchData(*args), bench._BenchData(*args)
    assert vars(got).keys() == vars(want).keys()
    for key, value in vars(want).items():
        assert getattr(got, key) is value or getattr(got, key) == value
    assert got.load() is got and got.dim == 12 and got.prepared
