"""The frozen draws against the program's own workloads module, bit for
bit: the deployment (corpus, test queries) and the traffic pool, whose
``--seed 0`` is the program's ``glove100_fresh_pool(16)``."""

import json
import os

import numpy as np

from portbench import workload as wl

from nlsh_tpu_torch.data import workloads as pw

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"n_corpus": 5000, "dim": 100, "n_test": 300,
         "n_clusters": pw.N_CLUSTERS, "cluster_noise": pw.CLUSTER_NOISE,
         "seed": 0, "metric": "cosine"}


def test_deployment_is_the_programs_draw():
    dep = wl.draw_deployment(SMALL)
    corpus, queries = pw.glove100_workload(np.random.default_rng(0),
                                           n_corpus=5000, n_queries=300)
    assert np.array_equal(dep.corpus, corpus)
    assert np.array_equal(dep.queries, queries)
    assert dep.corpus.dtype == np.float32


def test_configs_state_the_programs_cluster_model():
    for name in ("glove100-mvb12", "glove100-ens8"):
        with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
            dep = json.load(f)["deployment"]
        assert (dep["n_corpus"], dep["dim"], dep["n_test"]) == (
            pw.N_CORPUS, pw.DIM, pw.N_QUERIES)
        assert (dep["n_clusters"], dep["cluster_noise"], dep["seed"]) == (
            pw.N_CLUSTERS, pw.CLUSTER_NOISE, pw.SEED)


def test_seed_zero_pool_is_the_programs_fresh_pool():
    dep = dict(SMALL, n_corpus=pw.N_CORPUS)
    traffic = {"batch": pw.N_QUERIES, "pool_batches": 16}
    pool = wl.query_pool(dep, traffic, 0, wl.centers_of(dep))
    assert np.array_equal(pool, pw.glove100_fresh_pool(16))


def test_pool_follows_the_run_seed_only():
    dep = SMALL
    traffic = {"batch": 50, "pool_batches": 3}
    centers = wl.centers_of(dep)
    a = wl.query_pool(dep, traffic, 7, centers)
    assert np.array_equal(a, wl.query_pool(dep, traffic, 7, centers))
    assert not np.array_equal(a, wl.query_pool(dep, traffic, 8, centers))
    big = wl.query_pool(dep, traffic, 2 ** 31 + 5, centers)
    assert big.shape == (3, 50, 100) and np.isfinite(big).all()


def test_cache_round_trip(tmp_path):
    first = wl.deployment(SMALL, str(tmp_path))
    assert os.listdir(tmp_path) == [wl.cache_name(SMALL)]
    again = wl.deployment(SMALL, str(tmp_path))
    for a, b in zip(first, again):
        assert np.array_equal(a, b)
