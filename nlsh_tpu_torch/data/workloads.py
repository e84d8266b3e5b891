"""The bench workloads of the port: the glove-100-shaped bench table and
config 5's deep-image-96 cluster model, drawn from a seed with numpy.

Every array comes out bit for bit as the JAX package's bench draws it
(``bench.py`` and ``benchmarks/configs.py``): the same generators, the
same draws in the same order (``tests/test_torch_workloads.py`` holds
them equal).  The bench's trained params and exact ground truth are
committed data; this module names their files from the same keys the
bench builds them from, and reads none of them.

Imports numpy only.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

N_CORPUS = 1_183_514  # glove-100-angular training-set size
DIM = 100
N_QUERIES = 10_000
K = 10
HASH_SIZE = 12
HASH_TIMES = 16
TRAIN_SUBSET = 131_072
TRAIN_STEPS = 1000
SEED = 0
# trainer hyper-parameters (part of the params file's key)
TRAIN_CFG = dict(margin=0.5, positive_k=20, balance_lambda=1.5,
                 batch_size=2048, learning_rate=1e-3, encoder="siren",
                 hidden=(256, 256))
CAP = 512                # the single table's probe budget
ENSEMBLE_HASH_TIMES = 4  # flip probes per table of the L=8 ensemble

# ONE cluster model for corpus, queries and the fresh query pool: a change
# here changes all three, and the committed ground truth no longer fits
N_CLUSTERS = 4096
CLUSTER_NOISE = 0.35

# config 5's cluster model (deep-image-96 shape)
CFG5_CLUSTERS = 8192
CFG5_NOISE = 0.3

# the committed artifacts, relative to the repository's root
ARTIFACT_DIR = os.path.join("benchmarks", "artifacts", "bench_cache")


def workload_key() -> str:
    """The key of the bench workload's files (its ground truth)."""
    return (f"s{SEED}_n{N_CORPUS}_d{DIM}_q{N_QUERIES}_k{K}"
            f"_ts{TRAIN_SUBSET}_v2")


def train_key() -> str:
    """The key of the bench's trained params: the workload's key and a
    digest of every training hyper-parameter."""
    cfg = dict(TRAIN_CFG, hash_size=HASH_SIZE, hash_times=HASH_TIMES,
               steps=TRAIN_STEPS)
    blob = json.dumps(cfg, sort_keys=True).encode()
    return f"{workload_key()}_{hashlib.sha1(blob).hexdigest()[:10]}"


def params_file() -> str:
    """The committed params of the bench's 12-bit SIREN head."""
    return f"params_{train_key()}.msgpack"


def gt_file() -> str:
    """The committed exact top-10 of the queries (``gt``) and the
    training subset's self-kNN (``sub_knn``)."""
    return f"gt_{workload_key()}.npz"


def ensemble_params_file() -> str:
    """The committed params of the L=8 high-recall ensemble
    (``benchmarks/mt_highrecall.py``'s fit: 12 bits, 600 steps at batch
    2048, 8 tables)."""
    return "cfgparams_mthr_glove100_b12_s600_b2048_t8_v2.msgpack"


def artifact_path(name: str, root: str) -> str:
    """``name``'s path under the repository root ``root``."""
    return os.path.join(root, ARTIFACT_DIR, name)


class BenchData:
    """The dataset duck the trainers take: a corpus subset with its
    self-kNN ground truth."""

    def __init__(self, training, testing, ground_truth, train_knn, metric):
        self.training = training
        self.testing = testing
        self.ground_truth = ground_truth
        self.training_self_knn = train_knn
        self.metric = metric
        self.prepared = True
        self.dim = training.shape[1]

    def load(self):
        return self


def _cluster_points(centers, rng, n):
    """``n`` unit-sphere points from the bench cluster model, drawn from
    ``rng`` as (assignments, then noise)."""
    dim = centers.shape[1]
    assign = rng.integers(0, centers.shape[0], size=n)
    pts = centers[assign] + CLUSTER_NOISE * rng.normal(
        size=(n, dim)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts


def glove100_workload(rng, n_corpus=N_CORPUS, n_queries=N_QUERIES, dim=DIM):
    """``(corpus, queries)``: clustered unit-sphere data with the
    glove-100-angular shape, drawn from ``rng``."""
    centers = rng.normal(size=(N_CLUSTERS, dim)).astype(np.float32)
    pts = _cluster_points(centers, rng, n_corpus + n_queries)
    return pts[:n_corpus], pts[n_corpus:]


def training_subset(rng, n_corpus=N_CORPUS, n_subset=TRAIN_SUBSET):
    """The training subset's row indices, drawn from the workload's own
    generator straight after :func:`glove100_workload`; the committed
    ``sub_knn`` holds this draw's rows in this order."""
    return rng.choice(n_corpus, n_subset, replace=False)


def glove100_bench(seed=SEED, n_corpus=N_CORPUS, n_queries=N_QUERIES,
                   n_subset=TRAIN_SUBSET):
    """``(corpus, queries, subset indices)`` of the bench, all drawn from
    one generator seeded ``seed``."""
    rng = np.random.default_rng(seed)
    corpus, queries = glove100_workload(rng, n_corpus, n_queries)
    return corpus, queries, training_subset(rng, n_corpus, n_subset)


def glove100_fresh_pool(repeats, n_queries=N_QUERIES, dim=DIM, seed=SEED):
    """``(repeats, n_queries, dim)`` fresh queries from the workload's
    cluster model: the same centers (replayed from ``seed``), new
    assignments and noise (from ``seed + 1_000_003``)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(N_CLUSTERS, dim)).astype(np.float32)
    rng2 = np.random.default_rng(seed + 1_000_003)
    pts = _cluster_points(centers, rng2, repeats * n_queries)
    return pts.reshape(repeats, n_queries, dim)


def deepimage96_points(centers, rng, n, dim=96):
    """``n`` unit-sphere points from config 5's cluster model, drawn from
    ``rng`` as (assignments, then noise)."""
    assign = rng.integers(0, centers.shape[0], size=n)
    pts = centers[assign] + CFG5_NOISE * rng.normal(
        size=(n, dim)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts


def deepimage96_workload(rng, n_corpus, n_test=2000, dim=96):
    """``(centers, corpus, queries)`` of config 5; the centers let a
    caller draw fresh queries of the same distribution."""
    centers = rng.normal(size=(CFG5_CLUSTERS, dim)).astype(np.float32)
    pts = deepimage96_points(centers, rng, n_corpus + n_test, dim=dim)
    return centers, pts[:n_corpus], pts[n_corpus:]


def id_agreement(a_top: np.ndarray, b_top: np.ndarray) -> float:
    """Mean per-query overlap of two top-k id sets (``-1`` = no id), over
    the ids ``a_top`` holds."""
    return float(np.mean([
        len(set(ra[ra >= 0]) & set(rb[rb >= 0])) / max((ra >= 0).sum(), 1)
        for ra, rb in zip(a_top, b_top)
    ]))
