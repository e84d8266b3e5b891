"""The deployment's data and the traffic's queries, drawn with numpy.

A frozen copy of the glove-100-shaped cluster model the program's own
workloads module draws (``nlsh_tpu_torch.data.workloads``): the same
generators and the same draws in the same order, so the arrays come out
bit for bit as the program's own bench draws them.  The deployment (its
corpus, held-out test queries and cluster centres) comes from the
configuration's seed alone, since the committed heads were trained on
that corpus; a run's ``--seed`` draws only the traffic.

Imports numpy only.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

POOL_SEED_OFFSET = 1_000_003  # the traffic's generator: seed + this


class Deployment(NamedTuple):
    corpus: np.ndarray    # (n_corpus, dim) float32 unit rows
    queries: np.ndarray   # (n_test, dim) the held-out test queries
    centers: np.ndarray   # (n_clusters, dim) float32


def cluster_points(centers: np.ndarray, rng, n: int,
                   noise: float) -> np.ndarray:
    """``n`` unit-sphere points of the cluster model, drawn from ``rng``
    as (assignments, then noise)."""
    dim = centers.shape[1]
    assign = rng.integers(0, centers.shape[0], size=n)
    pts = centers[assign] + noise * rng.normal(size=(n, dim)).astype(
        np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts


def centers_of(dep: dict, rng=None) -> np.ndarray:
    rng = np.random.default_rng(dep["seed"]) if rng is None else rng
    return rng.normal(size=(dep["n_clusters"], dep["dim"])).astype(
        np.float32)


def draw_deployment(dep: dict) -> Deployment:
    """The corpus and the test queries of a deployment (``dep``: the
    configuration's ``deployment`` object), from one generator."""
    rng = np.random.default_rng(dep["seed"])
    centers = centers_of(dep, rng)
    pts = cluster_points(centers, rng, dep["n_corpus"] + dep["n_test"],
                         dep["cluster_noise"])
    return Deployment(pts[:dep["n_corpus"]], pts[dep["n_corpus"]:], centers)


def cache_name(dep: dict) -> str:
    return ("glove-n{n_corpus}-d{dim}-c{n_clusters}-z{cluster_noise}"
            "-t{n_test}-s{seed}.npy").format(**dep)


def deployment(dep: dict, cache_dir: str | None = None) -> Deployment:
    """:func:`draw_deployment`, kept as one ``.npy`` under ``cache_dir``
    after its first draw (written to a private name, then renamed, so a
    reader never meets half a file)."""
    if cache_dir is None:
        return draw_deployment(dep)
    path = os.path.join(cache_dir, cache_name(dep))
    shape = (dep["n_corpus"] + dep["n_test"], dep["dim"])
    if os.path.exists(path):
        pts = np.load(path)
        if pts.shape == shape and pts.dtype == np.float32:
            return Deployment(pts[:dep["n_corpus"]], pts[dep["n_corpus"]:],
                              centers_of(dep))
    out = draw_deployment(dep)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.save(f, np.concatenate([out.corpus, out.queries]))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def traffic_seed(seed: int) -> int:
    """The traffic generator's seed of a run's ``--seed`` (any whole
    number; 0 gives the program's ``glove100_fresh_pool``)."""
    return seed % 2 ** 63 + POOL_SEED_OFFSET


def query_pool(dep: dict, traffic: dict, seed: int,
               centers: np.ndarray) -> np.ndarray:
    """``(pool_batches, batch, dim)`` fresh queries of the deployment's
    cluster model: its centres, new assignments and noise from the
    run's seed."""
    rng = np.random.default_rng(traffic_seed(seed))
    n = traffic["pool_batches"] * traffic["batch"]
    pts = cluster_points(centers, rng, n, dep["cluster_noise"])
    return pts.reshape(traffic["pool_batches"], traffic["batch"], -1)
