"""The HNSW baseline: a non-learned comparison point (port of
:mod:`nlsh_tpu.train.hnsw`).

The index is the port's :class:`nlsh_tpu_torch.native.NativeHNSW`
(``native/hnsw.cpp``: hnswlib's algorithm and hyper-parameters, built
with the system's ``g++``); ``hnswlib`` itself is not a backend of the
port.  Its search also returns each query's distance evaluations, logged
as ``query_size``.  The graph is built and searched on the host: the
data moves to host numpy first.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nlsh_tpu_torch.utils.loggers import NullLogger
from nlsh_tpu_torch.utils.metrics import calculate_recall


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


class HNSWBaseline:
    """The reference's HNSW learner: a cosine (or l2) index with
    ``M=10``, ``ef_construction=500``, ``ef=40``.  ``rng`` (a
    ``np.random.RandomState`` or ``Generator``; default
    ``RandomState(seed)``) shuffles the insertion order."""

    def __init__(self, data, logger=None, max_connections: int = 10,
                 ef_construction: int = 500, ef: int = 40, rng=None,
                 seed: int = 0, **_: object):
        from nlsh_tpu_torch.native import NativeHNSW

        self.backend = "native"
        self.data = data
        self.logger = logger or NullLogger()
        self.logger.meta(params={"hnsw_backend": self.backend})
        if not self.data.prepared:
            self.data.load()
        self.rng = np.random.RandomState(seed) if rng is None else rng

        self.candidate_vectors = _host(self.data.training)
        self.validation_data = _host(self.data.testing)
        self.ground_truth = np.asarray(self.data.ground_truth)[:, :10]

        space = "cosine" if self.data.metric == "cosine" else "l2"
        self.index = NativeHNSW(space=space,
                                dim=self.candidate_vectors.shape[1])
        self.index.init_index(max_elements=self.candidate_vectors.shape[0],
                              M=max_connections,
                              ef_construction=ef_construction)
        self.index.set_ef(ef)

    def fit(self, K: int = 10, batch_size: int = 4096, **_: object):
        n = self.candidate_vectors.shape[0]
        idxs = np.arange(n)
        self.rng.shuffle(idxs)
        for start in range(0, n, batch_size):
            sel = idxs[start: start + batch_size]
            self.index.add_items(self.candidate_vectors[sel, :], sel)

        t1 = time.perf_counter()
        predict_knns, _, counts = self.index.knn_query(self.validation_data,
                                                       k=K)
        t2 = time.perf_counter()
        query_size = float(np.mean(counts))

        recall = calculate_recall(self.ground_truth[:, :K], predict_knns,
                                  np.mean)
        self.logger.log("test/recall", recall, 1)
        self.logger.log("test/query_size", query_size, 1)
        self.logger.log("test/qps", self.validation_data.shape[0] / (t2 - t1),
                        1)
        return recall
