"""The training tests' data, made with numpy alone, so the card's tests
(which run where JAX is not installed) share it with the parity tests.
Not a test module."""

import numpy as np

D, HIDDEN, BITS, BS = 16, (32, 32), 6, 64


class Data:
    """A dataset both packages' trainers take: numpy arrays."""

    def __init__(self, training, testing, ground_truth, knn, metric):
        self.training = training
        self.testing = testing
        self.ground_truth = ground_truth
        self.training_self_knn = knn
        self.metric = metric
        self.prepared = True
        self.dim = training.shape[1]

    def load(self):
        return self


def make_data(n=512, nq=32, d=D, k=10, metric="cosine", seed=0) -> Data:
    """Clustered unit rows with exact (float64) cosine kNN."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, d))
    pts = centers[rng.integers(0, 16, n + nq)] + 0.3 * rng.normal(size=(n + nq, d))
    pts = (pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(np.float32)
    train, test = pts[:n], pts[n:]
    sim = train.astype(np.float64) @ train.T
    np.fill_diagonal(sim, -np.inf)
    knn = np.argsort(-sim, axis=1, kind="stable")[:, :k].astype(np.int32)
    gt = np.argsort(-(test.astype(np.float64) @ train.T), axis=1,
                    kind="stable")[:, :k].astype(np.int32)
    return Data(train, test, gt, knn, metric)
