"""BASELINE's configurations 1 and 2 as ``benchmarks/configs.py``'s
``config_1`` and ``config_2`` build, fit and serve them: their data,
trunk, head and training and serving arguments, in one table that the
card's smoke run and the JAX anchor fits both read."""

from __future__ import annotations

from nlsh_tpu_torch.data.datasets import Dataset, SyntheticDataset

# ``data``: ``_data``'s arguments; ``subset``: the rows the fit trains on
# (``default_rng(0).choice``, their self-kNN computed apart), or None for
# the whole corpus with its self-kNN; ``train_hash_times``: ``_train``'s
# ``hash_times``; ``hash_times`` and ``probe_mode``: the serve's
CONFIGS = {
    "1": dict(data=("glove_25", 100_000, 10_000, 25, "cosine"),
              encoder="mlp", bits=8, balance_lambda=0.0, batch_size=1024,
              steps=400, train_hash_times=10, subset=None, hash_times=10,
              probe_mode="sample"),
    "2": dict(data=("sift", 1_000_000, 10_000, 128, "euclidean"),
              encoder="siren", bits=12, balance_lambda=1.5, batch_size=2048,
              steps=400, train_hash_times=16, subset=131_072, hash_times=16,
              probe_mode="flip"),
}


def config_encoder(models, cfg: dict, dim: int):
    """The configuration's trunk from ``models``, the ``models`` package
    of either the port or the JAX package: ``TwoLayer256Relu(dim)`` for
    config 1 (``config_1``'s ``get_encoder("mlp", dim, [256, 256])`` is
    the same ``MLPEncoder``), else the named trunk of two 256 layers."""
    if cfg["encoder"] == "mlp":
        return models.TwoLayer256Relu(dim)
    return models.get_encoder(cfg["encoder"], dim, [256, 256])


def config_data(data_id: str, n_train: int, n_test: int, dim: int,
                metric: str, k: int = 10, seed: int = 0, *,
                device) -> Dataset:
    """The synthetic stand-in for ``data_id`` that ``_data`` builds when
    no real file is configured, loaded: ``max(64, n_train // 512)``
    clusters, ground truth of ``max(k, 20)``, the self-kNN up to 200,000
    rows, its kNN computed on ``device``."""
    return SyntheticDataset(
        n_train=n_train, n_test=n_test, dim=dim,
        n_clusters=max(64, n_train // 512), metric=metric,
        k_ground_truth=max(k, 20), seed=seed,
        compute_self_knn=n_train <= 200_000, device=device,
    ).load()
