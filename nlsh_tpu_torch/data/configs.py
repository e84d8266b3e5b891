"""BASELINE's configurations 1, 2 and 4 and the product-quantisation one
as ``benchmarks/configs.py``'s ``config_1``, ``config_2``, ``config_4``
and ``config_pq`` build, fit and serve them: their data, trunk, head and
training and serving arguments, in one table that the card's smoke run
and the JAX anchor fits both read."""

from __future__ import annotations

from nlsh_tpu_torch.data.datasets import Dataset, SyntheticDataset

# ``data``: ``_data``'s arguments; ``head``, ``encoder``, ``widths`` and
# ``bits``: the hashing (``get_hashing(head, get_encoder(encoder, dim,
# widths), bits)``); ``n_tables``: the jointly trained tables
# (``MultiTableTrainer``), or None for one; ``subset``: the rows the fit
# trains on (``default_rng(0).choice``, their self-kNN computed apart), or
# None for the whole corpus with its self-kNN; ``train_hash_times``:
# ``_train``'s ``hash_times``; ``hash_times`` and ``probe_mode``: the
# serve's; ``engine`` and ``serving_dtype``: the index's (the engine the
# accelerator serves; ``"float32"`` or ``"bfloat16"`` rows);
# ``calibrate_rows``: the first corpus rows the windowed ensemble
# calibrates its group bound on (at ``hash_times=1``), or None
CONFIGS = {
    "1": dict(data=("glove_25", 100_000, 10_000, 25, "cosine"),
              head="MultivariateBernoulli", encoder="mlp", widths=(256, 256),
              bits=8, n_tables=None, balance_lambda=0.0, batch_size=1024,
              steps=400, train_hash_times=10, subset=None, hash_times=10,
              probe_mode="sample", engine="grouped", serving_dtype="float32",
              calibrate_rows=None),
    "2": dict(data=("sift", 1_000_000, 10_000, 128, "euclidean"),
              head="MultivariateBernoulli", encoder="siren",
              widths=(256, 256), bits=12, n_tables=None, balance_lambda=1.5,
              batch_size=2048, steps=400, train_hash_times=16,
              subset=131_072, hash_times=16, probe_mode="flip",
              engine="grouped", serving_dtype="float32", calibrate_rows=None),
    "4": dict(data=("glove_100_mt", 200_000, 10_000, 100, "cosine"),
              head="MultivariateBernoulli", encoder="siren",
              widths=(128, 128), bits=10, n_tables=8, balance_lambda=0.0,
              batch_size=1024, steps=300, train_hash_times=10, subset=None,
              hash_times=1, probe_mode="sample", engine="windowed",
              serving_dtype="float32", calibrate_rows=10_000),
    "pq": dict(data=("glove_100_pq", 200_000, 2000, 100, "cosine"),
               head="ProductQuantization", encoder="siren",
               widths=(256, 256), bits=12, n_tables=None, balance_lambda=0.0,
               batch_size=2048, steps=400, train_hash_times=10, subset=None,
               hash_times=10, probe_mode="sample", engine="grouped",
               serving_dtype="bfloat16", calibrate_rows=None),
}


def config_encoder(models, cfg: dict, dim: int):
    """The configuration's trunk from ``models``, the ``models`` package
    of either the port or the JAX package: ``TwoLayer256Relu(dim)`` for
    config 1 (``config_1``'s ``get_encoder("mlp", dim, [256, 256])`` is
    the same ``MLPEncoder``), else the named trunk of the table's
    widths."""
    if cfg["encoder"] == "mlp":
        return models.TwoLayer256Relu(dim)
    return models.get_encoder(cfg["encoder"], dim, list(cfg["widths"]))


def config_head(models, cfg: dict, dim: int):
    """The configuration's head from ``models`` (either package's):
    ``get_hashing(head, trunk, bits)``.  An ensemble's tables are this
    head's architecture: ``MultiTableTrainer(trainer, n_tables)`` of a
    trainer of it draws them (in the JAX package one module with stacked
    params, in the port one module per table)."""
    return models.get_hashing(cfg["head"], config_encoder(models, cfg, dim),
                              cfg["bits"])


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
