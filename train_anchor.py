#!/usr/bin/env python3
"""The training gates' anchors: the JAX package's fits, served by the port.

    JAX_PLATFORMS=cpu python3 train_anchor.py --seeds 0 1 --out <dir>
    JAX_PLATFORMS=cpu python3 train_anchor.py --config 1 --out <dir>
    JAX_PLATFORMS=cpu python3 train_anchor.py --config 2 --out <dir>
    JAX_PLATFORMS=cpu python3 train_anchor.py --config 4 --out <dir>
    JAX_PLATFORMS=cpu python3 train_anchor.py --config pq --out <dir>

For each seed, the JAX package's ``TripletTrainer.fit`` at the bench's
training configuration (``bench.TRAIN_CFG``: SIREN 100->256->256, 12-bit
MultivariateBernoulli, margin 0.5, positive_k 20, balance lambda 1.5,
batch 2048, lr 1e-3, 1,000 steps) on the 131,072-row subset of the bench
workload with the committed ``sub_knn``, on the CPU (exact f32).  The
trained params are loaded into the port and the full corpus (1,183,514
rows) is served by the port's plain CPU serve: 10,000 queries, 16 flip
probes, cap 512, k = 10, recall@10 against the committed ground truth.
One JSON line per seed; the params go to ``<dir>/params_s<seed>.msgpack``.

``--config 1``, ``2``, ``4`` and ``pq`` fit BASELINE's configurations
1, 2 and 4 and the product-quantisation one as ``benchmarks/configs.py``'s
``config_1`` / ``config_2`` / ``config_4`` / ``config_pq`` fit them
(``nlsh_tpu_torch.data.configs``; config 4 eight tables jointly, through
``MultiTableTrainer``), on the synthetic stand-ins of its ``_data``
(built by the JAX package; their kNN cached under ``<dir>/synth_cache``
unless ``NLSH_SYNTH_CACHE_DIR`` is set), and serve the full corpus with
the port's plain CPU serve at the configuration's probes, engine and
layout: sampled probes (configs 1 and pq) once per ``CONFIG_PROBE_SEEDS``
seed of a CPU generator (the spread of the draws beside the spread of
the fits), config 2's flip probes once, config 4's ensemble once on the
windowed engine at one probe a table after ``calibrate`` on its first
10,000 corpus rows, with the exact distinct-candidate count
(``exact_query_size``, the quantity ``config_4`` reports) beside the
summed one.  One JSON line per serve.

These are the numbers ``chip_smoke.py``'s ``train`` and ``config<name>``
phases are held to: a model trained by another random stream
lands in their neighbourhood, not on these values.  Imports JAX, so it
runs where the JAX package runs, never on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GT = os.path.join(ROOT, "benchmarks", "artifacts", "bench_cache",
                  "gt_s0_n1183514_d100_q10000_k10_ts131072_v2.npz")
QUERY_CHUNK = 1000  # queries per plain serve call: bounds host memory
CONFIG_PROBE_SEEDS = (0, 1, 2)  # CPU generators of the sampled probes


def _fit(seed: int, data, out_dir: str):
    import jax
    from flax import serialization

    import bench
    from nlsh_tpu.models import get_encoder, get_hashing
    from nlsh_tpu.train import TripletTrainer

    cfg = bench.TRAIN_CFG
    hashing = get_hashing("MultivariateBernoulli",
                          get_encoder(cfg["encoder"], bench.DIM,
                                      list(cfg["hidden"])), bench.HASH_SIZE)
    trainer = TripletTrainer(hashing, data, out_dir, margin=cfg["margin"],
                             positive_k=cfg["positive_k"],
                             balance_lambda=cfg["balance_lambda"])
    t0 = time.perf_counter()
    state = trainer.fit(K=bench.K, batch_size=cfg["batch_size"],
                        learning_rate=cfg["learning_rate"], epochs=100,
                        test_every_updates=100_000,
                        max_steps=bench.TRAIN_STEPS,
                        hash_times=bench.HASH_TIMES, seed=seed)
    params = jax.tree.map(np.asarray, state.params["hashing"])
    train_s = time.perf_counter() - t0
    path = os.path.join(out_dir, f"params_s{seed}.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(params))
    return path, train_s


def _chunked(serve, queries):
    """``serve`` over ``QUERY_CHUNK``-query chunks, concatenated."""
    ids, n_cand = zip(*(serve(queries[s: s + QUERY_CHUNK])
                        for s in range(0, queries.shape[0], QUERY_CHUNK)))
    return np.concatenate(ids), np.concatenate(n_cand)


def _serve(params_path: str, corpus, queries, gt) -> dict:
    import torch

    import bench
    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.models import get_encoder, get_hashing
    from nlsh_tpu_torch.utils.checkpoint import params_from_jax, read_msgpack
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    hashing = get_hashing("MultivariateBernoulli",
                          get_encoder("siren", bench.DIM, [256, 256]),
                          bench.HASH_SIZE)
    params_from_jax(hashing, read_msgpack(params_path))
    idx = Indexer(hashing, torch.from_numpy(corpus), device="cpu",
                  metric="cosine", probe_budget=512)
    ids, n_cand = _chunked(lambda q: idx.query(
        q, k=bench.K, hash_times=bench.HASH_TIMES, probe_mode="flip"),
        queries)
    return {"recall_at_10": float(calculate_recall(gt, ids, np.mean)),
            "mean_n_candidates": float(n_cand.mean()),
            "max_bucket": idx.table.max_count(),
            "buckets_used": idx.n_buckets_used()}


def _config_data(cfg: dict):
    """The configuration's workload (``_data``), and its training set:
    the full data, or a subset with its self-kNN on the CPU."""
    import jax.numpy as jnp

    import bench
    from benchmarks.configs import _data
    from nlsh_tpu.ops.knn import self_knn

    data = _data(*cfg["data"])
    if not cfg["subset"]:
        return data, data
    sub = np.random.default_rng(0).choice(data.training.shape[0],
                                          cfg["subset"], replace=False)
    subset = data.training[sub]
    sub_knn = np.asarray(self_knn(jnp.asarray(subset), k=20,
                                  metric=data.metric))
    return data, bench._BenchData(subset, data.testing[:256],
                                  data.ground_truth[:256], sub_knn,
                                  data.metric)


def _config_fit(cfg: dict, seed: int, train_data, out_dir: str, name: str):
    import jax
    from flax import serialization

    from benchmarks.configs import _StderrLogger
    from nlsh_tpu import models
    from nlsh_tpu.train import MultiTableTrainer, TripletTrainer
    from nlsh_tpu_torch.data.configs import config_head

    dim = train_data.training.shape[1]
    trainer = TripletTrainer(config_head(models, cfg, dim), train_data,
                             out_dir, logger=_StderrLogger(), margin=0.5,
                             positive_k=20,
                             balance_lambda=cfg["balance_lambda"])
    if cfg["n_tables"]:
        trainer = MultiTableTrainer(trainer, cfg["n_tables"])
    t0 = time.perf_counter()
    state = trainer.fit(K=10, batch_size=cfg["batch_size"],
                        learning_rate=1e-3, epochs=1000,
                        test_every_updates=10 ** 9, max_steps=cfg["steps"],
                        hash_times=cfg["train_hash_times"], seed=seed)
    params = jax.tree.map(np.asarray, state.params["hashing"])
    train_s = time.perf_counter() - t0
    path = os.path.join(out_dir, f"params_config{name}_s{seed}.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(params))
    return path, train_s


def _config_serves(cfg: dict, params_path: str, data):
    """The port's plain CPU serve of the full corpus: one result per
    ``CONFIG_PROBE_SEEDS`` seed (sampled probes), or one (flip probes, or
    the ensemble's one probe a table)."""
    import torch

    from nlsh_tpu_torch import models
    from nlsh_tpu_torch.data.configs import config_head
    from nlsh_tpu_torch.index import Indexer
    from nlsh_tpu_torch.utils.checkpoint import (
        params_from_jax,
        read_msgpack,
        stacked_params_from_jax,
    )
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    def head():
        return config_head(models, cfg, data.dim)

    if cfg["n_tables"]:
        yield _ensemble_serve(cfg, stacked_params_from_jax(
            head, read_msgpack(params_path)), data)
        return
    gt = data.ground_truth[:, :10]
    idx = Indexer(params_from_jax(head(), read_msgpack(params_path)),
                  torch.from_numpy(data.training), device="cpu",
                  metric=data.metric, engine=cfg["engine"],
                  serving_dtype=getattr(torch, cfg["serving_dtype"]))
    sampled = cfg["probe_mode"] == "sample"
    for ps in CONFIG_PROBE_SEEDS if sampled else [None]:
        gen = torch.Generator().manual_seed(ps) if sampled else None
        ids, n_cand = _chunked(lambda q: idx.query(
            q, k=10, hash_times=cfg["hash_times"], generator=gen,
            probe_mode=cfg["probe_mode"]), data.testing)
        yield {"probe_seed": ps,
               "recall_at_10": float(calculate_recall(gt, ids, np.mean)),
               "mean_n_candidates": float(n_cand.mean()),
               "max_bucket": idx.table.max_count(),
               "buckets_used": idx.n_buckets_used(),
               "serving_dtype": cfg["serving_dtype"]}


def _ensemble_serve(cfg: dict, hashings, data) -> dict:
    """The ensemble's windowed serve on the CPU, after ``calibrate`` on
    the first ``calibrate_rows`` corpus rows: recall@10, the summed and
    the exact distinct candidates, and the calibrated group count."""
    import torch

    from nlsh_tpu_torch.parallel import MultiTableIndexer
    from nlsh_tpu_torch.utils.metrics import calculate_recall

    midx = MultiTableIndexer(hashings, torch.from_numpy(data.training),
                             device="cpu", metric=data.metric,
                             engine=cfg["engine"],
                             serving_dtype=getattr(torch,
                                                   cfg["serving_dtype"]))
    kw = dict(hash_times=cfg["hash_times"], probe_mode=cfg["probe_mode"])
    g_cal = midx.calibrate(data.training[:cfg["calibrate_rows"]], **kw)
    ids, n_cand = _chunked(lambda q: midx.query(q, k=10, **kw), data.testing)
    size = midx.exact_query_size(data.testing, **kw)
    return {"probe_seed": None,
            "recall_at_10": float(calculate_recall(
                data.ground_truth[:, :10], ids, np.mean)),
            "mean_n_candidates": float(n_cand.mean()),
            "mean_exact_query_size": float(size.mean()),
            "groups_calibrated": g_cal,
            "max_bucket": [int(c) for c in midx.counts.max(dim=1).values],
            "buckets_used": [int(c) for c in (midx.counts > 0).sum(dim=1)],
            "serving_dtype": cfg["serving_dtype"]}


def main_config(name: str, seeds, out_dir: str) -> None:
    from nlsh_tpu_torch.data.configs import CONFIGS

    os.environ.setdefault("NLSH_SYNTH_CACHE_DIR",
                          os.path.join(out_dir, "synth_cache"))
    cfg = CONFIGS[name]
    t0 = time.perf_counter()
    data, train_data = _config_data(cfg)
    data_s = time.perf_counter() - t0
    for seed in seeds:
        path, train_s = _config_fit(cfg, seed, train_data, out_dir, name)
        for out in _config_serves(cfg, path, data):
            print(json.dumps({"config": name, "seed": seed,
                              "train_s": train_s, "data_s": data_s,
                              "device": "cpu", **out}), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=("bench", "1", "2", "4", "pq"),
                   default="bench",
                   help="the bench's fit, BASELINE's configuration 1, 2 "
                        "or 4, or the product-quantisation one")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--out", required=True,
                   help="directory for the trained params")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.config != "bench":
        main_config(args.config, args.seeds, args.out)
        return

    import bench

    rng = np.random.default_rng(bench.SEED)
    corpus, queries = bench.glove100_workload(rng)
    sub_idx = rng.choice(bench.N_CORPUS, bench.TRAIN_SUBSET, replace=False)
    with np.load(GT) as z:
        gt, sub_knn = z["gt"], z["sub_knn"]
    data = bench._BenchData(corpus[sub_idx], queries[:256], gt[:256],
                            sub_knn, "cosine")
    for seed in args.seeds:
        path, train_s = _fit(seed, data, args.out)
        out = {"seed": seed, "train_s": train_s, "device": "cpu",
               **_serve(path, corpus, queries, gt)}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
