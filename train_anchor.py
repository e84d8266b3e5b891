#!/usr/bin/env python3
"""The training gate's anchor: the JAX package's bench fit, served by the port.

    JAX_PLATFORMS=cpu python3 train_anchor.py --seeds 0 1 --out <dir>

For each seed, the JAX package's ``TripletTrainer.fit`` at the bench's
training configuration (``bench.TRAIN_CFG``: SIREN 100->256->256, 12-bit
MultivariateBernoulli, margin 0.5, positive_k 20, balance lambda 1.5,
batch 2048, lr 1e-3, 1,000 steps) on the 131,072-row subset of the bench
workload with the committed ``sub_knn``, on the CPU (exact f32).  The
trained params are loaded into the port and the full corpus (1,183,514
rows) is served by the port's plain CPU serve: 10,000 queries, 16 flip
probes, cap 512, k = 10, recall@10 against the committed ground truth.
One JSON line per seed; the params go to ``<dir>/params_s<seed>.msgpack``.

These are the numbers ``chip_smoke.py``'s ``train`` phase is held to: a
model trained by another random stream lands in their neighbourhood, not
on the committed params' values.  Imports JAX, so it runs where the JAX
package runs, never on the card's machine.
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
    ids, n_cand = zip(*(idx.query(queries[s: s + QUERY_CHUNK], k=bench.K,
                                  hash_times=bench.HASH_TIMES,
                                  probe_mode="flip")
                        for s in range(0, queries.shape[0], QUERY_CHUNK)))
    ids, n_cand = np.concatenate(ids), np.concatenate(n_cand)
    return {"recall_at_10": float(calculate_recall(gt, ids, np.mean)),
            "mean_n_candidates": float(n_cand.mean()),
            "max_bucket": idx.table.max_count(),
            "buckets_used": idx.n_buckets_used()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--out", required=True,
                   help="directory for the trained params")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

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
