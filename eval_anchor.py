#!/usr/bin/env python3
"""The evaluation phases' anchors: the JAX package's sweeps and HNSW graph
on the CPU, at the configurations ``chip_smoke.py`` drives the port at.

    JAX_PLATFORMS=cpu python3 eval_anchor.py [--queries 2000] \\
        [--parts flip ensemble hnsw]

On the bench workload (``bench.glove100_workload``, seed 0: 1,183,514 x
100, cosine) with the committed ground truth, one JSON line per part:

* ``flip``: ``nlsh_tpu.cli.evaluate.run_sweep`` with the committed
  single-table params, ``engine="xla"`` (exact f32 on the CPU),
  ``probe_mode="flip"``, ``max_probes=16``, k = 10, on the first
  ``--queries`` queries: ``(avg_n_candidates, recall)`` per probe count;
* ``ensemble``: ``run_sweep_multitable`` with the committed 8-table
  params, flip, ``max_probes=32`` (4 probes per table), ``xla``;
* ``hnsw``: ``nlsh_tpu.native.NativeHNSW`` on the first 16,384 corpus
  rows in row order, cosine, ``M=10``, ``ef_construction=500``, on the
  first 1,000 queries at ``ef`` 40 and 100: recall@10 against the exact
  kNN of those rows (``nlsh_tpu.ops.knn.knn``) and the mean visit count.

``chip_smoke.py`` holds the port to these numbers.  Imports JAX, so it
runs where the JAX package runs, never on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "benchmarks", "artifacts", "bench_cache")
PARAMS = os.path.join(
    CACHE, "params_s0_n1183514_d100_q10000_k10_ts131072_v2_4da04f430c.msgpack")
PARAMS_T8 = os.path.join(
    CACHE, "cfgparams_mthr_glove100_b12_s600_b2048_t8_v2.msgpack")
GT = os.path.join(CACHE, "gt_s0_n1183514_d100_q10000_k10_ts131072_v2.npz")
HNSW_ROWS, HNSW_QUERIES, HNSW_EFS = 16_384, 1_000, (40, 100)


def _head():
    from nlsh_tpu.models import get_encoder, get_hashing

    return get_hashing("MultivariateBernoulli",
                       get_encoder("siren", 100, [256, 256]), 12)


def _restore(path: str, like, key=None):
    """The params in ``path`` (``key`` of its tree) in the structure of
    ``like``."""
    from flax import serialization

    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    return serialization.from_state_dict(like, tree if key is None
                                         else tree[key])


def part_flip(corpus, queries, gt) -> dict:
    import jax
    import jax.numpy as jnp

    from nlsh_tpu.cli.evaluate import run_sweep

    head = _head()
    params = _restore(PARAMS, head.init(jax.random.PRNGKey(0)))
    rows = run_sweep(head, params, jnp.asarray(corpus),
                     jnp.asarray(queries), gt, k=10, max_probes=16,
                     engine="xla", probe_mode="flip")
    return {"rows": rows}


def part_ensemble(corpus, queries, gt) -> dict:
    import jax
    import jax.numpy as jnp

    from nlsh_tpu.cli.evaluate import run_sweep_multitable
    from nlsh_tpu.parallel.multitable import init_multi_table

    head = _head()
    params = _restore(PARAMS_T8, init_multi_table(
        head, 8, jax.random.PRNGKey(0)), "hashing")
    rows = run_sweep_multitable(
        head, params, jnp.asarray(corpus),
        jnp.asarray(queries), gt, 10, 8, max_probes=32, engine="xla",
        probe_mode="flip")
    return {"rows": rows}


def part_hnsw(corpus, queries, _gt) -> dict:
    import jax.numpy as jnp

    from nlsh_tpu import native
    from nlsh_tpu.ops.knn import knn
    from nlsh_tpu.utils.metrics import calculate_recall

    rows, qs = corpus[:HNSW_ROWS], queries[:HNSW_QUERIES]
    _, exact = knn(jnp.asarray(qs), jnp.asarray(rows), 10, metric="cosine")
    exact = np.asarray(exact)
    idx = native.NativeHNSW(space="cosine", dim=rows.shape[1])
    idx.init_index(max_elements=HNSW_ROWS, M=10, ef_construction=500)
    t0 = time.perf_counter()
    idx.add_items(rows)
    out = {"build_s": time.perf_counter() - t0}
    for ef in HNSW_EFS:
        idx.set_ef(ef)
        ids, _, counts = idx.knn_query(qs, k=10)
        out[f"ef{ef}"] = {
            "recall": float(calculate_recall(exact, ids, np.mean)),
            "mean_visits": float(np.mean(counts))}
    return out


PARTS = {"flip": part_flip, "ensemble": part_ensemble, "hnsw": part_hnsw}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--queries", type=int, default=10_000,
                        help="the first N queries (flip and ensemble)")
    parser.add_argument("--parts", nargs="+", default=list(PARTS),
                        choices=list(PARTS))
    args = parser.parse_args()
    import bench

    corpus, queries = bench.glove100_workload(
        np.random.default_rng(bench.SEED))
    with np.load(GT) as z:
        gt = z["gt"]
    nq = args.queries
    for name in args.parts:
        t0 = time.perf_counter()
        out = PARTS[name](corpus, queries[:nq], gt[:nq])
        print(json.dumps({"part": name, "n_queries": nq, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
