"""Serving CLI — load a model, build (or load) the index, answer queries.

Port of :mod:`nlsh_tpu.cli.serve`:

    python3 -m nlsh_tpu_torch.cli.serve --model_path <base> \\
        --data_id <id> [--index_path idx.npz] [--loop] [--device cuda]

It loads a saved model artifact
(:func:`nlsh_tpu_torch.utils.checkpoint.load_model`), builds the indexer
— single-table or multi-table (detected from the artifact) — restoring
the built tables from ``--index_path`` when that file exists and saving
them there otherwise, then serves a query batch through the pipelined
``query_async`` loop and reports recall/query_size/QPS as one JSON line;
``--loop`` answers JSONL requests from stdin instead.  Everything runs on
``--device`` (default ``cuda``); ``--shards N`` splits the corpus of a
single table over N devices of that kind.  Engines go by the port's names
(``grouped``, ``windowed``, ``fixed``, ``gather``, ``auto``); the JAX
package's names are accepted as aliases.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from nlsh_tpu_torch.data import get_data_by_id
from nlsh_tpu_torch.index.indexer import DTYPE_NAMES, engine_from_jax
from nlsh_tpu_torch.utils.checkpoint import load_model
from nlsh_tpu_torch.utils.metrics import calculate_recall

_DTYPES = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}


def nlsh_serve_argparse() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model_path", type=str, required=True,
                   help="checkpoint base path (json + msgpack artifact)")
    p.add_argument("--data_id", type=str, required=True,
                   help="corpus dataset id (corpus = its training split)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the index and the queries")
    p.add_argument("--queries", type=str, default=None,
                   help=".npy/.npz of query vectors; default: the "
                        "dataset's testing split")
    p.add_argument("--index_path", type=str, default=None,
                   help="load the built tables from here if present, "
                        "else build and save here")
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--hash_times", type=int, default=10)
    p.add_argument("--probe_mode", default="sample",
                   choices=["sample", "flip"])
    p.add_argument("--engine", default="auto", type=engine_from_jax,
                   help="auto, grouped, windowed, fixed or gather (or the "
                        "JAX package's name of one)")
    p.add_argument("--serving_dtype", default="f32", choices=sorted(_DTYPES),
                   help="corpus storage dtype of the serving layout (int8 "
                        "supports cosine and euclidean; scores come out "
                        "in dequantised units)")
    p.add_argument("--int8_scale", default="per_row",
                   choices=["per_row", "global"],
                   help="int8 quantisation granularity: one scale per row "
                        "or one global scale")
    p.add_argument("--shards", type=int, default=0,
                   help="shard the corpus over N devices of --device's "
                        "kind (a single table)")
    p.add_argument("--pipeline", type=int, default=4,
                   help="in-flight query batches")
    p.add_argument("--batch", type=int, default=0,
                   help="serving batch size (0 = whole query set)")
    p.add_argument("--output", type=str, default=None,
                   help="write topk ids + n_candidates as .npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--loop", action="store_true",
                   help="persistent serving loop: read JSONL requests "
                        "{'id': ..., 'queries': [[...], ...]} from stdin, "
                        "stream one JSON answer per request to stdout "
                        "(pipelined via query_async; batches padded to "
                        "powers of two), exit on EOF with a stats line")
    return p


def _load_queries(args, data):
    if args.queries is None:
        return np.asarray(data.testing), np.asarray(data.ground_truth)
    if args.queries.endswith(".npz"):
        with np.load(args.queries) as z:
            return np.asarray(z[z.files[0]], np.float32), None
    return np.asarray(np.load(args.queries), np.float32), None


def _build_indexer(args, hashing, corpus, metric: str = "cosine"):
    """The indexer of ``hashing`` (one module, or a list: an ensemble)
    over ``corpus`` on ``args.device`` (with ``--shards N``, a
    :class:`~nlsh_tpu_torch.parallel.ShardedIndexer` over N devices of
    its kind): restored from ``args.index_path`` when that file exists,
    else built and saved there."""
    dtype = DTYPE_NAMES[_DTYPES[args.serving_dtype]]
    if args.shards:
        from nlsh_tpu_torch.parallel import ShardedIndexer, make_mesh

        if isinstance(hashing, list):
            raise ValueError("--shards shards the corpus of one table; the "
                             "artifact is an ensemble")
        mesh = make_mesh(args.shards, axis="shard",
                         platform=torch.device(args.device).type)
        if args.index_path and os.path.exists(args.index_path):
            return ShardedIndexer.load(args.index_path, hashing, corpus, mesh)
        idx = ShardedIndexer(hashing, corpus, mesh, metric=metric,
                             engine=args.engine, serving_dtype=dtype,
                             int8_scale=args.int8_scale)
        if args.index_path:
            idx.save(args.index_path)
        return idx
    if isinstance(hashing, list):
        from nlsh_tpu_torch.parallel import MultiTableIndexer as cls
    else:
        from nlsh_tpu_torch.index import Indexer as cls
    if args.index_path and os.path.exists(args.index_path):
        return cls.load(args.index_path, hashing, corpus, device=args.device)
    idx = cls(hashing, corpus, device=args.device, metric=metric,
              engine=args.engine, serving_dtype=dtype,
              int8_scale=args.int8_scale)
    if args.index_path:
        idx.save(args.index_path)
    return idx


def _generator(args) -> torch.Generator:
    """The sampled probes' generator: seeded anew for every batch, so a
    batch's probes do not depend on what was served before it (as one
    PRNG key serves every batch in the JAX package)."""
    return torch.Generator(device=args.device).manual_seed(args.seed)


def serve_loop(args, idx, extra, dim, stdin=None, stdout=None) -> dict:
    """Persistent query loop: one JSONL request per line on ``stdin``,
    one JSON answer per request on ``stdout``.

    Requests: ``{"id": <any>, "queries": [[f32 x dim], ...]}``.
    Answers: ``{"id", "topk_ids", "n_candidates", "latency_ms"}`` in
    request order (malformed requests answer ``{"id", "error"}`` in the
    same stream position).  Dispatch is pipelined through
    ``query_async`` (up to ``--pipeline`` batches in flight, so device
    work overlaps stdin parsing and response writes), but the loop never
    *withholds* an answer to fill the pipeline: whenever stdin has no
    data ready, pending answers flush at once, so a client that waits
    for each answer before sending the next request is served without
    deadlock.  Query batches are padded to the next power of two (min 8)
    so a shape-diverse stream meets few distinct shapes.  EOF flushes
    pending work and emits a final ``{"stats": ...}`` line with latency
    percentiles and, under ``serve``, the index's ``serve_stats()``: the
    device milliseconds a batch by layer, the guard's fallbacks and the
    graphs' captures, replays, evictions and nodes.
    """
    import select
    import sys

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    try:
        stdin_fd = stdin.fileno()  # real pipe/tty: idle-flush via select
    except Exception:
        stdin_fd = None  # StringIO etc.: batch semantics (flush at EOF)
    pending = []  # (request id, t_received, n_real, async result | error)
    latencies = []
    n_queries = 0
    t_start = time.perf_counter()

    def _emit(entry):
        rid, t_recv, n_real, res = entry
        if n_real is None:  # parse/validation error, in stream order
            json.dump({"id": rid, "error": res}, stdout)
            stdout.write("\n")
            stdout.flush()
            return
        top, n_cand = idx.fetch(res)
        ms = (time.perf_counter() - t_recv) * 1000
        latencies.append(ms)
        json.dump({
            "id": rid,
            "topk_ids": top[:n_real].tolist(),
            "n_candidates": n_cand[:n_real].astype(int).tolist(),
            "latency_ms": round(ms, 2),
        }, stdout)
        stdout.write("\n")
        stdout.flush()

    while True:
        if pending and stdin_fd is not None:
            ready, _, _ = select.select([stdin_fd], [], [], 0.0)
            if not ready:
                # client is waiting on us, not the other way round
                _emit(pending.pop(0))
                continue
        line = stdin.readline()
        if not line:
            break
        line = line.strip()
        if not line:
            continue
        rid = None
        try:
            req = json.loads(line)
            rid = req.get("id") if isinstance(req, dict) else None
            q = np.asarray(req["queries"], np.float32)
            if q.ndim != 2 or q.shape[1] != dim:
                raise ValueError(f"expected (n, {dim}) queries, "
                                 f"got {q.shape}")
        except Exception as e:
            pending.append((rid, time.perf_counter(), None, repr(e)))
            continue
        n_real = q.shape[0]
        padded = 1 << max((n_real - 1).bit_length(), 3)
        if padded > n_real:
            q = np.pad(q, ((0, padded - n_real), (0, 0)))
        n_queries += n_real
        res = idx.query_async(q, k=args.k, hash_times=args.hash_times,
                              generator=_generator(args), **extra)
        pending.append((rid, time.perf_counter(), n_real, res))
        while len(pending) > args.pipeline:
            _emit(pending.pop(0))
    while pending:
        _emit(pending.pop(0))

    wall = time.perf_counter() - t_start
    lat = np.asarray(latencies) if latencies else np.zeros((1,))
    stats = {
        "stats": {
            "batches": len(latencies),
            "n_queries": n_queries,
            "wall_s": round(wall, 3),
            "qps": round(n_queries / wall, 1) if wall > 0 else 0.0,
            "latency_ms_p50": round(float(np.percentile(lat, 50)), 2),
            "latency_ms_p95": round(float(np.percentile(lat, 95)), 2),
            "latency_ms_max": round(float(lat.max()), 2),
            "engine": idx.engine,
            "serve": idx.serve_stats(),
        }
    }
    json.dump(stats, stdout)
    stdout.write("\n")
    stdout.flush()
    return stats["stats"]


def main(argv: list[str] | None = None) -> dict:
    args = nlsh_serve_argparse().parse_args(argv)
    hashing = load_model(args.model_path, device=args.device)

    data = get_data_by_id(args.data_id, device=args.device).load()
    corpus = np.asarray(data.training)
    queries_np, gt = _load_queries(args, data)
    extra = {"probe_mode": args.probe_mode}

    t0 = time.perf_counter()
    idx = _build_indexer(args, hashing, corpus, metric=data.metric)
    build_s = time.perf_counter() - t0

    if args.loop:
        return serve_loop(args, idx, extra, corpus.shape[1])
    queries = torch.as_tensor(queries_np, dtype=torch.float32,
                              device=args.device)
    nq = queries.shape[0]
    bs = args.batch or nq
    batches = [queries[s: s + bs] for s in range(0, nq, bs)]

    def dispatch(b):
        return idx.query_async(b, k=args.k, hash_times=args.hash_times,
                               generator=_generator(args), **extra)

    # warm up on the first batch shape (and the tail shape if any): the
    # kernels build at their first launch
    idx.fetch(dispatch(batches[0]))
    if batches[-1].shape != batches[0].shape:
        idx.fetch(dispatch(batches[-1]))

    t0 = time.perf_counter()
    outs, pending = [], []
    for b in batches:
        pending.append(dispatch(b))
        if len(pending) > args.pipeline:
            outs.append(idx.fetch(pending.pop(0)))
    outs.extend(idx.fetch(p) for p in pending)
    serve_s = time.perf_counter() - t0

    top = np.concatenate([o[0] for o in outs])
    n_cand = np.concatenate([o[1] for o in outs])
    result = {
        "n_queries": int(nq),
        "qps": round(nq / serve_s, 1),
        "query_size": round(float(n_cand.mean()), 1),
        "build_s": round(build_s, 2),
        "engine": idx.engine,
        "k": args.k,
        "hash_times": args.hash_times,
    }
    if gt is not None:
        result["recall_at_k"] = round(
            float(calculate_recall(gt[:, : args.k], top, np.mean)), 4)
    if args.output:
        np.savez(args.output, topk_ids=top, n_candidates=n_cand)
        result["output"] = args.output
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
