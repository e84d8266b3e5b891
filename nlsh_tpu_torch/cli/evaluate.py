"""Offline evaluation CLI: the multi-probe sweep (port of
:mod:`nlsh_tpu.cli.evaluate`):

    python3 -m nlsh_tpu_torch.cli.evaluate --model_path <base> \\
        --data_id <id> [--probe_mode flip] [--engine auto] [--device cuda]

Loads a saved model artifact, hashes the corpus and builds the index
once, then sweeps the number of probes ``n = 1..max_probes`` and reports
``(avg_n_candidates, recall)`` per probe count (the reference's
``eval.py``).  One batch of ``max_probes`` probe codes is drawn once, and
each sweep value ``n`` masks the probes at or after ``n`` down to the
hard code before the dedupe and the serve.  An ``n_tables`` artifact
sweeps the ensemble's probes per table instead.

``--engine`` takes either package's names: ``pallas-grouped`` /
``grouped`` (kernel K1), ``pallas-windowed`` / ``windowed`` (K3),
``pallas`` / ``fixed`` (K5), ``xla`` / ``gather``; ``auto`` is the
fixed-cap engine on the card for the serving metrics (the windowed
engine for an ensemble), else gather.
Everything runs on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from nlsh_tpu_torch.data import get_data_by_id
from nlsh_tpu_torch.index.bucket_table import build_bucket_table
from nlsh_tpu_torch.index.indexer import engine_from_jax, hash_corpus
from nlsh_tpu_torch.index.query import default_query_chunk, query_bucket_table
from nlsh_tpu_torch.index.serving import (
    serving_query,
    serving_query_grouped,
    serving_query_windowed,
)
from nlsh_tpu_torch.models.hashings import flip_probe_ids
from nlsh_tpu_torch.ops import packing
from nlsh_tpu_torch.ops.cuda.query_kernel import BLOCK_ROWS, serving_layout
from nlsh_tpu_torch.train.base import resolve_device
from nlsh_tpu_torch.utils.checkpoint import load_model
from nlsh_tpu_torch.utils.env import get_env
from nlsh_tpu_torch.utils.graphs import GraphCache
from nlsh_tpu_torch.utils.metrics import calculate_recall

_SERVING_METRICS = ("cosine", "euclidean", "sq_euclidean")


def nlsh_eval_argparse() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--data_id", type=str, required=True)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--max_probes", type=int, default=100)
    p.add_argument("--engine", default="auto", type=engine_from_jax,
                   help="auto, xla, pallas, pallas-grouped or "
                        "pallas-windowed, or the port's name of one "
                        "(gather, fixed, grouped, windowed)")
    p.add_argument("--probe_mode", default="sample",
                   choices=("sample", "flip"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json_out", type=str, default=None,
                   help="also write the sweep as JSON lines")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the index and the queries")
    return p


@torch.no_grad()
def sample_probe_codes(hashing, queries: torch.Tensor, max_probes: int,
                       generator: torch.Generator | None = None,
                       probe_mode: str = "sample",
                       uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """The whole probe batch, drawn once: ``(nq, max_probes)`` packed
    int32 ids, probe 0 the hard code.

    ``"sample"`` draws each other probe's bits as ``uniform < p``, what
    ``jax.random.bernoulli`` computes, with the uniforms from
    ``generator`` or given as ``uniforms`` ``(nq, max_probes - 1,
    bits)``.  ``"flip"`` enumerates the least-confident bit flips
    best-first (the head's own enumeration, not deduped), so the probes
    are nested prefixes and the sweep's masking applies unchanged."""
    p = hashing.probs(queries)
    if probe_mode == "flip":
        return flip_probe_ids(p, max_probes)
    if probe_mode != "sample":
        raise ValueError(f"unknown probe_mode {probe_mode!r} (sample|flip)")
    if uniforms is None:
        uniforms = torch.rand((queries.shape[0], max_probes - 1, p.shape[-1]),
                              generator=generator, device=p.device)
    hard = (p > 0.5).to(torch.int32)[:, None, :]
    sampled = (uniforms.to(p.device) < p[:, None, :]).to(torch.int32)
    return packing.pack_bits(torch.cat([hard, sampled], dim=1))


def resolve_engine(engine: str, device: torch.device, metric: str,
                   on_card: str = "fixed") -> str:
    """The port's name of ``engine`` (either package's name); ``auto`` is
    ``on_card`` on the card for the serving metrics (the JAX package's
    choice on its accelerator: the fixed-cap engine for one table, the
    windowed one for an ensemble), else gather."""
    engine = engine_from_jax(engine)
    if engine == "auto":
        return (on_card if device.type == "cuda"
                and metric in _SERVING_METRICS else "gather")
    return engine


def sweep_body(table, corpus: torch.Tensor, queries: torch.Tensor,
               raw: torch.Tensor, k: int, probe_budget: int, metric: str,
               engine: str):
    """The body of one sweep value on ``engine`` (a resolved name), the
    JAX package's ``_sweep_step``: ``body(n) -> (nq, k+1)`` int32
    ``[topk_ids | n_candidates]`` for a 0-d int32 ``n`` on the device, the
    probes of ``raw`` at or after ``n`` masked down to the hard code
    (probe 0), deduped, and served on a layout built once, with cap
    ``probe_budget``, in float32 (every engine at its static group
    bound, so nothing is read on the host)."""
    if engine == "gather":
        chunk = default_query_chunk(raw.shape[1], probe_budget,
                                    queries.shape[1])

        def serve(pid, pv):
            return query_bucket_table(
                table, corpus, queries, pid, pv, k=k,
                probe_budget=probe_budget, metric=metric, query_chunk=chunk)
    else:
        layout = serving_layout(
            table, corpus, metric=metric, cap=probe_budget,
            align={"grouped": BLOCK_ROWS, "windowed": 8}.get(engine))
        query = {"grouped": serving_query_grouped,
                 "windowed": serving_query_windowed,
                 "fixed": serving_query}[engine]

        def serve(pid, pv):
            return query(layout, queries, pid, pv, table.counts, k=k)

    probe = torch.arange(raw.shape[1], device=raw.device)[None, :]

    def body(n: torch.Tensor) -> torch.Tensor:
        pid, pv = packing.dedupe_codes(
            torch.where(probe < n, raw, raw[:, :1]))
        topk, _, n_cand = serve(pid, pv)
        return torch.cat([topk, n_cand[:, None]], dim=1)

    return body


def sweep_step(table, corpus: torch.Tensor, queries: torch.Tensor,
               raw: torch.Tensor, k: int, probe_budget: int, metric: str,
               engine: str):
    """One sweep on ``engine``: ``step(n) -> (nq, k+1)`` packed
    ``[topk_ids | n_candidates]`` of :func:`sweep_body` at the Python int
    ``n``, ONE replayed graph for every value (``n`` is filled on the
    device into the graph's input, as the JAX package traces it, so all
    values share one compilation), held in a cache of the step's own and
    dropped with it; on the CPU the body runs eagerly."""
    body = sweep_body(table, corpus, queries, raw, k, probe_budget, metric,
                      engine)
    graphs = GraphCache()
    n_dev = torch.zeros((), dtype=torch.int32, device=raw.device)

    @torch.no_grad()
    def step(n: int) -> torch.Tensor:
        n_dev.fill_(n)
        return graphs.run("sweep", body, (n_dev,))

    return step


@torch.no_grad()
def run_sweep(hashing, corpus, queries, ground_truth, k: int,
              max_probes: int = 100, metric: str = "cosine", seed: int = 0,
              probe_budget: int | None = None, engine: str = "auto",
              probe_mode: str = "sample", *,
              device, raw_codes=None) -> list[dict]:
    """The single-table sweep: a list of ``{n_probes, avg_n_candidates,
    recall}`` for ``n_probes = 1..max_probes``, one replay of the sweep's
    graph and one copy of its packed result per value (:func:`sweep_step`,
    whose graph goes with it at the end).  The probe budget (default) is the
    largest bucket, so no bucket is cut.  Sampled probes draw from a
    generator seeded with ``seed`` on ``device``; ``raw_codes`` ``(nq,
    max_probes)`` replaces the drawn batch."""
    device = resolve_device(device)
    hashing = hashing.to(device).eval()
    corpus = torch.as_tensor(corpus, dtype=torch.float32, device=device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=device)
    ground_truth = np.asarray(ground_truth)
    table = build_bucket_table(hash_corpus(hashing, corpus),
                               hashing.n_buckets)
    if probe_budget is None:
        probe_budget = max(table.max_count(), 1)
    if raw_codes is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        raw = sample_probe_codes(hashing, queries, max_probes, gen,
                                 probe_mode=probe_mode)
    else:
        raw = torch.as_tensor(np.array(raw_codes), dtype=torch.int32,
                              device=device)
    step = sweep_step(table, corpus, queries, raw, k, probe_budget, metric,
                      resolve_engine(engine, device, metric))
    results = []
    for n in range(1, max_probes + 1):
        packed = step(n).cpu().numpy()
        recall = calculate_recall(ground_truth[:, :k], packed[:, :-1],
                                  np.mean)
        results.append({"n_probes": n,
                        "avg_n_candidates": float(np.mean(packed[:, -1])),
                        "recall": float(recall)})
    return results


@torch.no_grad()
def run_sweep_multitable(hashings, corpus, queries, ground_truth, k: int,
                         n_tables: int, max_probes: int = 100,
                         metric: str = "cosine", seed: int = 0,
                         engine: str = "auto", probe_mode: str = "sample",
                         *, device) -> list[dict]:
    """The ensemble sweep: per-table probe count ``ht = 1..max_probes //
    n_tables``, so each step adds ``n_tables`` buckets to the union, as
    the single-table sweep adds one.  ``avg_n_candidates`` is the exact
    distinct union size (``MultiTableIndexer.exact_query_size``), counted
    on the very probes the query served: both draw from generators in
    the same state, seeded with ``seed`` anew for every ``ht``."""
    from nlsh_tpu_torch.parallel import MultiTableIndexer

    device = resolve_device(device)
    idx = MultiTableIndexer(hashings, corpus, device=device, metric=metric,
                            engine=resolve_engine(engine, device, metric,
                                                  on_card="windowed"))
    ground_truth = np.asarray(ground_truth)

    def gen():
        return torch.Generator(device=device).manual_seed(seed)

    results = []
    for ht in range(1, max(max_probes // n_tables, 1) + 1):
        topk, _ = idx.query(queries, k=k, hash_times=ht, generator=gen(),
                            probe_mode=probe_mode)
        n_cand = idx.exact_query_size(queries, hash_times=ht,
                                      generator=gen(), probe_mode=probe_mode)
        recall = calculate_recall(ground_truth[:, :k], topk, np.mean)
        results.append({"n_probes": ht * n_tables, "hash_times": ht,
                        "avg_n_candidates": float(np.mean(n_cand)),
                        "recall": float(recall)})
    return results


def main(argv: list[str] | None = None) -> list[dict]:
    args = nlsh_eval_argparse().parse_args(argv)
    device = resolve_device(args.device)
    model_path = args.model_path
    if not (os.path.exists(model_path)
            or os.path.exists(model_path + ".json")):
        model_path = os.path.join(
            get_env("NLSH_MODEL_SAVE_DIR",
                    os.path.join(tempfile.gettempdir(), "nlsh_models")),
            model_path)

    hashing = load_model(model_path, device=device)
    data = get_data_by_id(args.data_id, device=device).load()

    for suffix in (".json", ".msgpack"):
        if model_path.endswith(suffix):
            model_path = model_path[: -len(suffix)]
    with open(model_path + ".json") as f:
        n_tables = json.load(f).get("n_tables")

    common = dict(max_probes=args.max_probes, metric=data.metric,
                  seed=args.seed, engine=args.engine,
                  probe_mode=args.probe_mode, device=device)
    if n_tables and n_tables > 1:
        results = run_sweep_multitable(
            hashing, data.training, data.testing, data.ground_truth, args.k,
            n_tables, **common)
    else:
        results = run_sweep(hashing, data.training, data.testing,
                            data.ground_truth, args.k, **common)
    for r in results:
        print(r["avg_n_candidates"], r["recall"])
    if args.json_out:
        with open(args.json_out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return results


if __name__ == "__main__":
    main()
