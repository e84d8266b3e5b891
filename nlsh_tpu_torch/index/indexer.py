"""High-level Indexer: hash a corpus, build the bucket table, answer queries.

Port of :mod:`nlsh_tpu.index.indexer` (constructor, lazy serving layout,
``query``/``query_async``/``fetch``).  Engines: ``"grouped"`` (the
grouped CUDA kernels K1/K2; ``"auto"`` picks it on every device),
``"windowed"`` (the dense-window kernels K3/K4, on an 8-row-aligned
layout), ``"fixed"`` (the fixed-cap kernel K5, the JAX package's
``"pallas"``, on the cap-aligned layout the grouped engine uses) and
``"gather"`` (gather + exact rerank, the JAX package's ``"xla"``).
Serving layouts are f32, bf16 or int8 (per-row or global scale).
``add``/``remove``/``compact`` and ``save``/``load`` are still to be
ported (ROADMAP.md Queue 1, item 5).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nlsh_tpu_torch.index.bucket_table import build_bucket_table
from nlsh_tpu_torch.index.query import default_query_chunk, query_bucket_table
from nlsh_tpu_torch.index.serving import (
    serving_query,
    serving_query_grouped,
    serving_query_windowed,
)
from nlsh_tpu_torch.ops.cuda.query_kernel import (
    _check_scale_mode,
    serving_layout,
)


@torch.no_grad()
def hash_corpus(hashing: nn.Module, corpus: torch.Tensor, device=None,
                chunk: int = 65536) -> torch.Tensor:
    """Hard-hash every corpus row on ``device`` (default: the corpus's),
    ``chunk`` rows at a time so activation memory stays bounded.
    Returns ``(n,)`` int32 bucket ids."""
    device = corpus.device if device is None else torch.device(device)
    return torch.cat([
        hashing.hash_hard(corpus[s: s + chunk].to(device))
        for s in range(0, corpus.shape[0], chunk)
    ])


class Indexer:
    """Build-once, query-many inverted-list index on ``device``.

    Args:
      hashing: a hashing module (:mod:`nlsh_tpu_torch.models.hashings`);
        it is moved to ``device``.
      corpus: ``(n, d)`` float32 rows (numpy or tensor).
      device: where the index lives and queries run.
      metric: rerank metric in the original space.
      probe_budget: max rows served per probed bucket (the grouped
        engine's cap); ``None`` uses the largest bucket (exact).
      engine: ``"auto"`` (= ``"grouped"``), ``"grouped"``, ``"windowed"``,
        ``"fixed"`` or ``"gather"``.
      serving_dtype: ``torch.float32``, ``torch.bfloat16`` or
        ``torch.int8`` layout rows.
      block_rows: rows per grouped-engine block (default 512).
      int8_scale: ``"per_row"`` (one scale per stored row) or
        ``"global"`` (one for the corpus); int8 layouts only.
    """

    ENGINES = ("auto", "grouped", "windowed", "fixed", "gather")

    def __init__(self, hashing: nn.Module, corpus, *, device,
                 metric: str = "cosine", probe_budget: int | None = None,
                 engine: str = "auto", serving_dtype=torch.float32,
                 block_rows: int | None = None, int8_scale: str = "per_row"):
        _check_scale_mode(int8_scale)
        self.device = torch.device(device)
        self.hashing = hashing.to(self.device).eval()
        self.corpus = torch.as_tensor(corpus, dtype=torch.float32,
                                      device=self.device)
        self.metric = metric
        self.engine = engine
        self.serving_dtype = serving_dtype
        self.block_rows = block_rows
        self.int8_scale = int8_scale
        self._layout = None
        self._layout_sig = None
        self.table = build_bucket_table(hash_corpus(self.hashing, self.corpus),
                                        self.hashing.n_buckets)
        if probe_budget is None:
            probe_budget = self.table.max_count()
        self.probe_budget = max(int(probe_budget), 1)

    @property
    def engine(self) -> str:
        return self._engine

    @engine.setter
    def engine(self, value: str):
        if value not in self.ENGINES:
            raise ValueError(f"unknown engine {value!r}")
        self._engine = value

    @property
    def layout(self):
        """Lazily built serving layout, rebuilt when a knob it depends on
        (bucket alignment — 8 rows for the windowed engine, else the cap —
        dtype, probe budget, block rows, int8 scale mode) changed since
        the last build."""
        align = 8 if self.engine == "windowed" else None
        sig = (align, self.serving_dtype, int(self.probe_budget),
               self.block_rows, self.int8_scale)
        if self._layout is None or self._layout_sig != sig:
            self._layout = serving_layout(
                self.table, self.corpus, metric=self.metric,
                cap=self.probe_budget, dtype=self.serving_dtype,
                align=align, block_rows=self.block_rows,
                scale_mode=self.int8_scale)
            self._layout_sig = sig
        return self._layout

    def n_buckets_used(self) -> int:
        return self.table.n_nonempty()

    def occupancy_std(self) -> float:
        return self.table.occupancy_std()

    @torch.no_grad()
    def query_async(self, queries, k: int = 10, hash_times: int = 10,
                    generator: torch.Generator | None = None,
                    query_chunk: int | None = None,
                    probe_mode: str = "sample", plain: bool = False):
        """Enqueue a multi-probe query on the device without waiting:
        returns ``(topk_ids, n_candidates)`` device tensors for
        :meth:`fetch`.  Sampled probes draw from ``generator`` (default:
        a fresh one seeded 0 on the index's device).  ``plain=True``
        serves the grouped, windowed or fixed-cap engine with the
        kernels' plain PyTorch versions (the reference the kernels are
        checked against)."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        if generator is None and probe_mode == "sample" and hash_times > 1:
            generator = torch.Generator(device=self.device).manual_seed(0)
        probe_ids, probe_valid = self.hashing.hash(
            queries, n_probes=hash_times, generator=generator,
            probe_mode=probe_mode)
        if self.engine != "gather":
            serve = {"windowed": serving_query_windowed,
                     "fixed": serving_query}.get(self.engine,
                                                 serving_query_grouped)
            ids, _, n_cand = serve(self.layout, queries, probe_ids,
                                   probe_valid, self.table.counts, k=k,
                                   plain=plain)
            return ids, n_cand
        if query_chunk is None:
            query_chunk = default_query_chunk(hash_times, self.probe_budget,
                                              queries.shape[1])
        ids, _, n_cand = query_bucket_table(
            self.table, self.corpus, queries, probe_ids, probe_valid, k=k,
            probe_budget=self.probe_budget, metric=self.metric,
            query_chunk=query_chunk)
        return ids, n_cand

    @staticmethod
    def fetch(result) -> tuple[np.ndarray, np.ndarray]:
        """``(topk_ids (nq, k), n_candidates (nq,))`` as numpy arrays."""
        ids, n_cand = result
        return ids.cpu().numpy(), n_cand.cpu().numpy()

    def query(self, queries, k: int = 10, hash_times: int = 10,
              generator: torch.Generator | None = None,
              query_chunk: int | None = None, probe_mode: str = "sample",
              plain: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Multi-probe query: ``(topk_ids (nq, k), n_candidates (nq,))``
        as numpy arrays."""
        return self.fetch(self.query_async(
            queries, k=k, hash_times=hash_times, generator=generator,
            query_chunk=query_chunk, probe_mode=probe_mode, plain=plain))
