"""The program's learned-LSH index under test: one table
(``nlsh_tpu_torch.index.Indexer``) or an ensemble of tables
(``nlsh_tpu_torch.parallel.MultiTableIndexer``), built through the
public constructors with the committed params read by the program's own
reader, and answering host numpy batches through ``query``.

The configuration's ``hashing`` object gives the heads (``head``,
``encoder``, ``hidden``, ``w0``, ``w0_initial``, ``hash_size``,
``n_tables``, and ``params_key``, the key of a stacked tree), its
``serving`` object the index's knobs (``engine``, ``probe_budget``,
``serving_dtype``, which is float32, the precision the reference
judges, ``hash_times``, ``probe_mode``, and ``calibrate``: the
ensemble's windowed group bound sized on the deployment's test queries
at set-up).
"""

from __future__ import annotations

import numpy as np
import torch

from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.parallel import MultiTableIndexer
from nlsh_tpu_torch.utils.checkpoint import (
    params_from_jax,
    read_msgpack,
    stacked_params_from_jax,
)

class System:
    """One index of the program; a batch goes through the index's
    ``query_async`` (:meth:`submit`) and ``fetch`` (:meth:`fetch`), the
    two calls its ``query`` makes."""

    def __init__(self, cfg: dict, params_path: str, corpus: np.ndarray,
                 test_queries: np.ndarray, device):
        h, s = cfg["hashing"], cfg["serving"]
        if s["serving_dtype"] != "float32":
            raise ValueError(f"serving_dtype {s['serving_dtype']!r}: the "
                             "reference judges float32 layouts only")

        def head():
            enc = get_encoder(h["encoder"], corpus.shape[1], h["hidden"],
                              w0=h["w0"], w0_initial=h["w0_initial"])
            return get_hashing(h["head"], enc, h["hash_size"])

        tree = read_msgpack(params_path)
        metric = cfg["deployment"]["metric"]
        if h["n_tables"] == 1:
            self.entry = Indexer(
                params_from_jax(head(), tree), corpus, device=device,
                metric=metric, probe_budget=s["probe_budget"],
                engine=s["engine"], serving_dtype=torch.float32)
        else:
            heads = stacked_params_from_jax(head, tree[h["params_key"]])
            if len(heads) != h["n_tables"]:
                raise ValueError(f"{len(heads)} tables in the params, "
                                 f"{h['n_tables']} configured")
            self.entry = MultiTableIndexer(
                heads, corpus, device=device, metric=metric,
                probe_budget=s["probe_budget"], engine=s["engine"],
                serving_dtype=torch.float32)
            if s.get("calibrate"):
                self.entry.calibrate(test_queries, hash_times=s["hash_times"],
                                     probe_mode=s["probe_mode"])
        self.kw = dict(hash_times=s["hash_times"], probe_mode=s["probe_mode"])

    def submit(self, queries: np.ndarray, k: int):
        """Send a host batch: the index's pending result."""
        return self.entry.query_async(queries, k=k, **self.kw)

    def fetch(self, pending):
        """``(ids (nq, k), n_candidates (nq,))`` numpy of a pending
        result."""
        return self.entry.fetch(pending)

    def close(self) -> None:
        self.entry = None
