"""High-level Indexer: hash a corpus, build the bucket table, answer queries.

Port of :mod:`nlsh_tpu.index.indexer`: constructor, lazy serving layout
(built on the device or, ``layout_mode="host"``, in numpy),
``query``/``query_async``/``fetch``, the incremental updates
(``add``/``remove``/``compact``) and ``save``/``load`` in the JAX
package's npz format, so an index saved by either package loads in the
other.  Engines: ``"grouped"`` (the grouped CUDA kernels K1/K2;
``"auto"`` picks it on every device), ``"windowed"`` (the dense-window
kernels K3/K4, on an 8-row-aligned layout), ``"fixed"`` (the fixed-cap
kernel K5, the JAX package's ``"pallas"``, on the cap-aligned layout
the grouped engine uses) and ``"gather"`` (gather + exact rerank, the
JAX package's ``"xla"``).  Serving layouts are f32, bf16 or int8
(per-row or global scale).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nlsh_tpu_torch.index.bucket_table import BucketTable, build_bucket_table
from nlsh_tpu_torch.index.query import (
    default_query_chunk,
    query_bucket_table,
    smallest_k,
)
from nlsh_tpu_torch.index.serving import (
    serving_query,
    serving_query_grouped,
    serving_query_windowed,
)
from nlsh_tpu_torch.ops import distances as D
from nlsh_tpu_torch.ops.cuda.query_kernel import (
    _check_scale_mode,
    serving_layout,
    serving_layout_host,
)
from nlsh_tpu_torch.utils.fingerprint import (
    check_fingerprint,
    corpus_fingerprint,
)

# a saved index holds the JAX package's engine and dtype names
ENGINE_TO_JAX = {"auto": "auto", "gather": "xla", "fixed": "pallas",
                 "grouped": "pallas-grouped", "windowed": "pallas-windowed"}
DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int8": torch.int8}


def engine_from_jax(name: str) -> str:
    """The port's name of an engine given by either package's name; the
    retired ``"pallas-compact"`` serves as ``"grouped"`` (the same
    block-aligned layout)."""
    if name == "pallas-compact":
        return "grouped"
    for ours, theirs in ENGINE_TO_JAX.items():
        if name in (ours, theirs):
            return ours
    raise ValueError(f"unknown engine {name!r}")


def dtype_name(dtype) -> str:
    for name, known in DTYPE_NAMES.items():
        if known == dtype:
            return name
    raise ValueError(f"unsupported serving dtype {dtype}")


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


@torch.no_grad()
def hash_corpus_host(hashing: nn.Module, corpus_np: np.ndarray, *, device,
                     chunk: int = 262_144) -> np.ndarray:
    """:func:`hash_corpus` for a HOST-resident numpy corpus: ships one
    chunk to ``device`` (where ``hashing`` lives) at a time, so the
    device never holds the raw corpus.  Returns numpy ``(n,)`` int32
    bucket ids."""
    device = torch.device(device)
    out = np.empty((corpus_np.shape[0],), np.int32)
    for s in range(0, corpus_np.shape[0], chunk):
        block = torch.from_numpy(
            np.ascontiguousarray(corpus_np[s: s + chunk], np.float32))
        out[s: s + chunk] = hashing.hash_hard(block.to(device)).cpu().numpy()
    return out


@torch.no_grad()
def _merge_fresh(corpus, fresh, queries, base_ids, n_cand, k: int,
                 metric: str):
    """Merge the table's top-k with an exact scan of the fresh-row
    buffer: gather the base winners' vectors, score them and every
    buffered row, take the combined top-k.  Buffered rows get ids
    ``n0 + i``; padded base slots (id ``-1``) rank last and come out as
    ``-1``.  Among equal distances the lowest position wins (base
    winners before buffered rows), as ``lax.top_k`` decides it in the JAX
    package: a stable sort."""
    pairwise = D.get_metric(metric)["pairwise"]
    n0, m = corpus.shape[0], fresh.shape[0]
    nq = queries.shape[0]
    base_vecs = corpus[torch.clamp(base_ids.long(), 0, n0 - 1)]  # (nq, k, d)
    d_base = pairwise(queries[:, None, :], base_vecs)[:, 0]      # (nq, k)
    d_base = torch.where(base_ids >= 0, d_base, torch.inf)
    d_fresh = pairwise(queries, fresh)                           # (nq, m)
    all_d = torch.cat([d_base, d_fresh], dim=1)
    fresh_ids = (n0 + torch.arange(m, dtype=torch.int32,
                                   device=queries.device)).expand(nq, m)
    all_ids = torch.cat([base_ids.to(torch.int32), fresh_ids], dim=1)
    top_d, arg = smallest_k(all_d, k)
    top = torch.gather(all_ids, 1, arg)
    top = torch.where(torch.isfinite(top_d), top, -1).to(torch.int32)
    return top, n_cand + m


@torch.no_grad()
def _drop_deleted(ids, deleted_sorted, k: int):
    """Filter tombstoned ids out of an over-fetched top list, keeping
    score order (rows are already sorted by score, so a stable partition
    by deleted-ness preserves ranking).  Returns the first ``k``
    survivors, ``-1``-padded."""
    pos = torch.clamp(torch.searchsorted(deleted_sorted, ids), 0,
                      deleted_sorted.shape[0] - 1)
    dead = (deleted_sorted[pos] == ids) | (ids < 0)
    order = torch.argsort(dead.to(torch.int8), dim=1, stable=True)[:, :k]
    top = torch.gather(ids, 1, order)
    return torch.where(torch.gather(dead, 1, order), -1, top)


class Indexer:
    """Build-once, query-many inverted-list index on ``device``, with
    incremental inserts and deletes.

    Args:
      hashing: a hashing module (:mod:`nlsh_tpu_torch.models.hashings`);
        it is moved to ``device``.
      corpus: ``(n, d)`` float32 rows (numpy or tensor).
      device: where the index lives and queries run.
      metric: rerank metric in the original space.
      probe_budget: max rows served per probed bucket (the grouped
        engine's cap); ``None`` uses the largest bucket (exact) and
        follows the table over :meth:`compact`.
      engine: ``"auto"`` (= ``"grouped"``), ``"grouped"``, ``"windowed"``,
        ``"fixed"`` or ``"gather"``.
      serving_dtype: ``torch.float32``, ``torch.bfloat16`` or
        ``torch.int8`` layout rows.
      layout_mode: ``"device"`` builds the serving layout with torch ops
        on ``device``, ``"host"`` in numpy (only finished arrays are
        shipped); ``"auto"`` means ``"device"``.
      block_rows: rows per grouped-engine block (default 512).
      table: a ready :class:`BucketTable` (the persistence path): the
        corpus is then not hashed.
      int8_scale: ``"per_row"`` (one scale per stored row) or
        ``"global"`` (one for the corpus); int8 layouts only.
    """

    ENGINES = ("auto", "grouped", "windowed", "fixed", "gather")

    def __init__(self, hashing: nn.Module, corpus, *, device,
                 metric: str = "cosine", probe_budget: int | None = None,
                 engine: str = "auto", serving_dtype=torch.float32,
                 layout_mode: str = "auto", block_rows: int | None = None,
                 table: BucketTable | None = None,
                 int8_scale: str = "per_row"):
        _check_scale_mode(int8_scale)
        if layout_mode not in ("auto", "device", "host"):
            raise ValueError(f"unknown layout_mode {layout_mode!r}")
        self.device = torch.device(device)
        self.hashing = hashing.to(self.device).eval()
        self.corpus = torch.as_tensor(corpus, dtype=torch.float32,
                                      device=self.device)
        self.metric = metric
        self.engine = engine
        self.serving_dtype = serving_dtype
        self.layout_mode = layout_mode
        self.block_rows = block_rows
        self.int8_scale = int8_scale
        self._layout = None
        self._layout_sig = None
        if table is None:
            table = build_bucket_table(
                hash_corpus(self.hashing, self.corpus), self.hashing.n_buckets)
        self.table = BucketTable(*(t.to(self.device) for t in table))
        self._fresh = None    # incremental-insert buffer (see :meth:`add`)
        self._deleted = None  # tombstoned ids, sorted (see :meth:`remove`)
        self._budget_user = probe_budget is not None
        if probe_budget is None:
            probe_budget = self.table.max_count()
        self.probe_budget = max(int(probe_budget), 1)

    # -- incremental inserts and deletes ------------------------------------

    def add(self, rows) -> None:
        """Insert new corpus rows WITHOUT rebuilding the table: they go
        to a fresh-row buffer that every query scans exactly and merges
        with the table's top-k, so an insert is served by the very next
        query.  New rows get ids ``n0 + i`` in insertion order.  The scan
        is O(buffer) per query batch: :meth:`compact` folds a grown
        buffer into the table and the serving layout."""
        if self.metric not in D.METRICS:
            raise ValueError(
                f"incremental inserts need a registered metric, "
                f"got {self.metric!r}"
            )
        rows = torch.as_tensor(rows, dtype=torch.float32, device=self.device)
        self._fresh = rows if self._fresh is None else torch.cat(
            [self._fresh, rows])

    @property
    def n_fresh(self) -> int:
        return 0 if self._fresh is None else int(self._fresh.shape[0])

    def remove(self, ids) -> None:
        """Tombstone corpus rows (buffered rows included): queries
        over-fetch ``k + next_pow2(#deleted)`` from the engine and drop
        tombstones on the device, so ranking stays exact without a
        rebuild.  :meth:`compact` rebuilds the table without them (ids
        stay stable; the corpus slots are not reclaimed)."""
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        hi = self.corpus.shape[0] + self.n_fresh
        if ids.size and (ids.min() < 0 or ids.max() >= hi):
            raise ValueError(f"ids out of range [0, {hi})")
        base = self._deleted if self._deleted is not None else \
            np.empty((0,), np.int32)
        self._deleted = np.unique(np.concatenate([base, ids]))

    @property
    def n_deleted(self) -> int:
        return 0 if self._deleted is None else int(self._deleted.shape[0])

    def compact(self) -> None:
        """Fold the fresh-row buffer into the corpus and rebuild the CSR
        table WITHOUT tombstoned rows (they get an out-of-range sentinel
        code the table build drops, so no bucket lists them).  Ids are
        stable: buffered rows already answered as ``n0 + i``, and deleted
        slots stay allocated."""
        if self._fresh is None and self._deleted is None:
            return
        if self._fresh is not None:
            self.corpus = torch.cat([self.corpus, self._fresh])
        self._fresh = None
        self._layout = None
        codes = hash_corpus(self.hashing, self.corpus)
        if self._deleted is not None:
            dead = torch.from_numpy(self._deleted).to(self.device).long()
            codes[dead] = self.hashing.n_buckets  # sentinel: dropped
            self._deleted = None
        self.table = build_bucket_table(codes, self.hashing.n_buckets)
        # a user-set budget persists; the default tracks the new table
        if not self._budget_user:
            self.probe_budget = max(self.table.max_count(), 1)

    # -- persistence: skip the corpus re-hash on a serving restart ----------

    def save(self, path: str) -> None:
        """Persist the built bucket table and the serving knobs (NOT the
        corpus or the model: the caller owns those) as the JAX package's
        npz archive, with its engine and dtype names.  ``np.savez``
        appends ``.npz`` to a path that lacks it.  The corpus is
        fingerprinted so :meth:`load` refuses a table built over other
        data."""
        if self._fresh is not None or self._deleted is not None:
            raise ValueError(
                "pending inserts/deletes: compact() before save() so the "
                "persisted table reflects every update"
            )
        np.savez_compressed(
            path,
            row_ids=self.table.row_ids.cpu().numpy(),
            starts=self.table.starts.cpu().numpy(),
            counts=self.table.counts.cpu().numpy(),
            meta=np.array([
                self.metric, str(self.probe_budget),
                ENGINE_TO_JAX[self._engine], dtype_name(self.serving_dtype),
                str(self.block_rows), self.layout_mode,
                str(self.corpus.shape[0]), str(self.corpus.shape[1]),
                corpus_fingerprint(self.corpus),
                self.int8_scale,
            ]),
        )

    @classmethod
    def load(cls, path: str, hashing: nn.Module, corpus, *,
             device) -> "Indexer":
        """Rebuild an :class:`Indexer` from :meth:`save` output (of this
        package or of the JAX package) without re-hashing the corpus.
        Raises if ``corpus`` does not match the shape and fingerprint the
        table was built over."""
        with np.load(path, allow_pickle=False) as z:
            meta = [str(v) for v in z["meta"]]
            # archives from before the int8_scale knob served global-scale
            # int8, so load them that way
            int8_scale = meta[9] if len(meta) > 9 else "global"
            (metric, probe_budget, engine, sdtype, block_rows,
             layout_mode, n_rows, dim, digest) = meta[:9]
            if (int(n_rows), int(dim)) != tuple(corpus.shape):
                raise ValueError(
                    f"saved index is over a {n_rows}x{dim} corpus, "
                    f"got {tuple(corpus.shape)}"
                )
            check_fingerprint(digest, corpus)
            table = BucketTable(*(torch.from_numpy(z[name])
                                  for name in ("row_ids", "starts", "counts")))
        return cls(
            hashing, corpus, device=device, metric=metric,
            probe_budget=int(probe_budget), engine=engine_from_jax(engine),
            serving_dtype=DTYPE_NAMES[sdtype], layout_mode=layout_mode,
            block_rows=None if block_rows == "None" else int(block_rows),
            table=table, int8_scale=int8_scale,
        )

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
        dtype, probe budget, block rows, layout mode, int8 scale mode)
        changed since the last build; :meth:`compact` drops it."""
        align = 8 if self.engine == "windowed" else None
        sig = (align, self.serving_dtype, int(self.probe_budget),
               self.block_rows, self.layout_mode, self.int8_scale)
        if self._layout is None or self._layout_sig != sig:
            kw = dict(metric=self.metric, cap=self.probe_budget,
                      dtype=self.serving_dtype, align=align,
                      block_rows=self.block_rows, scale_mode=self.int8_scale)
            if self.layout_mode == "host":
                self._layout = serving_layout_host(
                    self.table, self.corpus, device=self.device, **kw)
            else:
                self._layout = serving_layout(self.table, self.corpus, **kw)
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
        checked against).

        With tombstones pending (:meth:`remove`) the engine over-fetches
        ``k + next_pow2(#deleted)`` and the tombstones are dropped on the
        device: ranking stays exact, and ``n_candidates`` still counts
        tombstoned candidates until :meth:`compact`."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        m = self.n_deleted
        k_eff = k if m == 0 else k + (1 << (m - 1).bit_length())
        ids, n_cand = self._query_raw(queries, k_eff, hash_times, generator,
                                      query_chunk, probe_mode, plain)
        if m:
            dead = torch.from_numpy(self._deleted).to(self.device)
            ids = _drop_deleted(ids, dead, k)
        return ids, n_cand

    def _query_raw(self, queries, k: int, hash_times: int, generator,
                   query_chunk, probe_mode: str, plain: bool):
        """The engine's top ``k`` merged with the fresh-row buffer."""
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
        else:
            if query_chunk is None:
                query_chunk = default_query_chunk(
                    hash_times, self.probe_budget, queries.shape[1])
            ids, _, n_cand = query_bucket_table(
                self.table, self.corpus, queries, probe_ids, probe_valid, k=k,
                probe_budget=self.probe_budget, metric=self.metric,
                query_chunk=query_chunk)
        if self._fresh is None:
            return ids, n_cand
        return _merge_fresh(self.corpus, self._fresh, queries, ids, n_cand,
                            k=k, metric=self.metric)

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
