"""Corpus-sharded bucket tables: the distributed inverted index.

Port of :mod:`nlsh_tpu.parallel.sharded_index`.  The corpus is padded to
a multiple of the mesh's global entry count D and split row-wise: shard
``s`` owns rows ``[s * n_local, (s + 1) * n_local)``.  Each shard hashes
its rows and builds a local CSR bucket table (padding rows get the
sentinel ``n_buckets``, so they count in no bucket).  A query is hashed
once, answered by every shard on its own serving layout (probe -> score
-> local top-k, the same engines as :class:`~nlsh_tpu_torch.index.
indexer.Indexer`), and the per-shard (score, global id) lists are merged
with one :func:`~nlsh_tpu_torch.parallel.mesh.all_gather` and a top-k
that keeps the lowest flat index (the lower shard) among equal scores,
as ``lax.top_k`` does; ``n_candidates`` is the :func:`psum` of the
shards' probed occupancies.  On a mesh of one device the whole serve
(hash, every shard's serve, merge, sum, pack) is one captured CUDA graph
replayed per batch, the JAX package's one jitted program
(``_serving_query_fn``, and ``_query_fn`` on the gather engine); see
:meth:`ShardedIndexer.query_async`.

Exactness: a hard hash partitions every shard's rows among the buckets,
so the union of the shards' candidates is the single-table candidate set,
and the top-k of the merged per-shard top-ks is the single-table top-k.

Layouts share one geometry across the shards, as the JAX package's
``shard_map`` needs: ``cap`` from the largest bucket of any shard
(whatever ``probe_budget`` is; the budget bounds only the gather
engine), rows padded to the largest shard's aligned size.  With
``layout_mode="host"`` the layouts are built in numpy and, on a
one-entry mesh serving a kernel engine, a numpy corpus never goes to the
device at all (the lazy corpus; the gather engine uploads it on use).
``"auto"`` means ``"device"``: the JAX package's row-count threshold
exists for its remote compiler and is not ported.  A global int8 scale
on the device-built layout is taken over the metric-extended rows of
the whole corpus, as the JAX package's host path does (its device path
takes it over cosine-normalised rows whatever the metric: the
reference's fault F1).
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch
from torch import nn

from nlsh_tpu_torch import native
from nlsh_tpu_torch.index.bucket_table import BucketTable, build_bucket_table
from nlsh_tpu_torch.index.indexer import (
    DTYPE_NAMES,
    ENGINE_TO_JAX,
    dtype_name,
    engine_from_jax,
    hash_corpus,
    hash_corpus_host,
)
from nlsh_tpu_torch.index.query import (
    default_query_chunk,
    query_bucket_table,
    smallest_k,
)
from nlsh_tpu_torch.index.serving import (
    _largest_k,
    serving_query,
    serving_query_grouped,
    serving_query_windowed,
)
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.parallel.mesh import Mesh, all_gather, process_index, psum
from nlsh_tpu_torch.utils.fingerprint import (
    check_fingerprint,
    corpus_fingerprint,
)
from nlsh_tpu_torch.utils.graphs import GraphCache
from nlsh_tpu_torch.utils.profiling import span_stats

_SERVING_METRICS = ("cosine", "euclidean", "sq_euclidean")
_SERVES = {"grouped": serving_query_grouped,
           "windowed": serving_query_windowed, "fixed": serving_query}


def merge_top(scores, ids, k: int, largest: bool = True):
    """Merge per-shard top lists ``(D, nq, k')`` into each query's top
    ``k`` ids, ``(nq, k)`` int32: the lists laid side by side (shard 0's
    first), the best ``k`` with the lowest flat index first among equal
    values, ``-1`` under a non-finite value."""
    d, nq, kk = scores.shape
    flat_s = scores.permute(1, 0, 2).reshape(nq, d * kk)
    flat_i = ids.permute(1, 0, 2).reshape(nq, d * kk)
    top, arg = _largest_k(flat_s, k) if largest else smallest_k(flat_s, k)
    return torch.where(torch.isfinite(top), torch.gather(flat_i, 1, arg),
                       -1).to(torch.int32)


class ShardedIndexer:
    """Build-once, query-many inverted index sharded over a 1-D mesh.

    Args:
      hashing: a hashing module; a copy lives on each entry's device.
      corpus: ``(n, d)`` float32 rows, numpy or a tensor; padded to a
        multiple of the mesh's global entry count and split row-wise.
      mesh: a :class:`~nlsh_tpu_torch.parallel.mesh.Mesh`; queries are
        hashed and answers merged on its first entry's device.
      metric, probe_budget, engine, serving_dtype, block_rows,
        int8_scale: as :class:`~nlsh_tpu_torch.index.indexer.Indexer`
        (engine names of either package; ``"auto"`` is ``"grouped"``).
      layout_mode: ``"device"`` (= ``"auto"``) or ``"host"`` (numpy
        layouts; the lazy corpus on a one-entry mesh).
      tables: ready CSR arrays ``(row_ids (D * n_local,), starts (D, NB),
        counts (D, NB))`` (the persistence path): nothing is hashed.
    """

    @torch.no_grad()
    def __init__(self, hashing: nn.Module, corpus, mesh: Mesh, *,
                 metric: str = "cosine", probe_budget: int | None = None,
                 engine: str = "auto", serving_dtype=torch.float32,
                 layout_mode: str = "auto", block_rows: int | None = None,
                 tables=None, int8_scale: str = "per_row"):
        qk._check_scale_mode(int8_scale)
        if layout_mode not in ("auto", "device", "host"):
            raise ValueError(f"unknown layout_mode {layout_mode!r}")
        if serving_dtype not in DTYPE_NAMES.values():
            raise ValueError(f"unsupported serving dtype {serving_dtype}")
        self.mesh = mesh
        self.metric = metric
        self.serving_dtype = serving_dtype
        self.layout_mode = layout_mode
        self.block_rows = block_rows
        self.int8_scale = int8_scale
        self.device = mesh.devices[0]
        self.engine = engine  # setter: validates, resolves "auto"
        self._layouts = None
        self._layouts_sig = None
        self._graphs = GraphCache()  # the fused serve's, of these layouts
        self._hashings = {}
        self.hashing = self._hashing_on(self.device, hashing)
        n_dev = mesh.global_size()
        self.n_shards = n_dev
        self.n_real = int(corpus.shape[0])
        self.n_local = -(-self.n_real // n_dev)
        self.n_padded = self.n_local * n_dev
        pad = self.n_padded - self.n_real
        # the caller's rows, for the fingerprint and the host builders
        self._source = corpus
        self._corpus_host = None
        if isinstance(corpus, np.ndarray):
            self._corpus_host = np.asarray(corpus, np.float32)
            if pad:
                self._corpus_host = np.pad(self._corpus_host,
                                           ((0, pad), (0, 0)))
        # one entry serving a kernel engine from host layouts never reads
        # the raw corpus on the device
        lazy = (n_dev == 1 and self._corpus_host is not None
                and layout_mode == "host" and self._engine != "gather")
        self._corpus_local = None if lazy else self._shard_rows(corpus)

        nb = self.hashing.n_buckets
        if tables is not None:
            row_ids, starts, counts = (np.asarray(t) for t in tables)
            self._tables = [BucketTable(*(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                for a in (row_ids[g * self.n_local:(g + 1) * self.n_local],
                          starts[g], counts[g])))
                for g, dev in self._entries()]
        elif lazy:
            codes = hash_corpus_host(self.hashing, self._corpus_host,
                                     device=self.device)
            self._tables = [BucketTable(*(
                torch.from_numpy(a).to(self.device)
                for a in native.build_csr(codes, nb)))]
        else:
            self._tables = []
            for (g, dev), rows in zip(self._entries(), self._corpus_local):
                codes = hash_corpus(self._hashing_on(dev), rows)
                gid = g * self.n_local + torch.arange(self.n_local,
                                                      device=dev)
                # padding rows get the sentinel: they count in no bucket
                codes = torch.where(gid < self.n_real, codes, nb)
                self._tables.append(build_bucket_table(codes, nb))
        # every shard's counts, (D, NB), on the first entry's device
        self.counts = all_gather([t.counts for t in self._tables])
        if probe_budget is None:
            probe_budget = int(self.counts.max())
        self.probe_budget = max(int(probe_budget), 1)

    # -- placement -------------------------------------------------------------

    def _entries(self):
        """``(global shard, device)`` of each of this process's entries."""
        return [(self.mesh.global_index(i), dev)
                for i, dev in enumerate(self.mesh.devices)]

    def _hashing_on(self, dev, hashing=None) -> nn.Module:
        """The hashing module on ``dev`` (one copy per device)."""
        if dev not in self._hashings:
            src = hashing if hashing is not None else self.hashing
            if self._hashings:
                src = copy.deepcopy(src)
            self._hashings[dev] = src.to(dev).eval()
        return self._hashings[dev]

    def _shard_rows(self, corpus) -> list[torch.Tensor]:
        """Each local entry's ``n_local`` rows (zero-padded past
        ``n_real``) as float32 on its device."""
        out = []
        for g, dev in self._entries():
            lo = g * self.n_local
            hi = min(lo + self.n_local, self.n_real)
            rows = torch.as_tensor(corpus[lo:hi], dtype=torch.float32)
            rows = rows.to(dev)
            if hi - lo < self.n_local:
                rows = torch.cat([rows, torch.zeros(
                    (self.n_local - max(hi - lo, 0), rows.shape[1]),
                    dtype=torch.float32, device=dev)])
            out.append(rows)
        return out

    def _local_host(self, e: int, g: int) -> np.ndarray:
        """Entry ``e``'s (global shard ``g``'s) rows as a numpy array."""
        if self._corpus_host is not None:
            return self._corpus_host[g * self.n_local:(g + 1) * self.n_local]
        return self._corpus_local[e].cpu().numpy()

    # -- the CSR tables, all shards ---------------------------------------------

    @property
    def row_ids(self) -> torch.Tensor:
        """``(D * n_local,)`` int32: each shard's local row ids in turn."""
        return all_gather([t.row_ids for t in self._tables]).reshape(-1)

    @property
    def starts(self) -> torch.Tensor:
        """``(D, NB)`` int32 bucket starts of every shard."""
        return all_gather([t.starts for t in self._tables])

    # -- engine ------------------------------------------------------------------

    @property
    def engine(self) -> str:
        return self._engine

    @engine.setter
    def engine(self, value: str):
        """Validates (either package's names), resolves ``"auto"``, and
        drops the per-shard layouts on a change of engine: their bucket
        alignment is the engine's."""
        value = engine_from_jax(value)
        if value == "auto":
            value = "grouped" if self.metric in _SERVING_METRICS else "gather"
        old = getattr(self, "_engine", None)
        self._engine = value
        if old is not None and value != old:
            self._layouts = None
            self._graphs.clear()

    # -- persistence -------------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist every shard's CSR table and the serving knobs (NOT the
        corpus or the model) as the JAX package's npz archive.  Every
        process takes part (the tables are gathered); process 0 writes."""
        row_ids = self.row_ids.cpu().numpy()
        starts = self.starts.cpu().numpy()
        if process_index() != 0:
            return
        np.savez_compressed(
            path, row_ids=row_ids, starts=starts,
            counts=self.counts.cpu().numpy(),
            meta=np.array([
                self.metric, str(self.probe_budget),
                ENGINE_TO_JAX[self._engine], dtype_name(self.serving_dtype),
                str(self.block_rows), self.layout_mode, str(self.n_shards),
                str(self.n_real),
                corpus_fingerprint(self._source, n_real=self.n_real),
                self.int8_scale,
            ]),
        )

    @classmethod
    def load(cls, path: str, hashing: nn.Module, corpus,
             mesh: Mesh) -> "ShardedIndexer":
        """Rebuild from :meth:`save` output (of either package) without
        hashing.  Refuses a mesh of another global size and a corpus that
        does not match the saved row count and fingerprint."""
        with np.load(path, allow_pickle=False) as z:
            meta = [str(v) for v in z["meta"]]
            # archives from before the int8_scale knob were global-scale
            int8_scale = meta[9] if len(meta) > 9 else "global"
            (metric, probe_budget, engine, sdtype, block_rows,
             layout_mode, n_dev, n_real, digest) = meta[:9]
            if int(n_dev) != mesh.global_size():
                raise ValueError(
                    f"saved tables are sharded {n_dev}-way, mesh has "
                    f"{mesh.global_size()} device(s)")
            if int(n_real) != corpus.shape[0]:
                raise ValueError(
                    f"saved index is over {n_real} corpus rows, got "
                    f"{corpus.shape[0]}")
            check_fingerprint(digest, corpus, n_real=int(n_real))
            tables = (z["row_ids"], z["starts"], z["counts"])
        return cls(hashing, corpus, mesh, metric=metric,
                   probe_budget=int(probe_budget),
                   engine=engine_from_jax(engine),
                   serving_dtype=DTYPE_NAMES[sdtype], layout_mode=layout_mode,
                   block_rows=None if block_rows == "None" else int(block_rows),
                   tables=tables, int8_scale=int8_scale)

    # -- observability -----------------------------------------------------------

    def n_buckets_used(self) -> int:
        """Occupied (shard, bucket) cells: each shard owns a slice of
        every bucket."""
        return int((self.counts > 0).sum())

    def occupancy_std(self) -> float:
        counts = self.counts.cpu().numpy().reshape(-1)
        occ = counts[counts > 0]
        return float(occ.std()) if occ.size else 0.0

    # -- serving layouts, one per shard with one shared geometry ----------------

    def _int8_scales(self, host: bool):
        """Per local entry its int8 scale: the shard's per-row scales, or
        the one global scale (the max over every shard of each shard's,
        which is the scale of the whole corpus: division by 127 is
        monotone)."""
        metric, mode = self.metric, self.int8_scale
        if host:
            scales = [qk.ext_scales_host(self._local_host(e, g), metric, mode)
                      for e, (g, _) in enumerate(self._entries())]
            if mode == "per_row":
                return scales
            peak = all_gather([torch.tensor(s, dtype=torch.float32,
                                            device=dev)
                               for s, (_, dev) in zip(scales,
                                                      self._entries())]).max()
            return [float(peak)] * len(scales)
        scales = [qk.ext_scales(rows, metric, mode)
                  for rows in self._corpus_local]
        if mode == "per_row":
            return scales
        peak = all_gather(scales).max()
        return [peak.to(dev) for _, dev in self._entries()]

    @torch.no_grad()
    def _build_layouts(self) -> list[qk.ServingLayout]:
        sig = (self._engine, self.serving_dtype, self.block_rows,
               self.layout_mode, self.int8_scale)
        if self._layouts is not None and self._layouts_sig == sig:
            return self._layouts
        self._layouts = None
        self._graphs.clear()  # they read the old layouts
        br = qk._br(self.block_rows)
        counts_np = self.counts.cpu().numpy()
        cap = qk.round_cap(int(counts_np.max()), br)
        # grouped: block-aligned starts; windowed: dense 8-row starts;
        # fixed-cap: cap-aligned
        align = {"grouped": br, "windowed": 8}.get(self._engine, cap)
        n_aligned = qk._round_up(max(qk.aligned_rows(c, cap, align=align)
                                     for c in counts_np), br)
        total_blocks = int(max((-(-np.minimum(c, cap) // br)).sum()
                               for c in counts_np))
        dtype, metric = self.serving_dtype, self.metric
        host = self.layout_mode == "host"
        scales = self._int8_scales(host) if dtype == torch.int8 else \
            [None] * self.mesh.size
        layouts = []
        for e, (g, dev) in enumerate(self._entries()):
            t = self._tables[e]
            if host:
                data, row_map, starts, norms, scale_rows = \
                    qk.layout_arrays_host(
                        t.row_ids.cpu().numpy(), t.starts.cpu().numpy(),
                        t.counts.cpu().numpy(), self._local_host(e, g),
                        cap=cap, n_aligned=n_aligned, metric=metric,
                        dtype=dtype, align=align, scale=scales[e])
                data = qk._host_data_tensor(data, dtype, dev)
                row_map, starts = (torch.from_numpy(a).to(dev)
                                   for a in (row_map, starts))
                norms, scale_rows = (None if a is None else
                                     torch.from_numpy(a).to(dev)
                                     for a in (norms, scale_rows))
                scale = scales[e]
                if scale is not None and scale_rows is None:
                    scale = torch.tensor(scale, dtype=torch.float32,
                                         device=dev)
            else:
                data, row_map, starts, norms, scale_rows = qk.layout_arrays(
                    t.row_ids, t.starts, t.counts, self._corpus_local[e],
                    cap=cap, n_aligned=n_aligned, metric=metric, dtype=dtype,
                    align=align, scale=scales[e])
                scale = scales[e]
            layouts.append(qk.ServingLayout(
                data=data, row_map=row_map, starts=starts, counts=t.counts,
                cap=cap, d_pad=data.shape[1], align=align, metric=metric,
                total_blocks=total_blocks, norms=norms, block_rows=br,
                scale=scale_rows if scale_rows is not None else scale))
        self._layouts, self._layouts_sig = layouts, sig
        return layouts

    # -- query -------------------------------------------------------------------

    def _sync_bound(self, queries, uniforms, hash_times: int,
                    probe_mode: str) -> int | None:
        """The opt-in exact group bound of a one-entry grouped serve
        (``NLSH_SHARDED_SYNC_BOUND``): the probes hashed and read on the
        host before the serve, so off by default; worth it only where the
        static bound is several-fold loose."""
        if (self._engine != "grouped" or self.n_shards != 1
                or os.environ.get("NLSH_SHARDED_SYNC_BOUND", "0") == "0"):
            return None
        layout = self._build_layouts()[0]
        probe_ids, probe_valid = self.hashing.hash(
            queries, n_probes=hash_times, probe_mode=probe_mode,
            uniforms=uniforms)
        br = layout.br
        g_exact = qk.grouped_exact_bound(layout.counts, probe_ids,
                                         probe_valid, layout.cap, qk.GROUP_W,
                                         block_rows=br)
        return qk.round_group_override(g_exact, qk.grouped_static_bound(
            probe_ids.numel(), layout.cap // br, layout.total_blocks,
            qk.GROUP_W))

    def _merge(self, parts, k: int, largest: bool) -> torch.Tensor:
        """The entries' ``(local top ids, values, candidates)`` merged
        across the mesh: global ids (``+ g * n_local``), one
        :func:`merge_top` of the gathered lists and the :func:`psum` of
        the candidates, packed ``(nq, k + 1)`` int32."""
        ids = [torch.where(top >= 0, top + g * self.n_local, -1)
               for (g, _), (top, _, _) in zip(self._entries(), parts)]
        merged = merge_top(all_gather([p[1] for p in parts]),
                           all_gather(ids), k, largest)
        n_cand = psum([p[2] for p in parts])
        return torch.cat([merged, n_cand[:, None].to(torch.int32)], dim=1)

    def _serve_body(self, k: int, hash_times: int, probe_mode: str,
                    g_override: int | None = None, plain: bool = False):
        """``body(queries, uniforms)`` of one serve on the kernel engines
        (the JAX package's ``_serving_query_fn``): the probe hash (sampled
        probes from the given uniforms), each entry's serve of its layout
        (with the kernels' plain versions if ``plain``; ``g_override``
        sizes a one-entry grouped serve's group table), and on more than
        one entry the merge, packed ``(nq, k + 1)`` int32."""
        serve = _SERVES[self._engine]

        def body(queries, uniforms):
            probe_ids, probe_valid = self.hashing.hash(
                queries, n_probes=hash_times, probe_mode=probe_mode,
                uniforms=uniforms)
            layouts = self._build_layouts()
            if self.n_shards == 1:  # one shard: its answer is the answer
                lay = layouts[0]
                kw = {} if g_override is None else \
                    {"g_total_override": g_override}
                top, _, cand = serve(lay, queries, probe_ids, probe_valid,
                                     lay.counts, k=k, plain=plain, **kw)
                return torch.cat([top, cand[:, None]], dim=1)
            return self._merge([serve(
                lay, *(t.to(dev) for t in (queries, probe_ids, probe_valid)),
                lay.counts, k=k, plain=plain)
                for (_, dev), lay in zip(self._entries(), layouts)], k,
                largest=True)

        return body

    @torch.no_grad()
    def query_async(self, queries, k: int = 10, hash_times: int = 10,
                    generator: torch.Generator | None = None,
                    query_chunk: int | None = None,
                    probe_mode: str = "sample", plain: bool = False):
        """Enqueue a multi-probe query against every shard: returns the
        packed ``(nq, k + 1)`` int32 ``[topk_ids | n_candidates]`` on the
        mesh's first device, for :meth:`fetch`.  Sampled probes draw from
        ``generator`` (default: one seeded 0), before the serve.

        On a mesh of one device (:meth:`Mesh.on_one_device`) the grouped,
        windowed and fixed-cap engines serve through one captured graph of
        :meth:`_serve_body` per batch shape, replayed on the card (on the
        CPU the body runs eagerly); the graphs are dropped with the
        layouts they read.  The gather engine (and every metric the
        kernel engines do not serve) replays a graph of its own there
        (:meth:`_gather`).  ``plain=True`` (the kernels' plain PyTorch
        versions) and meshes over several devices or processes run
        eagerly."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        if generator is None and probe_mode == "sample" and hash_times > 1:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if self._engine == "gather" or self.metric not in _SERVING_METRICS:
            return self._gather(queries, k, hash_times, generator,
                                query_chunk, probe_mode)
        uniforms = self.hashing.probe_uniforms(
            queries.shape[0], hash_times, generator, probe_mode,
            device=self.device)
        bound = self._sync_bound(queries, uniforms, hash_times, probe_mode)
        body = self._serve_body(k, hash_times, probe_mode, bound, plain)
        if plain or not self.mesh.on_one_device():
            return body(queries, uniforms)
        key = (self._engine, k, hash_times, probe_mode, self.serving_dtype,
               bound)
        return self._graphs.run(key, body, (queries, uniforms),
                                holds=tuple(self._build_layouts()))

    def _gather_body(self, k: int, hash_times: int, probe_mode: str,
                     query_chunk: int):
        """``body(queries, uniforms)`` of one gather serve on every shard:
        the probe hash (sampled probes from the given uniforms), each
        shard's :func:`query_bucket_table` chunk loop and the merge,
        packed ``(nq, k + 1)`` int32."""
        def body(queries, uniforms):
            probe_ids, probe_valid = self.hashing.hash(
                queries, n_probes=hash_times, probe_mode=probe_mode,
                uniforms=uniforms)
            return self._merge([query_bucket_table(
                table, rows,
                *(t.to(dev) for t in (queries, probe_ids, probe_valid)), k=k,
                probe_budget=self.probe_budget, metric=self.metric,
                query_chunk=query_chunk)
                for (_, dev), table, rows in zip(
                    self._entries(), self._tables, self._corpus_local)], k,
                largest=False)

        return body

    def _gather(self, queries, k: int, hash_times: int, generator,
                query_chunk, probe_mode: str) -> torch.Tensor:
        """The gather engine on every shard, merged: packed ``(nq, k + 1)``
        int32.  The lazy corpus is uploaded first, on the first call; then
        on a mesh of one device the serve is one replayed graph of
        :meth:`_gather_body` per batch shape, keyed as the kernel engines'
        serves are, plus the probe budget and the query chunk (eagerly on
        meshes over several devices or processes)."""
        if self._corpus_local is None:  # the lazy corpus, on use
            self._corpus_local = self._shard_rows(self._corpus_host)
        if query_chunk is None:
            query_chunk = default_query_chunk(
                hash_times, self.probe_budget, queries.shape[1])
        uniforms = self.hashing.probe_uniforms(
            queries.shape[0], hash_times, generator, probe_mode,
            device=self.device)
        body = self._gather_body(k, hash_times, probe_mode, query_chunk)
        if not self.mesh.on_one_device():
            return body(queries, uniforms)
        key = ("gather", k, hash_times, probe_mode, self.probe_budget,
               query_chunk)
        return self._graphs.run(key, body, (queries, uniforms),
                                holds=(*self._tables, *self._corpus_local))

    @staticmethod
    def fetch(result) -> tuple[np.ndarray, np.ndarray]:
        """A :meth:`query_async` result on the host: ONE copy of the
        packed array, split into ``(topk_ids (nq, k), n_candidates
        (nq,))``."""
        arr = result.cpu().numpy()
        return arr[:, :-1], arr[:, -1]

    def serve_stats(self) -> dict:
        """As :meth:`Indexer.serve_stats
        <nlsh_tpu_torch.index.Indexer.serve_stats>`: the layer marks of
        the first device (a sharded serve marks no layers of its own) and
        this index's graphs' counters."""
        return {**span_stats(self.device), "graphs": self._graphs.stats()}

    def query(self, queries, k: int = 10, hash_times: int = 10,
              generator: torch.Generator | None = None,
              query_chunk: int | None = None, probe_mode: str = "sample",
              plain: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Multi-probe query against every shard: ``(topk_ids (nq, k),
        n_candidates (nq,))`` numpy arrays of global row ids, merged
        across the shards."""
        return self.fetch(self.query_async(
            queries, k=k, hash_times=hash_times, generator=generator,
            query_chunk=query_chunk, probe_mode=probe_mode, plain=plain))
