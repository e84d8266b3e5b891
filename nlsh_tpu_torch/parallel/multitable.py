"""Multi-table (L hashings) ensembles, on one device or table-sharded.

Port of :mod:`nlsh_tpu.parallel.multitable`.  ``L``
hashings of one architecture (one ``nn.Module`` per table, e.g. from
:func:`nlsh_tpu_torch.utils.checkpoint.stacked_params_from_jax`) each
build a CSR bucket table over the same corpus.  A query probes every
table; the union of candidates is answered by one of four engines:

* ``"windowed"`` (``"auto"`` for the serving metrics): ONE flat serving
  layout over ``L * NB`` buckets (table ``t``'s rows start at
  ``t * n_aligned``), dense 8-row-aligned, served by the windowed engine
  (kernels K3/K4) in one call for all tables.  The group table is sized
  by :meth:`MultiTableIndexer.calibrate`'s bound when the batch's exact
  need (one device reduction) fits it, else by the static bound, a
  branch the replayed graph takes on the card, so no batch ever drops
  candidates.
* ``"grouped"``: the same flat layout block-aligned, served by the
  grouped engine (K1/K2) with the exact host-computed group bound.
* ``"fixed"`` (the JAX package's ``"pallas"``): the flat layout
  cap-aligned, served by the fixed-cap engine (K5).
* ``"gather"`` (the JAX package's ``"xla"``): the candidate ids of all
  tables gathered, deduped by id, reranked exactly.  The independent
  check of the two above.

Cross-table duplicates (one corpus row found through several tables,
scored bit-identically) are collapsed by :meth:`_dedupe_topk` after
fetching ``k * L``; int8 layouts (one scale per corpus row, the same
in every table, or one global scale) leave every engine's scores in
dequantised units, which that collapse needs.  ``n_candidates`` is the
SUMMED per-table probed occupancy on the windowed, grouped and
fixed-cap engines and the exact DISTINCT count on the gather engine and
from :meth:`exact_query_size`.  ``save``/``load`` keep the stacked CSR
tables in the JAX package's npz format.

With a ``mesh`` (:class:`~nlsh_tpu_torch.parallel.mesh.Mesh`, ``L``
divisible by its global entry count D) the tables are sharded: entry
``d`` holds tables ``[d * lc, (d + 1) * lc)`` (``lc = L / D``) in a flat
layout of its own on its device and answers its tables' candidates;
the per-entry lists are gathered and merged with the same duplicate
collapse (on a mesh of one device, on the windowed, fixed-cap and gather
engines, in one captured graph per batch shape, as without a mesh).  The
merged ids equal the unsharded ensemble's; ``n_candidates`` is the psum
of the per-entry counts, so on the gather engine it is an upper bound of the distinct
count when one row is a candidate on several entries (exchanging whole
candidate sets would cost more than the rerank it counts).  Every
process holds every table's CSR arrays and modules (queries are hashed
on the mesh's first device), so
:meth:`MultiTableIndexer.exact_query_size`, ``calibrate`` and ``save``
behave as without a mesh.

``layout_mode="host"`` builds the stacked layouts in numpy (the JAX
package's host-built stack, which it takes for corpora of 2M rows or
more), and then keeps a numpy corpus off the device (the lazy corpus:
tables are hashed a chunk at a time; the gather engine uploads it on
use).  ``"auto"`` means ``"device"``: the JAX package's row-count
threshold exists for its TPU's memory and remote compiler and is not
ported.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from nlsh_tpu_torch.index.bucket_table import build_bucket_table
from nlsh_tpu_torch.index.indexer import (
    DTYPE_NAMES,
    ENGINE_TO_JAX,
    dtype_name,
    engine_from_jax,
    hash_corpus,
    hash_corpus_host,
    repeat_generator,
)
from nlsh_tpu_torch.index.query import smallest_k
from nlsh_tpu_torch.index.serving import (
    _largest_k,
    serving_query,
    serving_query_grouped,
    serving_query_windowed,
)
from nlsh_tpu_torch.ops import distances as D
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.parallel.mesh import Mesh, all_gather, psum
from nlsh_tpu_torch.utils.fingerprint import (
    check_fingerprint,
    corpus_fingerprint,
)
from nlsh_tpu_torch.utils.graphs import DEFAULT, GraphCache, cond
from nlsh_tpu_torch.utils.profiling import mark, span, span_stats

_GATHER_BUDGET_BYTES = 256 * 1024 * 1024
_SERVING_METRICS = ("cosine", "euclidean", "sq_euclidean")
_CAL_MARGIN = 1.1  # calibrate's headroom over the batch's exact need


def init_multi_table(hashing: nn.Module, n_tables: int,
                     generator: torch.Generator) -> list[nn.Module]:
    """``n_tables`` independent hashings of ``hashing``'s architecture:
    copies of it, each drawn from ``generator`` in turn (the JAX
    package's stacked ``init_multi_table``, one module per table)."""
    return [copy.deepcopy(hashing).init(generator) for _ in range(n_tables)]


def _mt_query_chunk(L: int, n_probes: int, budget: int, dim: int) -> int:
    per_query = max(L * n_probes * budget * dim * 4, 1)
    return int(max(4, min(512, _GATHER_BUDGET_BYTES // per_query)))


class _FlatGeometry(NamedTuple):
    """What a windowed group count reads of a flat layout, without its
    rows: the flat bucket starts and counts, cap, rows, block rows."""

    starts: torch.Tensor
    counts: torch.Tensor
    cap: int
    n_rows: int
    br: int


def _windowed_needed_groups(layout, gp, gv) -> torch.Tensor:
    """The exact group count of a windowed serve of the flat probes
    ``(gp, gv)`` on ``layout`` (a :class:`qk.ServingLayout` or a
    :class:`_FlatGeometry`): one device reduction, a 0-d tensor."""
    br = layout.br
    return qk.windowed_needed_groups(
        layout.starts, layout.counts, gp, gv, layout.cap,
        max_sub=layout.cap // br + 1, group_q=qk.GROUP_W,
        n_windows=-(-layout.n_rows // br) + 1, block_rows=br)


def _windowed_needed(layout, gp, gv) -> int:
    """:func:`_windowed_needed_groups` read on the host (one int)."""
    return int(_windowed_needed_groups(layout, gp, gv))


def _table_uniforms(hashings, nq: int, hash_times: int,
                    generator: torch.Generator | None, probe_mode: str,
                    device):
    """The uniforms of every table's sampled probes, ``(L, nq, P - 1,
    w)``, or None where nothing is sampled: one generator per table,
    seeded from ``generator`` (default: seeded 0) by one ``randint`` read
    on the host, as the ensemble has always drawn them."""
    if hash_times <= 1 or probe_mode != "sample":
        return None
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    seeds = torch.randint(0, 2 ** 62, (len(hashings),), generator=generator,
                          device=generator.device).tolist()
    draws = [h.probe_uniforms(nq, hash_times,
                              torch.Generator(device=device).manual_seed(s),
                              probe_mode, device=device)
             for h, s in zip(hashings, seeds)]
    return None if draws[0] is None else torch.stack(draws)


def _table_probes(hashings, queries, hash_times: int, probe_mode: str,
                  uniforms):
    """Per-table probe ids / validity ``(L, nq, P)``, sampled probes from
    ``uniforms`` (:func:`_table_uniforms`)."""
    out = [h.hash(queries, n_probes=hash_times, probe_mode=probe_mode,
                  uniforms=None if uniforms is None else uniforms[t])
           for t, h in enumerate(hashings)]
    return (torch.stack([ids for ids, _ in out]),
            torch.stack([v for _, v in out]))


def _flat(pids, pvalid, n_buckets: int):
    """``(Lc, nq, P)`` per-table probes -> ``(nq, Lc*P)`` bucket ids of
    the flat ``Lc * NB`` bucket space."""
    L, nq, n_probes = pids.shape
    offs = torch.arange(L, dtype=torch.int32, device=pids.device)
    gp = (pids.permute(1, 0, 2) + (offs * n_buckets)[None, :, None])
    return (gp.reshape(nq, L * n_probes).to(torch.int32),
            pvalid.permute(1, 0, 2).reshape(nq, L * n_probes))


def _mt_engine(engine: str) -> str:
    engine = engine_from_jax(engine)
    if engine not in ("windowed", "grouped", "fixed"):
        raise ValueError(f"the fused ensemble serve has no {engine!r} engine "
                         "(windowed|grouped|fixed)")
    return engine


def _mt_serve_body(hashings, layout, *, k: int, hash_times: int,
                   engine: str, n_rows: int, g_override: int | None,
                   probe_mode: str):
    """``body(queries, uniforms)`` of one fused ensemble serve: every
    table's probe hash, the flat probes, the engine's serve of ``k * L``,
    the duplicate collapse and the pack ``[topk_ids | n_candidates]``,
    ``(nq, k+1)`` int32.  A windowed serve at a given ``g_override``
    (the calibrated count) is GUARDED as the JAX package's is: the
    batch's exact group need is computed on the device and
    :func:`~nlsh_tpu_torch.utils.graphs.cond` serves at ``g_override``
    where it fits, else at the static bound (in a graph: two conditional
    nodes, decided on the card), so no batch drops candidates.  The body
    marks its layers: ``hash`` (every table and the flat probes), ``prep``
    (the guard's group count, then the engine's), ``score``, ``merge``
    (the engine's merge, the collapse and the pack) and ``end``; the
    static-bound branch opens with the count-only ``bound``."""
    L, n_buckets = len(hashings), hashings[0].n_buckets

    def body(queries, uniforms):
        mark("hash", queries)
        pids, pvalid = _table_probes(hashings, queries, hash_times,
                                     probe_mode, uniforms)
        gp, gv = _flat(pids, pvalid, n_buckets)
        k_fetch = min(k * L, hash_times * L * layout.cap)
        if engine == "windowed":
            def windowed(g):
                return serving_query_windowed(
                    layout, queries, gp, gv, layout.counts, k=k_fetch,
                    row_k=k, g_total_override=g)

            def static_bound():
                mark("bound", queries)
                return windowed(None)

            if g_override is None:
                ids, scores, n_cand = windowed(None)
            else:
                mark("prep", queries)
                need = _windowed_needed_groups(layout, gp, gv)
                ids, scores, n_cand = cond(need <= g_override,
                                           lambda: windowed(g_override),
                                           static_bound)
        elif engine == "grouped":
            ids, scores, n_cand = serving_query_grouped(
                layout, queries, gp, gv, layout.counts, k=k_fetch, row_k=k,
                g_total_override=g_override)
        else:
            ids, scores, n_cand = serving_query(layout, queries, gp, gv,
                                                layout.counts, k=k_fetch)
        merged, _ = MultiTableIndexer._dedupe_topk(ids, scores, k, n_rows)
        packed = torch.cat([merged, n_cand[:, None]], dim=1)
        mark("end", queries)
        return packed

    return body


def _fused_mt_async(hashings, layout, queries, uniforms, *, k: int,
                    hash_times: int, engine: str, n_rows: int,
                    g_override: int | None, probe_mode: str,
                    repeats: int | None, graphs: GraphCache) -> torch.Tensor:
    """The replay (on the CPU: the eager run) of the fused ensemble serve
    of ``queries`` on given ``uniforms``, one batch (``repeats`` None) or
    ``repeats`` in one graph: the packed result, final on the device (a
    guarded windowed batch takes its branch inside the replay)."""
    one = _mt_serve_body(hashings, layout, k=k, hash_times=hash_times,
                         engine=engine, n_rows=n_rows, g_override=g_override,
                         probe_mode=probe_mode)
    if repeats is None:
        body = one
    else:
        def body(qs, us):
            return torch.stack([
                one(qs[i] if qs.dim() == 3 else torch.roll(qs, i * 1009, 0),
                    None if us is None else us[i])
                for i in range(repeats)])

    key = ("mt_serve", tuple(id(h) for h in hashings), id(layout), k,
           hash_times, engine, n_rows, g_override, probe_mode, repeats)
    return graphs.run(key, body, (queries, uniforms),
                      holds=(*hashings, layout))


@torch.no_grad()
def _fused_mt_serve(hashings, layout, queries,
                    generator: torch.Generator | None = None, *, k: int,
                    hash_times: int, engine: str, n_rows: int,
                    g_override: int | None = None,
                    probe_mode: str = "sample",
                    graphs: GraphCache | None = None) -> torch.Tensor:
    """Probe-hash all ``L`` tables, serve the flat probes, collapse the
    duplicates and pack ``[topk_ids | n_candidates]`` ``(nq, k+1)`` int32
    in ONE replayed CUDA graph (the JAX package's ``_fused_mt_serve``).

    ``hashings`` are the tables' heads, ``layout`` their flat layout
    (``MultiTableIndexer._serving_layout``), ``engine`` ``"windowed"``,
    ``"grouped"`` or ``"fixed"`` (or the JAX package's names),
    ``n_rows`` the corpus rows.  ``g_override`` sizes the windowed or
    grouped group table; on the windowed engine it is GUARDED: the graph
    also computes the batch's exact need and serves a batch that needs
    more at the static bound, a branch taken on the card inside the same
    replay (:func:`_mt_serve_body`), so no candidate is lost and nothing
    is read on the host.  Sampled probes draw one
    generator per table from ``generator`` before the replay, as the
    ensemble's eager serve does.  The graph is ``graphs``'s entry
    (default: :data:`nlsh_tpu_torch.utils.graphs.DEFAULT`); CPU queries
    run eagerly."""
    uniforms = _table_uniforms(hashings, queries.shape[0], hash_times,
                               generator, probe_mode, queries.device)
    return _fused_mt_async(
        hashings, layout, queries, uniforms, k=k, hash_times=hash_times,
        engine=_mt_engine(engine), n_rows=n_rows, g_override=g_override,
        probe_mode=probe_mode, repeats=None,
        graphs=DEFAULT if graphs is None else graphs)


@torch.no_grad()
def _fused_mt_serve_batched(hashings, layout, queries,
                            generator: torch.Generator | None = None, *,
                            k: int, hash_times: int, engine: str,
                            n_rows: int, repeats: int,
                            g_override: int | None = None,
                            probe_mode: str = "sample",
                            graphs: GraphCache | None = None
                            ) -> torch.Tensor:
    """``repeats`` full :func:`_fused_mt_serve` batches in ONE replayed
    graph, ``(repeats, nq, k+1)`` (the JAX package's
    ``_fused_mt_serve_batched``).  ``queries`` is ``(nq, d)`` (repeat
    ``i`` serves ``torch.roll(queries, i * 1009, 0)``) or a fresh-query
    pool ``(repeats, nq, d)``; repeat ``i``'s sampled probes draw from
    :func:`~nlsh_tpu_torch.index.indexer.repeat_generator` ``(generator,
    i)``.  Each guarded windowed repeat takes its own branch on the card,
    as the JAX package's ``lax.map`` of ``lax.cond`` does."""
    if queries.dim() == 3 and queries.shape[0] != repeats:
        raise ValueError(
            f"fresh-query pool has {queries.shape[0]} batches "
            f"but repeats={repeats}")
    nq = queries.shape[-2]
    if generator is None:
        generator = torch.Generator(device=queries.device).manual_seed(0)
    draws = [_table_uniforms(hashings, nq, hash_times,
                             repeat_generator(generator, i), probe_mode,
                             queries.device) for i in range(repeats)]
    uniforms = None if draws[0] is None else torch.stack(draws)
    return _fused_mt_async(
        hashings, layout, queries, uniforms, k=k, hash_times=hash_times,
        engine=_mt_engine(engine), n_rows=n_rows, g_override=g_override,
        probe_mode=probe_mode, repeats=repeats,
        graphs=DEFAULT if graphs is None else graphs)


def _union_rows(row_ids, starts, counts, pids, pvalid, budget: int,
                n_rows: int):
    """Every probed bucket member of every table, ``(c, L*P*budget)``
    sorted ascending with ``n_rows`` for empty slots, and the mask of
    each distinct id's first occurrence."""
    L, c, n_probes = pids.shape
    offs = torch.arange(budget, device=pids.device)
    safe = torch.clamp(pids.long(), 0, starts.shape[1] - 1).reshape(L, -1)
    cnt = torch.where(pvalid.reshape(L, -1), counts.gather(1, safe), 0)
    pos = starts.gather(1, safe).long()[..., None] + offs     # (L, c*P, B)
    valid = offs < cnt[..., None]
    rows = row_ids.long().gather(
        1, torch.clamp(pos, 0, n_rows - 1).reshape(L, -1))
    keyed = torch.where(valid.reshape(L, -1), rows, n_rows)
    keyed = keyed.reshape(L, c, -1).permute(1, 0, 2).reshape(c, -1)
    keyed = torch.sort(keyed, dim=1).values
    uniq = torch.ones_like(keyed, dtype=torch.bool)
    uniq[:, 1:] = keyed[:, 1:] != keyed[:, :-1]
    uniq &= keyed < n_rows
    return keyed, uniq


class MultiTableIndexer:
    """L learned hash tables over one corpus, on ``device`` or sharded
    over ``mesh``.

    Args:
      hashings: one hashing module per table, all with the same number
        of buckets; they are moved to the index's device.
      corpus: ``(n, d)`` float32 rows (numpy or tensor).
      device: where the index lives and queries run (without a mesh).
      mesh: a 1-D mesh to shard the tables over (``L`` divisible by its
        global entry count); queries run on its first device.
      metric: rerank metric in the original space.
      probe_budget: rows served per probed bucket; ``None`` uses the
        largest bucket of any table (exact).
      engine: ``"auto"`` (= ``"windowed"`` for cosine and euclidean, else
        ``"gather"``), ``"windowed"``, ``"grouped"``, ``"fixed"`` or
        ``"gather"``.
      serving_dtype: ``torch.float32``, ``torch.bfloat16`` or
        ``torch.int8`` layout rows.
      block_rows: rows per window / block (default 512).
      tables: ready stacked CSR arrays ``(row_ids (L, n), starts (L, NB),
        counts (L, NB))`` (the persistence path): the corpus is then not
        hashed.
      int8_scale: ``"per_row"`` or ``"global"``; int8 layouts only.
      layout_mode: ``"device"`` (= ``"auto"``) or ``"host"``: stacked
        layouts built in numpy, and a numpy corpus kept off the device.
    """

    ENGINES = ("auto", "windowed", "grouped", "fixed", "gather")

    @torch.no_grad()
    def __init__(self, hashings: list[nn.Module], corpus, *, device=None,
                 mesh: Mesh | None = None, metric: str = "cosine",
                 probe_budget: int | None = None, engine: str = "auto",
                 serving_dtype=torch.float32, block_rows: int | None = None,
                 tables=None, int8_scale: str = "per_row",
                 layout_mode: str = "auto"):
        qk._check_scale_mode(int8_scale)
        if layout_mode not in ("auto", "device", "host"):
            raise ValueError(f"unknown layout_mode {layout_mode!r}")
        if mesh is not None:
            device = mesh.devices[0]
        elif device is None:
            raise ValueError("give the index a device or a mesh")
        self.mesh = mesh
        self.device = torch.device(device)
        self.hashings = [h.to(self.device).eval() for h in hashings]
        n_buckets = {h.n_buckets for h in self.hashings}
        if len(n_buckets) != 1:
            raise ValueError(f"the tables disagree on n_buckets: {n_buckets}")
        (self.n_buckets,) = n_buckets
        self.n_tables = len(self.hashings)
        if mesh is not None and self.n_tables % mesh.global_size():
            raise ValueError(
                f"n_tables {self.n_tables} not divisible by mesh size "
                f"{mesh.global_size()}")
        self.layout_mode = layout_mode
        self.n_rows = int(corpus.shape[0])
        self._corpus_host = np.asarray(corpus, np.float32) \
            if isinstance(corpus, np.ndarray) else None
        # the lazy corpus: host layouts never read it on the device
        lazy = layout_mode == "host" and self._corpus_host is not None
        self.corpus = None if lazy else torch.as_tensor(
            corpus, dtype=torch.float32, device=self.device)
        self._corpus_copies = {}
        self.metric = metric
        self.serving_dtype = serving_dtype
        self.block_rows = block_rows
        self.int8_scale = int8_scale
        self._stacked = None
        self._stacked_sig = None
        self._g_cal: int | None = None  # set by :meth:`calibrate`
        self._graphs = GraphCache()  # the fused serve's, of this layout
        self.engine = engine
        if tables is None:
            # one table at a time: each hash + stable sort's transients only
            built = []
            for h in self.hashings:
                codes = hash_corpus(h, self.corpus) if not lazy else \
                    torch.from_numpy(hash_corpus_host(
                        h, self._corpus_host, device=self.device))
                built.append(build_bucket_table(codes, self.n_buckets,
                                                device=self.device))
            tables = tuple(torch.stack([getattr(t, name) for t in built])
                           for name in ("row_ids", "starts", "counts"))
        # (L, n), (L, NB), (L, NB)
        self.row_ids, self.starts, self.counts = (
            torch.as_tensor(t, dtype=torch.int32, device=self.device)
            for t in tables)
        if probe_budget is None:
            probe_budget = int(self.counts.max())
        self.probe_budget = max(int(probe_budget), 1)

    @property
    def engine(self) -> str:
        return self._engine

    @engine.setter
    def engine(self, value: str):
        """Validates, resolves ``"auto"``, and on a change of engine drops
        the stacked layout (its alignment is engine-specific) and the
        windowed calibration."""
        if value not in self.ENGINES:
            raise ValueError(f"unknown engine {value!r}")
        if value == "auto":
            # ensemble buckets are far below a block: the dense-window
            # engine's design point
            value = "windowed" if self.metric in _SERVING_METRICS else "gather"
        old = getattr(self, "_engine", None)
        self._engine = value
        if old is not None and value != old:
            self._stacked = None
            self._g_cal = None
            self._graphs.clear()

    # -- placement ---------------------------------------------------------------

    def _entries(self) -> list[tuple[int, int, torch.device]]:
        """``(first table, last table + 1, device)`` of each of this
        process's entries: all tables on ``device`` without a mesh."""
        if self.mesh is None:
            return [(0, self.n_tables, self.device)]
        lc = self.n_tables // self.mesh.global_size()
        return [(g * lc, (g + 1) * lc, dev) for g, dev in (
            (self.mesh.global_index(i), dev)
            for i, dev in enumerate(self.mesh.devices))]

    def _corpus_on(self, dev) -> torch.Tensor:
        """The corpus on ``dev`` (uploaded from the host on first use when
        it is lazy; one copy per other device)."""
        if self.corpus is None:
            self.corpus = torch.from_numpy(self._corpus_host).to(self.device)
        if dev == self.device:
            return self.corpus
        if dev not in self._corpus_copies:
            self._corpus_copies[dev] = self.corpus.to(dev)
        return self._corpus_copies[dev]

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist the L stacked CSR tables and the serving knobs (NOT
        the corpus or the models: the caller owns those) as the JAX
        package's npz archive, with its engine and dtype names; without
        it a restart of an L=8 ensemble hashes the corpus 8 times."""
        src = self.corpus if self.corpus is not None else self._corpus_host
        np.savez_compressed(
            path,
            row_ids=self.row_ids.cpu().numpy(),
            starts=self.starts.cpu().numpy(),
            counts=self.counts.cpu().numpy(),
            meta=np.array([
                self.metric, str(self.probe_budget),
                ENGINE_TO_JAX[self._engine], dtype_name(self.serving_dtype),
                str(self.block_rows), str(self.n_tables), str(self.n_rows),
                corpus_fingerprint(src),
                self.int8_scale,
            ]),
        )

    @classmethod
    def load(cls, path: str, hashings: list[nn.Module], corpus, *,
             device=None, mesh: Mesh | None = None) -> "MultiTableIndexer":
        """Rebuild from :meth:`save` output (of this package or of the JAX
        package) without re-hashing; refuses a different corpus or table
        count, and a mesh the tables do not divide over."""
        with np.load(path, allow_pickle=False) as z:
            meta = [str(v) for v in z["meta"]]
            # archives from before the int8_scale knob were global-scale
            int8_scale = meta[8] if len(meta) > 8 else "global"
            (metric, probe_budget, engine, sdtype, block_rows,
             n_tables, n_rows, digest) = meta[:8]
            if int(n_tables) != len(hashings):
                raise ValueError(
                    f"saved ensemble has {n_tables} tables, params have "
                    f"{len(hashings)}"
                )
            if int(n_rows) != corpus.shape[0]:
                raise ValueError(
                    f"saved index is over {n_rows} corpus rows, got "
                    f"{corpus.shape[0]}"
                )
            check_fingerprint(digest, corpus)
            tables = (z["row_ids"], z["starts"], z["counts"])
        return cls(
            hashings, corpus, device=device, mesh=mesh, metric=metric,
            probe_budget=int(probe_budget), engine=engine_from_jax(engine),
            serving_dtype=DTYPE_NAMES[sdtype],
            block_rows=None if block_rows == "None" else int(block_rows),
            tables=tables, int8_scale=int8_scale,
        )

    # -- the flat stacked serving layouts ------------------------------------

    def _stacked_signature(self) -> tuple:
        return (self.engine, self.serving_dtype, int(self.probe_budget),
                self.block_rows, self.int8_scale, self.layout_mode)

    def _geometry(self) -> tuple[int, int, int, int, int]:
        """``(cap, align, n_aligned, total_blocks, br)`` of the flat
        layouts, from every table's counts: each entry's flat layout
        gives its tables the same ``n_aligned`` rows and the group bound
        the blocks of all ``L`` tables, as the JAX package's does."""
        br = qk._br(self.block_rows)
        cap = qk.round_cap(self.probe_budget, br)
        # windowed: dense 8-row starts (ensemble buckets are far smaller
        # than a block); grouped: block-aligned starts; fixed-cap: cap
        align = {"grouped": br, "windowed": 8}.get(self.engine, cap)
        counts_np = self.counts.cpu().numpy()
        # a multiple of br, so the flat (table, window) space is exact
        n_aligned = qk._round_up(max(qk.aligned_rows(c, cap, align=align)
                                     for c in counts_np), br)
        total_blocks = int(sum((-(-np.minimum(c, cap) // br)).sum()
                               for c in counts_np))
        return cap, align, n_aligned, total_blocks, br

    def _entry_layouts(self) -> list[qk.ServingLayout]:
        """One flat layout per entry of this process (one in all without a
        mesh), built on first use and rebuilt (dropping the calibration)
        when a knob it depends on changed."""
        sig = self._stacked_signature()
        if self._stacked is not None:
            if self._stacked_sig == sig:
                return self._stacked
            self._g_cal = None  # calibrated for the stale layout
            self._stacked = None
            self._graphs.clear()
        geometry = self._geometry()
        build = self._flat_layout_host if self.layout_mode == "host" \
            else self._flat_layout
        self._stacked = [build(t0, t1, dev, *geometry)
                         for t0, t1, dev in self._entries()]
        self._stacked_sig = sig
        return self._stacked

    def _serving_layout(self) -> qk.ServingLayout:
        """The flat layout over all ``L * NB`` buckets (no mesh)."""
        if self.mesh is not None:
            raise ValueError("a table-sharded ensemble has one flat layout "
                             "per entry (_entry_layouts)")
        return self._entry_layouts()[0]

    def _check_dtype(self):
        if self.serving_dtype not in DTYPE_NAMES.values():
            raise ValueError(f"unsupported layout dtype {self.serving_dtype}")

    def _flat_layout(self, t0: int, t1: int, dev, cap: int, align: int,
                     n_aligned: int, total_blocks: int,
                     br: int) -> qk.ServingLayout:
        """Tables ``[t0, t1)``'s layouts (:func:`qk.layout_arrays` at the
        common ``n_aligned``) written into one flat array on ``dev``,
        table-major, their bucket starts offset by ``(table - t0) *
        n_aligned``.  Built one table at a time into the preallocated
        flat arrays, so the peak is the flat layout plus one table's
        transients.

        int8 scales are taken over the SHARED corpus (every table
        quantises the same rows): ``"per_row"`` is one scale per corpus
        row, identical across tables and scattered by each table's
        permutation; ``"global"`` one scalar."""
        self._check_dtype()
        is_int8 = self.serving_dtype == torch.int8
        per_row = is_int8 and self.int8_scale == "per_row"
        corpus = self._corpus_on(dev)
        scale = qk.ext_scales(self.corpus, self.metric, self.int8_scale).to(
            dev) if is_int8 else None
        L, n = t1 - t0, n_aligned
        d_pad = qk._round_up(corpus.shape[1], qk.LANE)
        data = torch.empty((L * n, d_pad), dtype=self.serving_dtype,
                           device=dev)
        row_map = torch.empty(L * n, dtype=torch.int32, device=dev)
        starts = torch.empty((L, self.n_buckets), dtype=torch.int32,
                             device=dev)
        norms = scale_rows = None
        if self.metric != "cosine":
            norms = torch.empty(L * n, dtype=torch.float32, device=dev)
        if per_row:
            scale_rows = torch.empty(L * n, dtype=torch.float32, device=dev)
        for t in range(L):
            d, rm, st, nr, sr = qk.layout_arrays(
                self.row_ids[t0 + t].to(dev), self.starts[t0 + t].to(dev),
                self.counts[t0 + t].to(dev), corpus, cap=cap, n_aligned=n,
                metric=self.metric, dtype=self.serving_dtype, align=align,
                scale=scale)
            data[t * n:(t + 1) * n] = d
            row_map[t * n:(t + 1) * n] = rm
            starts[t] = st + t * n
            if norms is not None:
                norms[t * n:(t + 1) * n] = nr
            if per_row:
                scale_rows[t * n:(t + 1) * n] = sr
        return qk.ServingLayout(
            data=data, row_map=row_map, starts=starts.reshape(-1),
            counts=self.counts[t0:t1].reshape(-1).to(dev), cap=cap,
            d_pad=d_pad, align=align, metric=self.metric,
            total_blocks=total_blocks, norms=norms, block_rows=br,
            scale=scale_rows if per_row else scale)

    def _flat_layout_host(self, t0: int, t1: int, dev, cap: int, align: int,
                          n_aligned: int, total_blocks: int,
                          br: int) -> qk.ServingLayout:
        """:meth:`_flat_layout` built in numpy (:func:`qk.layout_arrays_host`
        per table, concatenated on the host): only the finished flat
        arrays go to ``dev``, and the device never holds the raw
        corpus."""
        self._check_dtype()
        corpus = self._corpus_host if self._corpus_host is not None else \
            self.corpus.cpu().numpy()
        dtype = self.serving_dtype
        h_scale = qk.ext_scales_host(corpus, self.metric, self.int8_scale) \
            if dtype == torch.int8 else None
        rids, sts, cts = (t.cpu().numpy() for t in (self.row_ids, self.starts,
                                                     self.counts))
        parts = [qk.layout_arrays_host(
            rids[t], sts[t], cts[t], corpus, cap=cap, n_aligned=n_aligned,
            metric=self.metric, dtype=dtype, align=align, scale=h_scale)
            for t in range(t0, t1)]

        def flat(i):
            return None if parts[0][i] is None else \
                np.concatenate([p[i] for p in parts])

        starts = np.stack([p[2] + t * n_aligned for t, p in enumerate(parts)])
        scale = None
        if parts[0][4] is not None:
            scale = torch.from_numpy(flat(4)).to(dev)
        elif h_scale is not None:
            scale = torch.tensor(h_scale, dtype=torch.float32, device=dev)
        norms = flat(3)
        return qk.ServingLayout(
            data=qk._host_data_tensor(flat(0), dtype, dev),
            row_map=torch.from_numpy(flat(1)).to(dev),
            starts=torch.from_numpy(starts.reshape(-1)).to(dev),
            counts=self.counts[t0:t1].reshape(-1).to(dev), cap=cap,
            d_pad=parts[0][0].shape[1], align=align, metric=self.metric,
            total_blocks=total_blocks,
            norms=None if norms is None else torch.from_numpy(norms).to(dev),
            block_rows=br, scale=scale)

    def _flat_geometry(self) -> _FlatGeometry:
        """The flat bucket starts and counts of all ``L`` tables, computed
        from the counts as the layouts place them (no rows built)."""
        cap, align, n_aligned, _, br = self._geometry()
        c = self.counts.long()
        sizes = (c + align - 1) // align * align
        offs = torch.arange(self.n_tables, device=c.device)[:, None]
        starts = torch.cumsum(sizes, 1) - sizes + offs * n_aligned
        return _FlatGeometry(starts.to(torch.int32).reshape(-1),
                             self.counts.reshape(-1), cap,
                             self.n_tables * n_aligned, br)

    # -- probes ----------------------------------------------------------------

    def _probes(self, queries, hash_times: int,
                generator: torch.Generator | None = None,
                probe_mode: str = "sample"):
        """Per-table probe ids / validity, ``(L, nq, P)``.  Flip probes
        are deterministic; sampled probes draw from one generator per
        table, seeded from ``generator`` (default: seeded 0)."""
        uniforms = _table_uniforms(self.hashings, queries.shape[0],
                                   hash_times, generator, probe_mode,
                                   self.device)
        return _table_probes(self.hashings, queries, hash_times, probe_mode,
                             uniforms)

    def _flat_probes(self, pids, pvalid):
        """``(Lc, nq, P)`` per-table probes -> ``(nq, Lc*P)`` bucket ids of
        the flat ``Lc * NB`` bucket space."""
        return _flat(pids, pvalid, self.n_buckets)

    # -- the gather engine and the exact distinct count ------------------------

    @staticmethod
    def _gather_rerank(row_ids, starts, counts, corpus, q, pids, pvalid,
                       k: int, budget: int, metric: str, n_rows: int):
        """One query chunk against a stack of tables: ``(top_ids (c, k)
        i32, top_d (c, k), n_distinct (c,) i32)``, ids ascending by
        distance, ``-1`` past the candidates."""
        rowwise = D.get_metric(metric)["rowwise"]
        keyed, uniq = _union_rows(row_ids, starts, counts, pids, pvalid,
                                  budget, n_rows)
        n_distinct = torch.sum(uniq, dim=1, dtype=torch.int32)
        cand = torch.clamp(keyed, 0, n_rows - 1)
        dist = rowwise(q[:, None, :], corpus[cand])
        dist = torch.where(uniq, dist, torch.inf)
        top_d, arg = smallest_k(dist, k)
        top = torch.gather(cand, 1, arg)
        top = torch.where(torch.isfinite(top_d), top, -1).to(torch.int32)
        return top, top_d, n_distinct

    def _gather_query(self, queries, pids, pvalid, k: int, t0: int, t1: int,
                      dev):
        """Tables ``[t0, t1)``'s gather engine on ``dev``, a query chunk at
        a time: ``(top_ids, top_d, n_distinct)``."""
        chunk = _mt_query_chunk(self.n_tables, pids.shape[-1],
                                self.probe_budget, queries.shape[1])
        tabs = [t[t0:t1].to(dev) for t in (self.row_ids, self.starts,
                                           self.counts)]
        corpus = self._corpus_on(dev)
        queries, pids, pvalid = (t.to(dev) for t in (queries, pids[t0:t1],
                                                      pvalid[t0:t1]))
        parts = [self._gather_rerank(
            *tabs, corpus, queries[s:s + chunk], pids[:, s:s + chunk],
            pvalid[:, s:s + chunk], k, self.probe_budget, self.metric,
            self.n_rows)
            for s in range(0, queries.shape[0], chunk)]
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))

    def _gather_serve(self, queries, pids, pvalid, k: int) -> torch.Tensor:
        """The gather engine, packed ``(nq, k + 1)`` int32 ``[topk_ids |
        n_candidates]``: each entry reranks its tables' candidates; with a
        mesh the per-entry lists merge by a STABLE sort by id, duplicate
        ids dropped, the ``k`` nearest kept (lowest flat index first among
        equal distances), and ``n_candidates`` is the psum of the
        per-entry distinct counts (an upper bound)."""
        outs = [self._gather_query(queries, pids, pvalid, k, t0, t1, dev)
                for t0, t1, dev in self._entries()]
        if self.mesh is None:
            top, _, nd = outs[0]
            return torch.cat([top, nd[:, None]], dim=1)
        nq = queries.shape[0]
        all_i, all_d = (all_gather([o[i] for o in outs]).permute(
            1, 0, 2).reshape(nq, -1) for i in (0, 1))
        order = torch.argsort(torch.where(all_i < 0, self.n_rows, all_i),
                              dim=1, stable=True)
        si = torch.gather(all_i, 1, order)
        sd = torch.gather(all_d, 1, order)
        dup = torch.zeros_like(si, dtype=torch.bool)
        dup[:, 1:] = si[:, 1:] == si[:, :-1]
        sd = torch.where(dup | (si < 0), torch.inf, sd)
        top_d, arg = smallest_k(sd, k)
        top = torch.where(torch.isfinite(top_d), torch.gather(si, 1, arg), -1)
        return torch.cat([top.to(torch.int32),
                          psum([o[2] for o in outs])[:, None]], dim=1)

    def _gather_body(self, k: int, hash_times: int, probe_mode: str):
        """``body(queries, uniforms)`` of one gather serve (the JAX
        package's jitted ``_query_fn``): every table's probes (sampled
        probes from the given uniforms), each entry's chunk loop, on a mesh
        the merge and the psum (:meth:`_gather_serve`), packed."""
        def body(queries, uniforms):
            pids, pvalid = _table_probes(self.hashings, queries, hash_times,
                                         probe_mode, uniforms)
            return self._gather_serve(queries, pids, pvalid, k)

        return body

    @torch.no_grad()
    def exact_query_size(self, queries, hash_times: int = 1,
                         generator: torch.Generator | None = None,
                         probe_mode: str = "sample") -> np.ndarray:
        """Exact distinct-candidate count per query, ``(nq,)`` int32: the
        engine-independent query_size (the windowed and grouped engines
        report the summed per-table occupancy, an upper bound).  Same
        probes as :meth:`query` for the same arguments; truncation at
        ``probe_budget``."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        pids, pvalid = self._probes(queries, hash_times, generator,
                                    probe_mode)
        query_chunk = _mt_query_chunk(self.n_tables, hash_times,
                                      self.probe_budget, 1)
        out = [torch.sum(_union_rows(
            self.row_ids, self.starts, self.counts, pids[:, s:s + query_chunk],
            pvalid[:, s:s + query_chunk], self.probe_budget, self.n_rows)[1],
            dim=1, dtype=torch.int32)
            for s in range(0, queries.shape[0], query_chunk)]
        return torch.cat(out).cpu().numpy()

    # -- the windowed and grouped engines --------------------------------------

    @torch.no_grad()
    def calibrate(self, queries, hash_times: int = 1,
                  generator: torch.Generator | None = None,
                  probe_mode: str = "sample") -> int:
        """Size the windowed engine's group table from a representative
        batch: its exact group count over the flat layout of all ``L``
        tables (one device reduction, read on the host), times
        ``_CAL_MARGIN``, rounded up to ``_GROUP_EB`` and clamped to the
        static bound.  Later windowed serves without a mesh use it when a
        batch's exact need fits it and the static bound otherwise (a
        table-sharded serve takes the static bound, as the JAX package's
        does).  Returns the group count."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        layout = self._serving_layout() if self.mesh is None else \
            self._flat_geometry()
        br = layout.br
        gp, gv = self._flat_probes(*self._probes(queries, hash_times,
                                                 generator, probe_mode))
        needed = _windowed_needed(layout, gp, gv)
        g_cal = qk._GROUP_EB * max(
            -(-int(needed * _CAL_MARGIN) // qk._GROUP_EB), 1)
        static = qk.windowed_static_bound(gp.numel(), layout.cap // br + 1,
                                          layout.n_rows // br, qk.GROUP_W)
        self._g_cal = int(min(g_cal, static))
        self._graphs.clear()  # served at the old calibration
        return self._g_cal

    def windowed_group_bound(self, layout: qk.ServingLayout, gp, gv):
        """The group table a windowed serve of ``(gp, gv)`` uses: the
        calibrated count when the batch's exact need (computed on the
        device, one int read) fits it, else ``None`` (the static
        bound).  Returns ``(g_total_override, needed)``; ``needed`` is
        None without a calibration."""
        if self._g_cal is None:
            return None, None
        needed = _windowed_needed(layout, gp, gv)
        return (self._g_cal if needed <= self._g_cal else None), needed

    def _serve_flat(self, layout: qk.ServingLayout, queries, pids, pvalid,
                    k: int, plain: bool):
        """One windowed, grouped or fixed-cap serve of the ``Lc`` tables
        of ``layout`` (per-table probes ``(Lc, nq, P)``), fetching
        ``k * Lc``: ``(ids, scores, n_cand)`` before the duplicate
        collapse; ``n_cand`` is the summed probed occupancy."""
        cap, br = layout.cap, layout.br
        gp, gv = self._flat_probes(pids, pvalid)
        lc, _, n_probes = pids.shape
        k_fetch = min(k * lc, n_probes * lc * cap)
        if self.engine == "windowed":
            g_override = None
            if self.mesh is None:
                g_override, _ = self.windowed_group_bound(layout, gp, gv)
            return serving_query_windowed(
                layout, queries, gp, gv, layout.counts, k=k_fetch, row_k=k,
                g_total_override=g_override, plain=plain)
        if self.engine == "fixed":
            return serving_query(layout, queries, gp, gv, layout.counts,
                                 k=k_fetch, plain=plain)
        # ensemble buckets have low multiplicity, so the static bound is
        # several-fold loose: one host read for the exact one
        g_exact = qk.grouped_exact_bound(layout.counts, gp, gv, cap,
                                         qk.GROUP_W, block_rows=br)
        static = qk.grouped_static_bound(gp.numel(), cap // br,
                                         layout.total_blocks, qk.GROUP_W)
        return serving_query_grouped(
            layout, queries, gp, gv, layout.counts, k=k_fetch, row_k=k,
            g_total_override=qk.round_group_override(g_exact, static),
            plain=plain)

    def _query_serving(self, queries, pids, pvalid, k: int, plain: bool):
        """Every entry's serve of its tables, then the duplicate collapse
        over the gathered lists; ``n_candidates`` is the summed probed
        occupancy across all tables."""
        outs = []
        for (t0, t1, dev), layout in zip(self._entries(),
                                         self._entry_layouts()):
            outs.append(self._serve_flat(
                layout, queries.to(dev), pids[t0:t1].to(dev),
                pvalid[t0:t1].to(dev), k, plain))
        if self.mesh is None:
            ids, scores, n_cand = outs[0]
        else:
            nq = queries.shape[0]
            ids, scores = (all_gather([o[i] for o in outs]).permute(
                1, 0, 2).reshape(nq, -1) for i in (0, 1))
            n_cand = psum([o[2] for o in outs])
        merged, _ = self._dedupe_topk(ids, scores, k, self.n_rows)
        return merged, n_cand

    def _mesh_serve_body(self, k: int, hash_times: int, probe_mode: str):
        """``body(queries, uniforms)`` of one table-sharded serve on the
        windowed or fixed-cap engine (the JAX package's
        ``_query_serving_sharded``): every table's probes (sampled probes
        from the given uniforms), each entry's serve of its tables' flat
        layout, the gathered lists' duplicate collapse and the summed
        candidates (:meth:`_query_serving`), packed ``(nq, k + 1)``
        int32."""
        def body(queries, uniforms):
            pids, pvalid = _table_probes(self.hashings, queries, hash_times,
                                         probe_mode, uniforms)
            merged, n_cand = self._query_serving(queries, pids, pvalid, k,
                                                 plain=False)
            return torch.cat([merged, n_cand[:, None]], dim=1)

        return body

    @staticmethod
    def _dedupe_topk(ids, scores, k: int, n_rows: int):
        """Collapse duplicate candidate ids (one corpus row found through
        several tables) and take the top ``k``: a stable sort by id
        (``-1`` last) keeps each id's first, best-scored copy."""
        order = torch.argsort(torch.where(ids < 0, n_rows, ids), dim=1,
                              stable=True)
        si = torch.gather(ids, 1, order)
        ss = torch.gather(scores, 1, order)
        dup = torch.zeros_like(si, dtype=torch.bool)
        dup[:, 1:] = si[:, 1:] == si[:, :-1]
        ss = torch.where(dup | (si < 0), -torch.inf, ss)
        top, arg = _largest_k(ss, k)
        merged = torch.where(torch.isfinite(top), torch.gather(si, 1, arg), -1)
        return merged.to(torch.int32), top

    # -- the public query API --------------------------------------------------

    @torch.no_grad()
    def query_async(self, queries, k: int = 10, hash_times: int = 1,
                    generator: torch.Generator | None = None,
                    probe_mode: str = "sample", plain: bool = False):
        """Enqueue an ensemble query: returns a result for :meth:`fetch`.
        ``probe_mode="flip"`` probes each table's ``hash_times`` best-first
        bit-flip buckets.

        Without a mesh, or on a mesh of one device
        (:meth:`Mesh.on_one_device`), the windowed, fixed-cap and gather
        engines serve in ONE replayed graph on the card and return ONE
        packed ``[topk_ids | n_candidates]`` tensor, final on the device:
        without a mesh the windowed and fixed-cap engines through the
        fused ensemble serve (:func:`_fused_mt_serve`; the windowed engine
        at :meth:`calibrate`'s count, guarded on the card, or at the
        static bound), on the mesh every entry's tables, the gather, sum
        and duplicate collapse (:meth:`_mesh_serve_body`; windowed at the
        static bound, as the mesh always serves it), and the gather engine
        its probes, chunk loops and merge (:meth:`_gather_body`).  The
        gather engine serves eagerly on meshes over several devices or
        processes and on the lazy corpus's first call, which uploads it,
        and returns the packed tensor too.  The grouped engine keeps its
        exact group bound read on the host, and it, meshes over several
        devices or processes and ``plain=True`` (the kernels' plain
        PyTorch versions) serve eagerly and return ``(topk_ids,
        n_candidates)``.  On the CPU a graph's body runs eagerly.

        While a profiler records, the call is the host span ``nlsh.query``
        around ``nlsh.upload``, ``nlsh.uniforms`` and the replay's
        ``nlsh.replay``."""
        with span("nlsh.query"):
            return self._query_async(queries, k, hash_times, generator,
                                     probe_mode, plain)

    def _query_async(self, queries, k: int, hash_times: int, generator,
                     probe_mode: str, plain: bool):
        with span("nlsh.upload"):
            queries = torch.as_tensor(queries, dtype=torch.float32,
                                      device=self.device)
        gather = self.engine == "gather"
        if not plain and (gather or self.engine in ("windowed", "fixed")) \
                and (self.mesh is None or self.mesh.on_one_device()) \
                and not (gather and self.corpus is None):
            with span("nlsh.uniforms"):
                uniforms = _table_uniforms(self.hashings, queries.shape[0],
                                           hash_times, generator, probe_mode,
                                           self.device)
            holds = tuple(self.hashings)
            if gather:
                key = ("mt_gather", k, hash_times, probe_mode,
                       self.probe_budget)
                return self._graphs.run(
                    key, self._gather_body(k, hash_times, probe_mode),
                    (queries, uniforms), holds=(*holds, self.corpus,
                                                self.row_ids, self.starts,
                                                self.counts))
            if self.mesh is not None:
                layouts = tuple(self._entry_layouts())
                key = ("mt_mesh_serve", tuple(map(id, layouts)), k,
                       hash_times, self.engine, probe_mode)
                return self._graphs.run(
                    key, self._mesh_serve_body(k, hash_times, probe_mode),
                    (queries, uniforms), holds=(*holds, *layouts))
            return _fused_mt_async(
                self.hashings, self._serving_layout(), queries, uniforms,
                k=k, hash_times=hash_times, engine=self.engine,
                n_rows=self.n_rows,
                g_override=self._g_cal if self.engine == "windowed" else None,
                probe_mode=probe_mode, repeats=None, graphs=self._graphs)
        pids, pvalid = self._probes(queries, hash_times, generator,
                                    probe_mode)
        if gather:
            return self._gather_serve(queries, pids, pvalid, k)
        return self._query_serving(queries, pids, pvalid, k, plain)

    @staticmethod
    def fetch(result) -> tuple[np.ndarray, np.ndarray]:
        """``(topk_ids (nq, k), n_candidates (nq,))`` as numpy arrays; a
        packed result is ONE copy (the host span ``nlsh.fetch`` while a
        profiler records)."""
        with span("nlsh.fetch"):
            if isinstance(result, tuple):
                ids, n_cand = result
                return ids.cpu().numpy(), n_cand.cpu().numpy()
            packed = result.cpu().numpy()
        return packed[:, :-1], packed[:, -1]

    def serve_stats(self) -> dict:
        """As :meth:`Indexer.serve_stats
        <nlsh_tpu_torch.index.Indexer.serve_stats>`: the layer marks of
        the index's device (the fused ensemble serve's; ``guard_fallbacks``
        counts the batches the windowed guard served at the static bound)
        and this index's graphs' counters."""
        return {**span_stats(self.device), "graphs": self._graphs.stats()}

    def query(self, queries, k: int = 10, hash_times: int = 1,
              generator: torch.Generator | None = None,
              probe_mode: str = "sample",
              plain: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Query the ensemble: ``(topk_ids (nq, k), n_candidates (nq,))``
        numpy arrays (see :meth:`query_async`)."""
        return self.fetch(self.query_async(
            queries, k=k, hash_times=hash_times, generator=generator,
            probe_mode=probe_mode, plain=plain))
