"""Multi-table (L hashings) ensembles on one device.

Port of :mod:`nlsh_tpu.parallel.multitable` for a single device.  ``L``
hashings of one architecture (one ``nn.Module`` per table, e.g. from
:func:`nlsh_tpu_torch.utils.checkpoint.stacked_params_from_jax`) each
build a CSR bucket table over the same corpus.  A query probes every
table; the union of candidates is answered by one of four engines:

* ``"windowed"`` (``"auto"`` for the serving metrics): ONE flat serving
  layout over ``L * NB`` buckets (table ``t``'s rows start at
  ``t * n_aligned``), dense 8-row-aligned, served by the windowed engine
  (kernels K3/K4) in one call for all tables.  The group table is sized
  by :meth:`MultiTableIndexer.calibrate`'s bound when the batch's exact
  need (one device reduction, read on the host) fits it, else by the
  static bound, so no batch ever drops candidates.
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

Left for the multi-GPU slice: the mesh (table-sharded) path, the
host-built stacked layout and the lazy host corpus.
"""

from __future__ import annotations

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
from nlsh_tpu_torch.utils.fingerprint import (
    check_fingerprint,
    corpus_fingerprint,
)

_GATHER_BUDGET_BYTES = 256 * 1024 * 1024
_SERVING_METRICS = ("cosine", "euclidean", "sq_euclidean")
_CAL_MARGIN = 1.1  # calibrate's headroom over the batch's exact need


def _mt_query_chunk(L: int, n_probes: int, budget: int, dim: int) -> int:
    per_query = max(L * n_probes * budget * dim * 4, 1)
    return int(max(4, min(512, _GATHER_BUDGET_BYTES // per_query)))


def _windowed_needed(layout: qk.ServingLayout, gp, gv) -> int:
    """The exact group count of a windowed serve of the flat probes
    ``(gp, gv)`` on ``layout``: one device reduction, one int read."""
    br = layout.br
    return int(qk.windowed_needed_groups(
        layout.starts, layout.counts, gp, gv, layout.cap,
        max_sub=layout.cap // br + 1, group_q=qk.GROUP_W,
        n_windows=-(-layout.n_rows // br) + 1, block_rows=br))


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
    """L learned hash tables over one corpus, on ``device``.

    Args:
      hashings: one hashing module per table, all with the same number
        of buckets; they are moved to ``device``.
      corpus: ``(n, d)`` float32 rows (numpy or tensor).
      device: where the index lives and queries run.
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
    """

    ENGINES = ("auto", "windowed", "grouped", "fixed", "gather")

    def __init__(self, hashings: list[nn.Module], corpus, *, device,
                 metric: str = "cosine", probe_budget: int | None = None,
                 engine: str = "auto", serving_dtype=torch.float32,
                 block_rows: int | None = None, tables=None,
                 int8_scale: str = "per_row"):
        qk._check_scale_mode(int8_scale)
        self.device = torch.device(device)
        self.hashings = [h.to(self.device).eval() for h in hashings]
        n_buckets = {h.n_buckets for h in self.hashings}
        if len(n_buckets) != 1:
            raise ValueError(f"the tables disagree on n_buckets: {n_buckets}")
        (self.n_buckets,) = n_buckets
        self.n_tables = len(self.hashings)
        self.corpus = torch.as_tensor(corpus, dtype=torch.float32,
                                      device=self.device)
        self.metric = metric
        self.serving_dtype = serving_dtype
        self.block_rows = block_rows
        self.int8_scale = int8_scale
        self._stacked = None
        self._stacked_sig = None
        self._g_cal: int | None = None  # set by :meth:`calibrate`
        self.engine = engine
        if tables is None:
            # one table at a time: each hash + stable sort's transients only
            built = [build_bucket_table(hash_corpus(h, self.corpus),
                                        self.n_buckets)
                     for h in self.hashings]
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

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist the L stacked CSR tables and the serving knobs (NOT
        the corpus or the models: the caller owns those) as the JAX
        package's npz archive, with its engine and dtype names; without
        it a restart of an L=8 ensemble hashes the corpus 8 times."""
        np.savez_compressed(
            path,
            row_ids=self.row_ids.cpu().numpy(),
            starts=self.starts.cpu().numpy(),
            counts=self.counts.cpu().numpy(),
            meta=np.array([
                self.metric, str(self.probe_budget),
                ENGINE_TO_JAX[self._engine], dtype_name(self.serving_dtype),
                str(self.block_rows), str(self.n_tables),
                str(self.corpus.shape[0]),
                corpus_fingerprint(self.corpus),
                self.int8_scale,
            ]),
        )

    @classmethod
    def load(cls, path: str, hashings: list[nn.Module], corpus, *,
             device) -> "MultiTableIndexer":
        """Rebuild from :meth:`save` output (of this package or of the JAX
        package) without re-hashing; refuses a different corpus or table
        count."""
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
            hashings, corpus, device=device, metric=metric,
            probe_budget=int(probe_budget), engine=engine_from_jax(engine),
            serving_dtype=DTYPE_NAMES[sdtype],
            block_rows=None if block_rows == "None" else int(block_rows),
            tables=tables, int8_scale=int8_scale,
        )

    # -- the flat stacked serving layout -------------------------------------

    def _stacked_signature(self) -> tuple:
        return (self.engine, self.serving_dtype, int(self.probe_budget),
                self.block_rows, self.int8_scale)

    def _serving_layout(self) -> qk.ServingLayout:
        """The flat layout over ``L * NB`` buckets, built on first use and
        rebuilt (dropping the calibration) when a knob it depends on
        changed."""
        sig = self._stacked_signature()
        if self._stacked is not None:
            if self._stacked_sig == sig:
                return self._stacked
            self._g_cal = None  # calibrated for the stale layout
            self._stacked = None
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
        self._stacked = self._flat_layout(cap, align, n_aligned,
                                          total_blocks, br)
        self._stacked_sig = sig
        return self._stacked

    def _flat_layout(self, cap: int, align: int, n_aligned: int,
                     total_blocks: int, br: int) -> qk.ServingLayout:
        """Each table's layout (:func:`qk.layout_arrays` at the common
        ``n_aligned``) written into one flat array, table-major, its
        bucket starts offset by ``table * n_aligned``.  Built one table
        at a time into the preallocated flat arrays, so the peak is the
        flat layout plus one table's transients.

        int8 scales are taken over the SHARED corpus (every table
        quantises the same rows): ``"per_row"`` is one scale per corpus
        row, identical across tables and scattered by each table's
        permutation; ``"global"`` one scalar."""
        if self.serving_dtype not in DTYPE_NAMES.values():
            raise ValueError(f"unsupported layout dtype {self.serving_dtype}")
        is_int8 = self.serving_dtype == torch.int8
        per_row = is_int8 and self.int8_scale == "per_row"
        scale = qk.ext_scales(self.corpus, self.metric, self.int8_scale) \
            if is_int8 else None
        L, n = self.n_tables, n_aligned
        d_pad = qk._round_up(self.corpus.shape[1], qk.LANE)
        data = torch.empty((L * n, d_pad), dtype=self.serving_dtype,
                           device=self.device)
        row_map = torch.empty(L * n, dtype=torch.int32, device=self.device)
        starts = torch.empty((L, self.n_buckets), dtype=torch.int32,
                             device=self.device)
        norms = scale_rows = None
        if self.metric != "cosine":
            norms = torch.empty(L * n, dtype=torch.float32,
                                device=self.device)
        if per_row:
            scale_rows = torch.empty(L * n, dtype=torch.float32,
                                     device=self.device)
        for t in range(L):
            d, rm, st, nr, sr = qk.layout_arrays(
                self.row_ids[t], self.starts[t], self.counts[t], self.corpus,
                cap=cap, n_aligned=n, metric=self.metric,
                dtype=self.serving_dtype, align=align, scale=scale)
            data[t * n:(t + 1) * n] = d
            row_map[t * n:(t + 1) * n] = rm
            starts[t] = st + t * n
            if norms is not None:
                norms[t * n:(t + 1) * n] = nr
            if per_row:
                scale_rows[t * n:(t + 1) * n] = sr
        return qk.ServingLayout(
            data=data, row_map=row_map, starts=starts.reshape(-1),
            counts=self.counts.reshape(-1), cap=cap, d_pad=d_pad,
            align=align, metric=self.metric, total_blocks=total_blocks,
            norms=norms, block_rows=br,
            scale=scale_rows if per_row else scale)

    # -- probes ----------------------------------------------------------------

    def _probes(self, queries, hash_times: int,
                generator: torch.Generator | None = None,
                probe_mode: str = "sample"):
        """Per-table probe ids / validity, ``(L, nq, P)``.  Flip probes
        are deterministic; sampled probes draw from one generator per
        table, seeded from ``generator`` (default: seeded 0)."""
        gens = [None] * self.n_tables
        if hash_times > 1 and probe_mode == "sample":
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            seeds = torch.randint(0, 2 ** 62, (self.n_tables,),
                                  generator=generator,
                                  device=generator.device).tolist()
            gens = [torch.Generator(device=self.device).manual_seed(s)
                    for s in seeds]
        out = [h.hash(queries, n_probes=hash_times, generator=g,
                      probe_mode=probe_mode)
               for h, g in zip(self.hashings, gens)]
        return (torch.stack([ids for ids, _ in out]),
                torch.stack([v for _, v in out]))

    def _flat_probes(self, pids, pvalid):
        """``(L, nq, P)`` per-table probes -> ``(nq, L*P)`` bucket ids of
        the flat ``L * NB`` bucket space."""
        L, nq, n_probes = pids.shape
        offs = torch.arange(L, dtype=torch.int32, device=pids.device)
        gp = (pids.permute(1, 0, 2) + (offs * self.n_buckets)[None, :, None])
        return (gp.reshape(nq, L * n_probes).to(torch.int32),
                pvalid.permute(1, 0, 2).reshape(nq, L * n_probes))

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

    def _gather_query(self, queries, pids, pvalid, k: int):
        chunk = _mt_query_chunk(self.n_tables, pids.shape[-1],
                                self.probe_budget, queries.shape[1])
        parts = [self._gather_rerank(
            self.row_ids, self.starts, self.counts, self.corpus,
            queries[s:s + chunk], pids[:, s:s + chunk], pvalid[:, s:s + chunk],
            k, self.probe_budget, self.metric, self.corpus.shape[0])
            for s in range(0, queries.shape[0], chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[2] for p in parts]))

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
        n_rows = self.corpus.shape[0]
        out = [torch.sum(_union_rows(
            self.row_ids, self.starts, self.counts, pids[:, s:s + query_chunk],
            pvalid[:, s:s + query_chunk], self.probe_budget, n_rows)[1],
            dim=1, dtype=torch.int32)
            for s in range(0, queries.shape[0], query_chunk)]
        return torch.cat(out).cpu().numpy()

    # -- the windowed and grouped engines --------------------------------------

    @torch.no_grad()
    def calibrate(self, queries, hash_times: int = 1,
                  generator: torch.Generator | None = None,
                  probe_mode: str = "sample") -> int:
        """Size the windowed engine's group table from a representative
        batch: its exact group count (one device reduction, read on the
        host), times ``_CAL_MARGIN``, rounded up to ``_GROUP_EB`` and
        clamped to the static bound.  Later windowed serves use it when a
        batch's exact need fits it and the static bound otherwise.
        Returns the group count."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        layout = self._serving_layout()
        br = layout.br
        gp, gv = self._flat_probes(*self._probes(queries, hash_times,
                                                 generator, probe_mode))
        needed = _windowed_needed(layout, gp, gv)
        g_cal = qk._GROUP_EB * max(
            -(-int(needed * _CAL_MARGIN) // qk._GROUP_EB), 1)
        static = qk.windowed_static_bound(gp.numel(), layout.cap // br + 1,
                                          layout.n_rows // br, qk.GROUP_W)
        self._g_cal = int(min(g_cal, static))
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

    def _query_serving(self, queries, pids, pvalid, k: int, plain: bool):
        """One windowed, grouped or fixed-cap serve over the flat layout,
        then the duplicate collapse.  ``n_candidates`` is the summed
        probed occupancy across tables."""
        layout = self._serving_layout()
        cap, br = layout.cap, layout.br
        gp, gv = self._flat_probes(pids, pvalid)
        n_probes = pids.shape[-1]
        k_fetch = min(k * self.n_tables, n_probes * self.n_tables * cap)
        if self.engine == "windowed":
            g_override, _ = self.windowed_group_bound(layout, gp, gv)
            ids, scores, n_cand = serving_query_windowed(
                layout, queries, gp, gv, layout.counts, k=k_fetch, row_k=k,
                g_total_override=g_override, plain=plain)
        elif self.engine == "fixed":
            ids, scores, n_cand = serving_query(
                layout, queries, gp, gv, layout.counts, k=k_fetch,
                plain=plain)
        else:
            # ensemble buckets have low multiplicity, so the static bound
            # is several-fold loose: one host read for the exact one
            g_exact = qk.grouped_exact_bound(layout.counts, gp, gv, cap,
                                             qk.GROUP_W, block_rows=br)
            static = qk.grouped_static_bound(gp.numel(), cap // br,
                                             layout.total_blocks, qk.GROUP_W)
            ids, scores, n_cand = serving_query_grouped(
                layout, queries, gp, gv, layout.counts, k=k_fetch, row_k=k,
                g_total_override=qk.round_group_override(g_exact, static),
                plain=plain)
        merged, _ = self._dedupe_topk(ids, scores, k, self.corpus.shape[0])
        return merged, n_cand

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
        """Enqueue an ensemble query: returns ``(topk_ids, n_candidates)``
        device tensors for :meth:`fetch`.  ``probe_mode="flip"`` probes
        each table's ``hash_times`` best-first bit-flip buckets.
        ``plain=True`` serves the windowed, grouped or fixed-cap engine
        with the kernels' plain PyTorch versions."""
        queries = torch.as_tensor(queries, dtype=torch.float32,
                                  device=self.device)
        pids, pvalid = self._probes(queries, hash_times, generator,
                                    probe_mode)
        if self.engine == "gather":
            return self._gather_query(queries, pids, pvalid, k)
        return self._query_serving(queries, pids, pvalid, k, plain)

    @staticmethod
    def fetch(result) -> tuple[np.ndarray, np.ndarray]:
        """``(topk_ids (nq, k), n_candidates (nq,))`` as numpy arrays."""
        ids, n_cand = result
        return ids.cpu().numpy(), n_cand.cpu().numpy()

    def query(self, queries, k: int = 10, hash_times: int = 1,
              generator: torch.Generator | None = None,
              probe_mode: str = "sample",
              plain: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Query the ensemble: ``(topk_ids (nq, k), n_candidates (nq,))``
        numpy arrays (see :meth:`query_async`)."""
        return self.fetch(self.query_async(
            queries, k=k, hash_times=hash_times, generator=generator,
            probe_mode=probe_mode, plain=plain))
