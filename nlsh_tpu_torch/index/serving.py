"""Serving paths: prep -> scoring kernel -> top-k merge.

Port of :mod:`nlsh_tpu.index.serving`'s fixed-cap, grouped and windowed
engines.

* Fixed-cap (:func:`serving_query`): every (query, probe) event scores
  its bucket's first ``cap`` rows of a cap-aligned layout (kernel K5),
  then one flat top-k per query over its ``P * cap`` slots.

* Grouped: the (query, probe) events are sorted by bucket block, every
  block is scored against the up to G queries that probe it (kernel K1,
  or K2 when the per-block k is above ``ROW_TOPK``, each panel row's top
  k then taken by K8).
* Windowed: the events are cut into sub-events of fixed ``block_rows``
  windows of a dense layout, every window is scored against the up to G
  sub-events that land in it, each slot masked to its bucket's
  ``[lo, hi)`` lanes (kernel K3, or K4 and K8 when the per-row k is
  above ``ROW_TOPK``).  The low-occupancy engine: ensembles, whose
  buckets are far smaller than a block.

Each query's per-block (per-window) winners then merge into its top-k
corpus ids.  Score order is the exact distance order (the layout's
metric extension makes score monotone in distance), so results match the
gather engine whenever ``layout.cap`` covers the probed buckets.

K1 returns scores and int32 lanes as two arrays, so the JAX package's
``PACK_W`` panel packing (a TPU gather workaround) has no counterpart.

Each engine marks its layers (:func:`nlsh_tpu_torch.utils.profiling.mark`):
``prep`` before the queries' extension, ``score`` before the scoring
kernel, ``merge`` after it.  The marks count inside a serve body that
opened with a ``hash`` mark (the fused serves'), and do nothing
elsewhere.
"""

from __future__ import annotations

import torch

from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.utils.profiling import mark


def _largest_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of each row, descending, lowest index
    first among equal values (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    pad = torch.zeros((n - t.shape[0],) + t.shape[1:], dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, pad])


def _n_candidates(probe_ids, probe_valid, full_counts) -> torch.Tensor:
    """Each query's summed probed occupancy (unclamped counts), i32."""
    safe = torch.clamp(probe_ids.long(), 0, full_counts.shape[0] - 1)
    return torch.sum(torch.where(probe_valid, full_counts[safe], 0), dim=1,
                     dtype=torch.int32)


@torch.no_grad()
def serving_query(layout: qk.ServingLayout, queries, probe_ids, probe_valid,
                  full_counts, k: int, plain: bool = False):
    """Fixed-cap serving (the JAX package's ``"pallas"`` engine).

    Returns ``(topk_ids (nq, k) i32, topk_scores (nq, k) f32,
    n_candidates (nq,) i32)``; ids are corpus rows, ``-1`` under a
    non-finite score, scores descend, and ``n_candidates`` sums the
    probed buckets' FULL counts (``full_counts``, unclamped).  Needs a
    cap-aligned layout (its block index is ``start // cap``).
    ``plain=True`` scores with K5's plain PyTorch version on any
    device."""
    if layout.align != layout.cap:
        raise ValueError(
            "the fixed-cap engine indexes blocks by start/cap and needs a "
            f"cap-aligned layout (align={layout.align}, cap={layout.cap}); "
            "rebuild the layout with align=None or serve with the "
            "grouped engine")
    cap = layout.cap
    mark("prep", queries)
    qe = qk.extend_queries(layout, queries)
    mark("score", queries)
    scores, start_pos = qk.bucket_scores(layout, qe, probe_ids, probe_valid,
                                         plain=plain)
    mark("merge", queries)
    blk = start_pos.long() // cap
    if layout.scale is not None and layout.scale.ndim == 1:
        # per-row int8 dequantisation before the norms bias and the merge
        scores = scores * layout.scale.view(-1, cap)[blk]
    if layout.norms is not None:  # euclidean: 2q.c - ||c||^2
        scores = scores - layout.norms.view(-1, cap)[blk]
    nq, n_probes, _ = scores.shape
    top_scores, arg = _largest_k(scores.reshape(nq, n_probes * cap), k)
    pos = torch.gather(start_pos.long(), 1, arg // cap) + arg % cap
    pos = torch.clamp(pos, 0, layout.n_rows - 1)
    ids = torch.where(torch.isfinite(top_scores), layout.row_map[pos], -1)
    return (ids.to(torch.int32), top_scores,
            _n_candidates(probe_ids, probe_valid, full_counts))


def _chunked_serve(queries, probe_ids, probe_valid, query_chunk: int,
                   bound_fn, call_fn):
    """Pad/chunk/concat scaffold: the tail chunk is padded to the full
    chunk shape (so it gets the same group-table size as in the JAX
    package), ``bound_fn(c_pad, pid)`` sizes a chunk's group table and
    ``call_fn(qs, pid, pv, g_total)`` serves it."""
    nq = queries.shape[0]
    out_ids, out_scores, out_cand = [], [], []
    for s in range(0, nq, query_chunk):
        e = min(s + query_chunk, nq)
        c = e - s
        c_pad = min(query_chunk, nq) if s == 0 else query_chunk
        pid, pv, qs = probe_ids[s:e], probe_valid[s:e], queries[s:e]
        if c < c_pad:
            pid, pv, qs = (_pad_rows(t, c_pad) for t in (pid, pv, qs))
        ids, scores, n_cand = call_fn(qs, pid, pv, bound_fn(c_pad, pid))
        out_ids.append(ids[:c])
        out_scores.append(scores[:c])
        out_cand.append(n_cand[:c])
    return torch.cat(out_ids), torch.cat(out_scores), torch.cat(out_cand)


def _panel_topk(layout: qk.ServingLayout, scores, grp_block, grp_lo, grp_hi,
                k: int, plain: bool):
    """The wide-k branch after K2/K4: per-row scale, then norms, then the
    lane mask (``[grp_lo, grp_hi)``, or ``< grp_hi`` with ``grp_lo``
    None), then each row's top ``min(k, br)``: K8, or its plain version
    where ``plain``."""
    per_row = layout.scale is not None and layout.scale.ndim == 1
    topk = qk.panel_topk_plain if plain else qk.panel_topk
    return topk(scores, grp_block, grp_lo, grp_hi, min(k, layout.br),
                norms=layout.norms,
                scale_rows=layout.scale if per_row else None)


def _merge(layout: qk.ServingLayout, probe_ids, probe_valid, full_counts,
           k: int, row_top, row_lane, ev_row, ev_block, ev_valid):
    """Each query's top ``k`` over its events' per-row winners
    (``row_top``/``row_lane``, ``(g_total * G, kk)``), mapped back to
    corpus ids through the event's block (window) and lane, and its
    summed probed occupancy."""
    br = layout.br
    nq = probe_ids.shape[0]
    n_rows_tab, kk = row_top.shape
    safe_rows = torch.clamp(ev_row.reshape(nq, -1).long(), 0, n_rows_tab - 1)
    ev_top = torch.where(ev_valid.reshape(nq, -1)[:, :, None],
                         row_top[safe_rows], -torch.inf)      # (nq, n_ev, kk)
    ev_lane = row_lane[safe_rows].reshape(nq, -1)
    flat_top = ev_top.reshape(nq, -1)
    k_eff = min(k, flat_top.shape[1])  # row_k < k shrinks the pool
    top_scores, arg = _largest_k(flat_top, k_eff)
    lane_sel = torch.gather(ev_lane, 1, arg).long()
    block_sel = torch.gather(ev_block.reshape(nq, -1), 1, arg // kk).long()
    pos = torch.clamp(block_sel * br + lane_sel, 0, layout.n_rows - 1)
    ids = torch.where(torch.isfinite(top_scores), layout.row_map[pos], -1)
    ids = ids.to(torch.int32)
    if k_eff < k:
        ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
        top_scores = torch.nn.functional.pad(top_scores, (0, k - k_eff),
                                             value=-torch.inf)
    return ids, top_scores, _n_candidates(probe_ids, probe_valid, full_counts)


def _grouped_query(layout: qk.ServingLayout, queries, probe_ids, probe_valid,
                   full_counts, k: int, g_total: int, max_blocks: int,
                   group_q: int, row_k: int | None, plain: bool):
    br = layout.br
    if layout.align % br:
        raise ValueError(
            "the grouped engine indexes blocks by start/block_rows and needs "
            f"block-aligned bucket starts (align={layout.align}, "
            f"block_rows={br})")
    mark("prep", queries)
    qe = qk.extend_queries(layout, queries)
    grp_block, grp_qvecs, grp_cnt, ev_row, ev_block, ev_valid = (
        qk._grouped_prep_v2(layout.starts, layout.counts, probe_ids,
                            probe_valid, qe, layout.cap, g_total=g_total,
                            max_blocks=max_blocks, group_q=group_q,
                            block_rows=br))
    per_row = layout.scale is not None and layout.scale.ndim == 1
    if row_k is None:
        row_k = k
    mark("score", queries)
    if row_k <= qk.ROW_TOPK:
        # K1: only each row's best row_k leave the kernel; row_k per block
        # suffices, since one block holds distinct corpus rows
        topk = qk.grouped_scores_topk_plain if plain else qk.grouped_scores_topk
        row_top, row_lane = topk(
            layout.data, grp_qvecs, grp_block, grp_cnt, kk=row_k,
            block_rows=br, norms=layout.norms,
            scale_rows=layout.scale if per_row else None)
        mark("merge", queries)
        row_top = row_top.reshape(g_total * group_q, -1)
        row_lane = row_lane.reshape(g_total * group_q, -1)
    else:
        panel = qk.grouped_scores_plain if plain else qk.grouped_scores
        scores = panel(layout.data, grp_qvecs, grp_block, block_rows=br)
        mark("merge", queries)
        row_top, row_lane = _panel_topk(layout, scores, grp_block, None,
                                        grp_cnt, k, plain)
    return _merge(layout, probe_ids, probe_valid, full_counts, k, row_top,
                  row_lane, ev_row, ev_block, ev_valid)


def _windowed_query(layout: qk.ServingLayout, queries, probe_ids,
                    probe_valid, full_counts, k: int, g_total: int,
                    max_sub: int, group_q: int, row_k: int | None,
                    plain: bool):
    br = layout.br
    mark("prep", queries)
    qe = qk.extend_queries(layout, queries)
    (grp_window, grp_qvecs, grp_lo, grp_hi, ev_row, ev_window,
     ev_valid) = qk._windowed_prep(
        layout.starts, layout.counts, probe_ids, probe_valid, qe, layout.cap,
        g_total=g_total, max_sub=max_sub, group_q=group_q, block_rows=br)
    per_row = layout.scale is not None and layout.scale.ndim == 1
    if row_k is None:
        row_k = k
    mark("score", queries)
    if row_k <= qk.ROW_TOPK:
        # K3: a window holds distinct corpus rows, so row_k per slot
        # suffices
        topk = (qk.windowed_scores_topk_plain if plain
                else qk.windowed_scores_topk)
        row_top, row_lane = topk(
            layout.data, grp_qvecs, grp_window, grp_lo, grp_hi, kk=row_k,
            block_rows=br, norms=layout.norms,
            scale_rows=layout.scale if per_row else None)
        mark("merge", queries)
        row_top = row_top.reshape(g_total * group_q, -1)
        row_lane = row_lane.reshape(g_total * group_q, -1)
    else:
        # K4 emits raw panels; scale, norms and the [lo, hi) mask follow
        panel = qk.windowed_scores_plain if plain else qk.windowed_scores
        scores = panel(layout.data, grp_qvecs, grp_window, block_rows=br)
        mark("merge", queries)
        row_top, row_lane = _panel_topk(layout, scores, grp_window, grp_lo,
                                        grp_hi, k, plain)
    return _merge(layout, probe_ids, probe_valid, full_counts, k, row_top,
                  row_lane, ev_row, ev_window, ev_valid)


@torch.no_grad()
def serving_query_grouped(layout: qk.ServingLayout, queries, probe_ids,
                          probe_valid, full_counts, k: int,
                          query_chunk: int = 16384,
                          group_q: int = qk.GROUP_W,
                          row_k: int | None = None,
                          g_total_override: int | None = None,
                          plain: bool = False):
    """Bucket-grouped serving (the default engine).

    Returns ``(topk_ids (nq, k) i32, topk_scores (nq, k) f32,
    n_candidates (nq,) i32)``; ids are corpus rows, ``-1``-padded, and
    scores descend (higher = nearer).

    ``row_k`` (default ``k``) bounds the per-block top-k; up to
    ``ROW_TOPK`` it runs fused in K1, above it K2 emits raw panels.  The
    group table is sized by the static bound (no host sync) unless
    ``g_total_override`` gives it.  ``plain=True`` scores with the plain
    PyTorch versions of the kernels on any device: the reference the
    kernels are held to."""
    max_blocks = layout.cap // layout.br

    def bound(c_pad, pid):
        g_bound = (g_total_override if g_total_override is not None
                   else qk.grouped_static_bound(
                       c_pad * pid.shape[1], max_blocks,
                       layout.total_blocks, group_q))
        return qk._round_up(max(g_bound, 1), qk._GROUP_EB)

    def call(qs, pid, pv, g_total):
        return _grouped_query(layout, qs, pid, pv, full_counts, k=k,
                              g_total=g_total, max_blocks=max_blocks,
                              group_q=group_q, row_k=row_k, plain=plain)

    return _chunked_serve(queries, probe_ids, probe_valid, query_chunk,
                          bound, call)


@torch.no_grad()
def serving_query_windowed(layout: qk.ServingLayout, queries, probe_ids,
                           probe_valid, full_counts, k: int,
                           query_chunk: int = 16384,
                           group_q: int = qk.GROUP_W,
                           row_k: int | None = None,
                           g_total_override: int | None = None,
                           plain: bool = False):
    """Dense-window serving: the low-occupancy engine.

    Works on any layout alignment (bucket starts ride as ``[lo, hi)``
    mask values, not block offsets) but pays off on DENSE layouts
    (``align=8``) whose mean bucket is far below ``block_rows``:
    neighbouring buckets share windows, so the group count follows the
    probed windows.  Returns ``(topk_ids (nq, k) i32, topk_scores (nq, k)
    f32, n_candidates (nq,) i32)`` as :func:`serving_query_grouped`.

    ``row_k`` (default ``k``) bounds the per-slot top-k: up to
    ``ROW_TOPK`` fused in K3, above it K4 emits raw panels.  The group
    table is sized by the static bound unless ``g_total_override`` gives
    it; groups past it are DROPPED, so an override must hold for the
    batch (see :func:`qk.windowed_needed_groups`).  ``plain=True``
    scores with the kernels' plain PyTorch versions on any device."""
    max_sub = layout.cap // layout.br + 1
    total_windows = layout.n_rows // layout.br

    def bound(c_pad, pid):
        g_bound = (g_total_override if g_total_override is not None
                   else qk.windowed_static_bound(
                       c_pad * pid.shape[1], max_sub, total_windows, group_q))
        return qk._round_up(max(g_bound, 1), qk._GROUP_EB)

    def call(qs, pid, pv, g_total):
        return _windowed_query(layout, qs, pid, pv, full_counts, k=k,
                               g_total=g_total, max_sub=max_sub,
                               group_q=group_q, row_k=row_k, plain=plain)

    return _chunked_serve(queries, probe_ids, probe_valid, query_chunk,
                          bound, call)
