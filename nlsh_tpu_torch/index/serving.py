"""Grouped serving path: prep -> grouped scoring kernel -> top-k merge.

Port of the grouped half of :mod:`nlsh_tpu.index.serving`.  The (query,
probe) events are sorted by bucket block, every block is scored against
the up to G queries that probe it (kernel K1, or K2 when the per-block k
is above ``ROW_TOPK``), and each query's per-block winners merge into
its top-k corpus ids.  Score order is the exact distance order (the
layout's metric extension makes score monotone in distance), so results
match the gather engine whenever ``layout.cap`` covers the probed
buckets.

K1 returns scores and int32 lanes as two arrays, so the JAX package's
``PACK_W`` panel packing (a TPU gather workaround) has no counterpart.
"""

from __future__ import annotations

import torch

from nlsh_tpu_torch.ops.cuda import query_kernel as qk


def _largest_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of each row, descending, lowest index
    first among equal values (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    pad = torch.zeros((n - t.shape[0],) + t.shape[1:], dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, pad])


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


def _grouped_query(layout: qk.ServingLayout, queries, probe_ids, probe_valid,
                   full_counts, k: int, g_total: int, max_blocks: int,
                   group_q: int, row_k: int | None, plain: bool):
    br = layout.br
    if layout.align % br:
        raise ValueError(
            "the grouped engine indexes blocks by start/block_rows and needs "
            f"block-aligned bucket starts (align={layout.align}, "
            f"block_rows={br})")
    qe = qk.extend_queries(layout, queries)
    grp_block, grp_qvecs, grp_cnt, ev_row, ev_block, ev_valid = (
        qk._grouped_prep_v2(layout.starts, layout.counts, probe_ids,
                            probe_valid, qe, layout.cap, g_total=g_total,
                            max_blocks=max_blocks, group_q=group_q,
                            block_rows=br))
    per_row = layout.scale is not None and layout.scale.ndim == 1
    if row_k is None:
        row_k = k
    if row_k <= qk.ROW_TOPK:
        # K1: only each row's best row_k leave the kernel; row_k per block
        # suffices, since one block holds distinct corpus rows
        topk = qk.grouped_scores_topk_plain if plain else qk.grouped_scores_topk
        row_top, row_lane = topk(
            layout.data, grp_qvecs, grp_block, grp_cnt, kk=row_k,
            block_rows=br, norms=layout.norms,
            scale_rows=layout.scale if per_row else None)
        kk = row_top.shape[2]
        row_top = row_top.reshape(g_total * group_q, kk)
        row_lane = row_lane.reshape(g_total * group_q, kk)
    else:
        panel = qk.grouped_scores_plain if plain else qk.grouped_scores
        scores = panel(layout.data, grp_qvecs, grp_block, block_rows=br)
        blk = grp_block.long()
        if per_row:  # per-row dequant before the bias and the merge
            scores = scores * layout.scale.view(-1, br)[blk][:, None, :]
        if layout.norms is not None:  # euclidean: 2q.c - ||c||^2
            scores = scores - layout.norms.view(-1, br)[blk][:, None, :]
        lane = torch.arange(br, device=scores.device)
        scores = torch.where(lane < grp_cnt[:, :, None], scores, -torch.inf)
        row_top, row_lane = _largest_k(scores.reshape(g_total * group_q, br),
                                       min(k, br))
        kk = row_top.shape[1]

    nq, n_probes = probe_ids.shape
    n_ev = n_probes * max_blocks
    safe_rows = torch.clamp(ev_row.reshape(nq, n_ev).long(), 0,
                            g_total * group_q - 1)
    ev_top = torch.where(ev_valid.reshape(nq, n_ev)[:, :, None],
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
    safe = torch.clamp(probe_ids.long(), 0, full_counts.shape[0] - 1)
    n_cand = torch.sum(torch.where(probe_valid, full_counts[safe], 0), dim=1,
                       dtype=torch.int32)
    return ids, top_scores, n_cand


@torch.no_grad()
def serving_query_grouped(layout: qk.ServingLayout, queries, probe_ids,
                          probe_valid, full_counts, k: int,
                          query_chunk: int = 16384, group_q: int = 32,
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
