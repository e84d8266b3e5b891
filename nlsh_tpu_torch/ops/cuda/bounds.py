"""Least times of the serving kernels on one NVIDIA H100.

For a kernel's actual inputs, count what the function needs: the bytes
it must move (each corpus row that some live lane keeps, each query row
and table read once, each output written once) and its f32 operations
(2 * d per scored (slot, lane) pair: the live pairs of the fused and
masked kernels, the whole panel of the raw ones; K8, the panels' top-k,
reads each live lane's score once and does no dot).  ``d`` is the
metric-extended width of the rows, not the layout's ``d_pad``: the
padding columns are zeros the function does not need, so neither their
bytes nor their operations count.  The bound is the
larger of bytes over the card's HBM rate and operations over its f32
rate on the CUDA cores (the kernels are exact f32, so no tensor cores).
Pure torch on whatever device the inputs are on; ``chip_smoke.py``
reports each kernel's time beside its bound.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nlsh_tpu_torch.ops.cuda.query_kernel import ROW_TOPK

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3 (NVIDIA's data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM, f32 on the CUDA cores


class Counts(NamedTuple):
    bytes: int
    flops: int


def bound(counts: Counts) -> dict:
    """``bound_ms`` (the larger of the two times) and ``bound_by``
    (``"bytes"`` or ``"operations"``), with the counts."""
    t_bytes = counts.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = counts.flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": counts.bytes, "flops": counts.flops}


def rows_covered(n_rows: int, first: torch.Tensor, last: torch.Tensor) -> int:
    """How many of ``n_rows`` rows lie in at least one ``[first, last)``
    interval (each row counted once, however many intervals cover it)."""
    first, last = first.reshape(-1).long(), last.reshape(-1).long()
    ok = last > first
    diff = torch.zeros(n_rows + 1, dtype=torch.int64, device=first.device)
    diff.index_add_(0, first[ok], torch.ones_like(first[ok]))
    diff.index_add_(0, last[ok], -torch.ones_like(last[ok]))
    return int((torch.cumsum(diff, 0)[:n_rows] > 0).sum())


def topk_counts(data, grp_qvecs, grp_block, grp_lo, grp_hi, kk: int, br: int,
                d: int, norms=None, scale_rows=None) -> Counts:
    """K1 (``grp_lo`` None: slot lanes ``[0, grp_hi)``) and K3 (lanes
    ``[grp_lo, grp_hi)``): the ``d`` features of the live lanes' rows,
    once, with their norms and scales; the live slots' query rows; the
    group tables; the ``(g_total, G, kk)`` scores and lanes."""
    g_total, G, _ = grp_qvecs.shape
    kk = min(max(int(kk), 1), ROW_TOPK)
    hi = grp_hi.long().clamp(0, br)
    lo = torch.zeros_like(hi) if grp_lo is None else grp_lo.long().clamp(0, br)
    live = hi > lo
    n_blocks = data.shape[0] // br
    row0 = (grp_block.long().clamp(0, n_blocks - 1) * br)[:, None]
    rows = rows_covered(data.shape[0], (row0 + lo)[live], (row0 + hi)[live])
    per_row = d * data.element_size() + 4 * (norms is not None) \
        + 4 * (scale_rows is not None)
    tables = 4 * g_total * (1 + G * (1 if grp_lo is None else 2))
    n_bytes = rows * per_row + int(live.sum()) * d * 4 + tables \
        + g_total * G * kk * 8
    return Counts(n_bytes, 2 * d * int((hi - lo)[live].sum()))


def panel_counts(data, queries, grp_block, G: int, br: int, d: int) -> Counts:
    """K2, K4 (``queries`` = ``grp_qvecs``) and K7 (``queries`` = the one
    query panel): the ``d`` features of each distinct block's rows once,
    the queries, the block table and the ``(g_total, G, br)`` panels;
    every pair is scored."""
    g_total = grp_block.numel()
    n_blocks = data.shape[0] // br
    blocks = torch.unique(grp_block.long().clamp(0, n_blocks - 1)).numel()
    n_queries = queries.numel() // queries.shape[-1]
    n_bytes = blocks * br * d * data.element_size() + n_queries * d * 4 \
        + 4 * g_total + g_total * G * br * 4
    return Counts(n_bytes, 2 * d * g_total * G * br)


def panel_topk_counts(scores, grp_block, grp_lo, grp_hi, kk: int,
                      norms=None, scale_rows=None) -> Counts:
    """K8 (``grp_lo`` None: slot lanes ``[0, grp_hi)``): the live lanes of
    the ``(g_total, G, br)`` panel ``scores``, once, with the scale and
    norm of each distinct row they cover; the slot tables (and the block
    table where rows are read); the ``(g_total * G, kk)`` scores and
    lanes.  Its f32 operations are the scale and the bias of each live
    lane."""
    g_total, G, br = scores.shape
    kk = min(max(int(kk), 1), br)
    hi = grp_hi.long().clamp(0, br)
    lo = torch.zeros_like(hi) if grp_lo is None else grp_lo.long().clamp(0, br)
    live = hi > lo
    lanes = int((hi - lo)[live].sum())
    per_row = [t for t in (norms, scale_rows) if t is not None]
    n_bytes = 4 * lanes + 4 * g_total * G * (1 if grp_lo is None else 2) \
        + g_total * G * kk * 8
    if per_row:
        n_blocks = per_row[0].shape[0] // br
        row0 = (grp_block.long().clamp(0, n_blocks - 1) * br)[:, None]
        rows = rows_covered(n_blocks * br, (row0 + lo)[live],
                            (row0 + hi)[live])
        n_bytes += 4 * rows * len(per_row) + 4 * g_total
    return Counts(n_bytes, lanes * len(per_row))


def bucket_counts(data, queries_ext, first_rows, counts, cap: int,
                  d: int) -> Counts:
    """K5 and K6: the ``d`` features of each event's rows ``[first, first
    + min(count, cap))`` (the union, once), the queries, the two event
    tables and the ``(nq, P, cap)`` scores."""
    nq, n_probes = counts.shape
    cnt = counts.long().clamp(0, cap)
    first = first_rows.long()
    rows = rows_covered(data.shape[0], first, first + cnt)
    n_bytes = rows * d * data.element_size() + queries_ext.shape[0] * d * 4 \
        + 2 * 4 * nq * n_probes + nq * n_probes * cap * 4
    return Counts(n_bytes, 2 * d * int(cnt.sum()))
