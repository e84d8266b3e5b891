"""Batched index query: probe gather -> mask -> exact rerank -> top-k.

Port of :mod:`nlsh_tpu.index.query`, the gather engine: each probed
bucket's rows (up to ``probe_budget``) are gathered from the corpus,
ranked by the exact distance in the original space, and the best ``k``
kept.  It is the port's independent check of the grouped engine.
``n_candidates`` counts the full occupancy of the deduped probes.
"""

from __future__ import annotations

import torch

from nlsh_tpu_torch.index.bucket_table import BucketTable
from nlsh_tpu_torch.ops import distances as D

# Transient candidate-gather buffer target, used to pick the query chunk.
_GATHER_BUDGET_BYTES = 256 * 1024 * 1024


def default_query_chunk(n_probes: int, probe_budget: int, dim: int) -> int:
    per_query = max(n_probes * probe_budget * dim * 4, 1)
    return int(max(8, min(1024, _GATHER_BUDGET_BYTES // per_query)))


def smallest_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row, ascending, the lowest
    index first among equal values — ``jax.lax.top_k(-x)``'s order,
    which ``torch.topk`` does not promise."""
    v, i = torch.sort(x, dim=1, stable=True)
    return v[:, :k], i[:, :k]


@torch.no_grad()
def query_bucket_table(table: BucketTable, corpus: torch.Tensor,
                       queries: torch.Tensor, probe_ids: torch.Tensor,
                       probe_valid: torch.Tensor, k: int, probe_budget: int,
                       metric: str = "cosine", query_chunk: int = 256,
                       n_valid_rows: int | None = None):
    """Answer ``queries`` against the indexed ``corpus``.

    Returns ``(topk_ids (nq, k) int32, topk_dists (nq, k) f32,
    n_candidates (nq,) int32)``: ids ascend by distance and are
    ``-1``-padded (distance ``+inf``) when a query has fewer than ``k``
    candidates.  Rows ``>= n_valid_rows`` are never returned."""
    rowwise = D.get_metric(metric)["rowwise"]
    nq = queries.shape[0]
    n_probes = probe_ids.shape[1]
    n_rows = table.n_rows
    if n_valid_rows is None:
        n_valid_rows = n_rows
    offs = torch.arange(probe_budget, device=corpus.device)
    row_ids = table.row_ids.long()
    out_ids, out_dists, out_cand = [], [], []
    for s in range(0, nq, query_chunk):
        q = queries[s: s + query_chunk]
        pid = probe_ids[s: s + query_chunk].long()
        pvalid = probe_valid[s: s + query_chunk]
        c = q.shape[0]
        safe_pid = torch.clamp(pid, 0, table.n_buckets - 1)
        counts = torch.where(pvalid, table.counts[safe_pid], 0)   # (c, P)
        starts = table.starts[safe_pid].long()                    # (c, P)
        cand_pos = starts[:, :, None] + offs                      # (c, P, B)
        cand_valid = offs[None, None, :] < counts[:, :, None]
        cand_rows = row_ids[torch.clamp(cand_pos, 0, n_rows - 1)]
        cand_rows = cand_rows.reshape(c, n_probes * probe_budget)
        cand_valid = cand_valid.reshape(c, n_probes * probe_budget)
        cand_valid &= cand_rows < n_valid_rows
        dist = rowwise(q[:, None, :], corpus[cand_rows])          # (c, C)
        dist = torch.where(cand_valid, dist, torch.inf)
        kk = min(k, dist.shape[1])
        top_d, arg = smallest_k(dist, kk)
        top_rows = torch.gather(cand_rows, 1, arg)
        top_rows = torch.where(torch.isfinite(top_d), top_rows, -1)
        if kk < k:
            top_rows = torch.nn.functional.pad(top_rows, (0, k - kk), value=-1)
            top_d = torch.nn.functional.pad(top_d, (0, k - kk), value=torch.inf)
        out_ids.append(top_rows.to(torch.int32))
        out_dists.append(top_d)
        out_cand.append(torch.sum(counts, dim=1, dtype=torch.int32))
    return torch.cat(out_ids), torch.cat(out_dists), torch.cat(out_cand)
