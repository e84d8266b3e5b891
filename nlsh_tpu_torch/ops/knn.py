"""Tiled brute-force k-nearest-neighbour search.

Port of :mod:`nlsh_tpu.ops.knn`: the ground truth of
:class:`nlsh_tpu_torch.data.SyntheticDataset` and the exact-search
baseline.  The distance matrix is never materialised: corpus chunks are
scanned, one ``(query_tile, chunk)`` pairwise block per step (one exact
f32 matmul) folded into a running top-k, so memory is
O(query_tile * chunk) whatever the corpus size.  Among equal distances
the lowest corpus id wins, as ``jax.lax.top_k`` decides it there: every
selection is a stable sort (``torch.topk`` promises no order).
"""

from __future__ import annotations

import numpy as np
import torch

from nlsh_tpu_torch.index.query import smallest_k
from nlsh_tpu_torch.ops import distances as D


@torch.no_grad()
def knn(queries, corpus, k: int, metric: str = "cosine", *, device,
        query_tile: int = 512, corpus_chunk: int = 65536,
        exclude_self: bool = False, query_ids=None):
    """Exact k-NN of ``queries`` ``(nq, d)`` against ``corpus`` ``(n, d)``
    (numpy or tensors), computed on ``device``.

    ``exclude_self`` masks candidates whose corpus row id equals the
    query's own id (``query_ids``, ``(nq,)``).  Returns ``(dists, ids)``
    tensors on ``device`` of shape ``(nq, k)``, ascending distance, ids
    int32 (``-1`` with distance ``inf`` past the corpus)."""
    pairwise = D.get_metric(metric)["pairwise"]
    device = torch.device(device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=device)
    corpus = torch.as_tensor(corpus, dtype=torch.float32, device=device)
    nq, n = queries.shape[0], corpus.shape[0]
    corpus_chunk = min(corpus_chunk, max(k, n))
    if query_ids is None:
        query_ids = torch.full((nq,), -1, dtype=torch.int32, device=device)
    query_ids = torch.as_tensor(query_ids, device=device).to(torch.int32)
    out_d, out_i = [], []
    for s in range(0, nq, query_tile):
        q, qid = queries[s: s + query_tile], query_ids[s: s + query_tile]
        best_d = torch.full((q.shape[0], k), torch.inf, device=device)
        best_i = torch.full((q.shape[0], k), -1, dtype=torch.int32,
                            device=device)
        for c in range(0, n, corpus_chunk):
            dist = pairwise(q, corpus[c: c + corpus_chunk])
            ids = torch.arange(c, c + dist.shape[1], dtype=torch.int32,
                               device=device)
            if exclude_self:
                dist = torch.where(ids[None, :] == qid[:, None], torch.inf,
                                   dist)
            # the running best comes first (and holds the lower ids), so the
            # stable sort keeps the lowest id among equal distances
            all_d = torch.cat([best_d, dist], dim=1)
            all_i = torch.cat([best_i, ids[None, :].expand_as(dist)], dim=1)
            best_d, arg = smallest_k(all_d, k)
            best_i = torch.gather(all_i, 1, arg)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def self_knn(corpus, k: int, metric: str = "cosine", *, device,
             query_tile: int = 512, corpus_chunk: int = 65536):
    """Self k-NN of a corpus, excluding each row itself by an explicit id
    mask (robust when duplicate rows make "self" not the unique
    nearest).  Returns ``(n, k)`` int32 neighbour ids on ``device``."""
    ids = np.arange(corpus.shape[0], dtype=np.int32)
    _, nbr = knn(corpus, corpus, k, metric=metric, device=device,
                 query_tile=query_tile, corpus_chunk=corpus_chunk,
                 exclude_self=True, query_ids=ids)
    return nbr
