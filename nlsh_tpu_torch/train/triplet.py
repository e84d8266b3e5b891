"""Triplet trainer (port of :mod:`nlsh_tpu.train.triplet`).

Batches are (anchor, positive, negative): the positive is a random column
of the anchor's ground-truth kNN, the negative is drawn by one of

* ``random``: a uniform corpus row;
* ``nearest``: per epoch, the corpus row whose *code* is closest to the
  anchor's, excluding the anchor itself and its positives (a chunked
  masked argmin over the encoded corpus, the lowest id on ties);
* ``hard``: within the batch, the nearest in-code anchor whose row is
  not among the anchor's positives;
* ``semi-hard``: the nearest such anchor with ``d(a, n) > d(a, p)``,
  falling back to ``hard`` where none qualifies.

``balance_lambda`` adds the bucket-balance regulariser (the band-balance
one for product-quantisation heads).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nlsh_tpu_torch.ops.code_distances import (
    band_balance_loss,
    bucket_balance_loss,
    clip,
)
from nlsh_tpu_torch.train.base import Trainer, _corpus_tensor

NSM_RANDOM = "random"
NSM_NEAREST = "nearest"
NSM_HARD = "hard"
NSM_SEMI_HARD = "semi-hard"


def triplet_loss(anchor, pos, neg, distance_rowwise, margin: float = 0.1):
    """Margin hinge over code distances."""
    d_pos = distance_rowwise(anchor, pos)
    d_neg = distance_rowwise(anchor, neg)
    return torch.mean(clip(d_pos - d_neg + margin, 0.0))


@torch.no_grad()
def nearest_exclude_positive(hashing: nn.Module, corpus: torch.Tensor,
                             positive_idx: torch.Tensor, k: int,
                             chunk: int = 256) -> torch.Tensor:
    """Per corpus row, the id of the nearest-in-code-space row that is
    neither itself nor one of its first ``k`` positives; ``(n,)`` int64
    on the corpus's device, the lowest id among equal distances."""
    n = corpus.shape[0]
    codes = hashing.predict(corpus)
    pairwise = hashing.code_distance.pairwise
    pos = positive_idx[:, :k].to(device=corpus.device, dtype=torch.int64)
    out = []
    for start in range(0, n, chunk):
        dist = pairwise(codes[start:start + chunk], codes)     # (c, n)
        rows = torch.arange(start, start + dist.shape[0], device=corpus.device)
        invalid = torch.zeros_like(dist, dtype=torch.bool)
        invalid[torch.arange(dist.shape[0], device=corpus.device), rows] = True
        invalid.scatter_(1, pos[start:start + chunk], True)
        out.append(torch.argmin(torch.where(invalid, torch.inf, dist), dim=1))
    return torch.cat(out)


class TripletTrainer(Trainer):
    """``lambda1`` is accepted and unused, as in the reference loss."""

    def __init__(self, hashing, data, model_save_dir=None, logger=None,
                 lambda1: float = 0.001, margin: float = 0.1,
                 positive_k: int | None = None,
                 negative_sampling_method: str = NSM_RANDOM,
                 balance_lambda: float = 0.0):
        super().__init__(hashing, data, model_save_dir, logger)
        self.lambda1 = lambda1
        self.margin = margin
        self.positive_k = positive_k
        self.balance_lambda = balance_lambda
        if negative_sampling_method not in (NSM_RANDOM, NSM_NEAREST, NSM_HARD,
                                            NSM_SEMI_HARD):
            raise ValueError(negative_sampling_method)
        self.negative_sampling_method = negative_sampling_method

    def _k(self, knn_cols: int) -> int:
        return self.positive_k or knn_cols

    def epoch_arrays(self, generator, params):
        n = self.data.training.shape[0]
        knn = np.asarray(self.data.training_self_knn)
        k = self._k(knn.shape[1])
        arrays = {"anchor": torch.randperm(n, generator=generator),
                  "col": torch.randint(0, k, (n,), generator=generator)}
        if self.negative_sampling_method == NSM_RANDOM:
            arrays["neg"] = torch.randint(0, n, (n,), generator=generator)
        elif self.negative_sampling_method == NSM_NEAREST:
            hashing = params["hashing"]
            device = next(hashing.parameters()).device
            arrays["neg"] = nearest_exclude_positive(
                hashing, _corpus_tensor(self.data, device),
                torch.as_tensor(knn.astype(np.int64)), k=min(k, knn.shape[1]))
        # hard / semi-hard mine within the batch inside loss_fn
        return arrays

    def _balance(self, hashing, x):
        if self.balance_lambda <= 0:
            return 0.0
        if hasattr(hashing, "_band_probs"):
            # product quantisation: the bucket histogram factorises over bands
            return self.balance_lambda * band_balance_loss(hashing._band_probs(x))
        return self.balance_lambda * bucket_balance_loss(hashing.probs(x))

    def loss_fn(self, params, corpus, knn, batch, generator):
        hashing = params["hashing"]
        anchor_idx = batch["anchor"]
        pos_idx = knn[anchor_idx, batch["col"]]
        a = hashing.predict(corpus[anchor_idx])
        p = hashing.predict(corpus[pos_idx])
        dist = hashing.code_distance
        balance = self._balance(hashing, corpus[anchor_idx])

        if self.negative_sampling_method in (NSM_RANDOM, NSM_NEAREST):
            n_code = hashing.predict(corpus[batch["neg"]])
            return triplet_loss(a, p, n_code, dist.rowwise, self.margin) + balance

        # batch-mined negatives: candidate j is invalid for anchor i if
        # j == i or row_j is among pos(i)
        k = self._k(knn.shape[1])
        pairwise_d = dist.pairwise(a, a.detach())                # (b, b)
        bs = anchor_idx.shape[0]
        is_self = torch.eye(bs, dtype=torch.bool, device=a.device)
        pos_rows = knn[anchor_idx, :k]                           # (b, k)
        is_pos = torch.any(anchor_idx[None, None, :] == pos_rows[:, :, None],
                           dim=1)
        invalid = is_self | is_pos
        d_pos = dist.rowwise(a, p)
        if self.negative_sampling_method == NSM_SEMI_HARD:
            semi_invalid = invalid | (pairwise_d <= d_pos[:, None])
            has_semi = torch.any(~semi_invalid, dim=1)
            neg_j = torch.where(
                has_semi,
                torch.argmin(torch.where(semi_invalid, torch.inf, pairwise_d), 1),
                torch.argmin(torch.where(invalid, torch.inf, pairwise_d), 1))
        else:
            neg_j = torch.argmin(torch.where(invalid, torch.inf, pairwise_d), 1)
        d_neg = dist.rowwise(a, a[neg_j])
        return torch.mean(clip(d_pos - d_neg + self.margin, 0.0)) + balance
