"""Siamese / contrastive trainer (port of :mod:`nlsh_tpu.train.siamese`).

Per epoch each anchor is labelled positive with probability
``positive_rate``; positives are a random column of the anchor's
ground-truth kNN, negatives uniform corpus rows.  ``locally`` draws the
negatives from the kNN ring ``inner_k..outer_k`` instead.
"""

from __future__ import annotations

import numpy as np
import torch

from nlsh_tpu_torch.ops.code_distances import clip
from nlsh_tpu_torch.train.base import Trainer


def contrastive_loss(anchor, other, label, distance_rowwise,
                     negative_margin: float = 0.1,
                     positive_margin: float = 0.0):
    d = distance_rowwise(anchor, other)
    positive_loss = label * clip(d - positive_margin, 0.0) ** 2
    negative_loss = (1.0 - label) * clip(d - negative_margin, hi=0.0) ** 2
    return torch.mean(positive_loss + negative_loss) / 2.0


class SiameseTrainer(Trainer):
    """``positive_k`` defaults to the ground truth's width; ``lambda1``
    is accepted and unused."""

    def __init__(self, hashing, data, model_save_dir=None, logger=None,
                 lambda1: float = 0.001, positive_margin: float = 0.0,
                 negative_margin: float = 0.1, positive_rate: float = 0.1,
                 positive_k: int | None = None, locally: bool = False,
                 inner_k: int | None = None, outer_k: int | None = None):
        super().__init__(hashing, data, model_save_dir, logger)
        self.lambda1 = lambda1
        self.positive_margin = positive_margin
        self.negative_margin = negative_margin
        self.positive_rate = positive_rate
        self.positive_k = positive_k
        self.locally = locally
        self.inner_k = inner_k
        self.outer_k = outer_k

    def epoch_arrays(self, generator, params):
        n = self.data.training.shape[0]
        knn_cols = np.asarray(self.data.training_self_knn).shape[1]
        arrays = {
            "anchor": torch.randperm(n, generator=generator),
            "label": (torch.rand(n, generator=generator)
                      < self.positive_rate).to(torch.float32),
        }
        if self.locally:
            inner = self.inner_k or knn_cols // 2
            outer = self.outer_k or knn_cols
            if outer <= inner:
                raise ValueError(f"Outer K (got {outer}) should be larger "
                                 f"than inner K (got {inner}).")
            arrays["pos_col"] = torch.randint(0, inner, (n,), generator=generator)
            arrays["neg_col"] = torch.randint(inner, outer, (n,),
                                              generator=generator)
        else:
            k = self.positive_k or knn_cols
            arrays["pos_col"] = torch.randint(0, k, (n,), generator=generator)
            arrays["neg"] = torch.randint(0, n, (n,), generator=generator)
        return arrays

    def loss_fn(self, params, corpus, knn, batch, generator):
        hashing = params["hashing"]
        anchor_idx = batch["anchor"]
        pos_idx = knn[anchor_idx, batch["pos_col"]]
        neg_idx = knn[anchor_idx, batch["neg_col"]] if self.locally \
            else batch["neg"]
        label = batch["label"]
        other_idx = torch.where(label > 0.5, pos_idx, neg_idx)
        a = hashing.predict(corpus[anchor_idx])
        o = hashing.predict(corpus[other_idx])
        return contrastive_loss(a, o, label, hashing.code_distance.rowwise,
                                negative_margin=self.negative_margin,
                                positive_margin=self.positive_margin)
