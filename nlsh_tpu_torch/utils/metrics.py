"""Evaluation metrics (port of :mod:`nlsh_tpu.utils.metrics`)."""

from __future__ import annotations

import numpy as np
import torch


def recall_matrix(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-query recall ``|true ∩ pred| / k_true`` as ``(n,)`` float32.
    Predicted ids < 0 are padding and never match."""
    matches = (y_true[:, :, None] == y_pred[:, None, :]) & (y_true[:, :, None] >= 0)
    hits = torch.any(matches, dim=-1).to(torch.float32)
    # the sum times the f32 reciprocal of k_true, as XLA computes jnp.mean
    # (a true division rounds 9 / 10 one ulp below 9 * 0.1)
    return hits.sum(dim=-1) * (1.0 / hits.shape[-1])


def calculate_recall(y_true, y_pred, reduce_func=None):
    """Per-query recalls of id arrays (numpy or tensors), or
    ``reduce_func`` of them."""
    y_true = torch.as_tensor(np.asarray(y_true))
    y_pred = torch.as_tensor(np.asarray(y_pred))
    if y_true.shape[0] != y_pred.shape[0]:
        raise ValueError(f"{y_true.shape[0]} true rows vs {y_pred.shape[0]} predicted")
    recalls = recall_matrix(y_true, y_pred).numpy()
    if reduce_func is not None:
        return reduce_func(recalls)
    return list(recalls)
