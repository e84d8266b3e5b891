"""Vector-space (data) metrics: cosine and Euclidean.

Port of :mod:`nlsh_tpu.ops.distances`, the part the gather engine uses:

* ``rowwise(p, q)``:  ``(n, d) x (n, d) -> (n,)`` (broadcasting)
* ``pairwise(p, q)``: ``(n, d) x (m, d) -> (n, m)``, and batched
  ``(b, n, d) x (b, m, d) -> (b, n, m)``
"""

from __future__ import annotations

from typing import Callable

import torch

_EPS = 1e-12


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = _EPS) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def cosine_rowwise(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """1 - cos(p_i, q_i); broadcasts ``(d,) x (m, d) -> (m,)``."""
    dot = torch.sum(p * q, dim=-1)
    pn = torch.linalg.vector_norm(p, dim=-1)
    qn = torch.linalg.vector_norm(q, dim=-1)
    return 1.0 - dot / torch.clamp(pn * qn, min=_EPS)


def cosine_pairwise(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return 1.0 - l2_normalize(p) @ l2_normalize(q).transpose(-1, -2)


def sq_l2_rowwise(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    d = p - q
    return torch.sum(d * d, dim=-1)


def sq_l2_pairwise(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``||p_i - q_j||^2`` via the matmul expansion."""
    p_sq = torch.sum(p * p, dim=-1, keepdim=True)      # (n, 1)
    q_sq = torch.sum(q * q, dim=-1, keepdim=True).transpose(-1, -2)  # (1, m)
    return torch.clamp(p_sq + q_sq - 2.0 * (p @ q.transpose(-1, -2)), min=0.0)


def l2_rowwise(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq_l2_rowwise(p, q) + _EPS)


def l2_pairwise(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq_l2_pairwise(p, q) + _EPS)


Metric = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

METRICS: dict[str, dict[str, Metric]] = {
    "cosine": {"rowwise": cosine_rowwise, "pairwise": cosine_pairwise},
    "euclidean": {"rowwise": l2_rowwise, "pairwise": l2_pairwise},
    "sq_euclidean": {"rowwise": sq_l2_rowwise, "pairwise": sq_l2_pairwise},
}


def get_metric(name: str) -> dict[str, Metric]:
    try:
        return METRICS[name]
    except KeyError:
        raise ValueError(f"unknown metric {name!r}; one of {sorted(METRICS)}")
