"""Distances in *code / probability* space, used by the training losses.

Port of :mod:`nlsh_tpu.ops.code_distances`.  Each distance family has
three shapes:

* ``rowwise(p, q)``:      ``(n, k) x (n, k)     -> (n,)``
* ``pairwise(p, q)``:     ``(n, k) x (m, k)     -> (n, m)``
* ``row_pairwise(p, q)``: ``(n, m, k) x (n, p, k) -> (n, m, p)``

The JAX package's quirks are kept, each on purpose (``PARITY.md``):

* Bernoulli KL ``rowwise`` takes the **mean** over bits while
  ``pairwise``/``row_pairwise`` take the **sum**;
* ``MVBernoulliL2.pairwise`` returns **squared** distances while its
  ``rowwise``/``row_pairwise`` return the true L2;
* ``MVBernoulliMeanKLDivergence`` adds the q->p term **transposed** in
  ``pairwise``/``row_pairwise`` (the correct symmetrisation);
* ``MVBernoulliTanhCosine.row_pairwise`` normalises along the k axis.

Gradients follow JAX's at ties, where torch's own rules differ:
``jnp.maximum``, ``jnp.minimum`` and ``jnp.clip`` give each side half
the gradient at equality, as ``torch.maximum``/``torch.minimum`` with a
tensor bound do (``torch.clamp`` gives all of it to the input), so
every clip here is :func:`clip`.  A vector's norm is
``sqrt(sum(x * x))``, whose gradient at the zero vector is NaN as
``jnp.linalg.norm``'s is (``torch.linalg.vector_norm`` gives 0).
"""

from __future__ import annotations

import math

import torch

_DEFAULT_EPS = 1e-16
_Q_FLOOR = 1e-20  # the reference's hardcoded denominator guard


def clip(x: torch.Tensor, lo: float | None = None,
         hi: float | None = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient: half to each side where
    ``x`` equals a bound."""
    # the bounds are filled on the device: torch.tensor(lo, device=...)
    # copies from the host, which waits for the stream on every call
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """``jnp.linalg.norm`` along ``dim``, NaN gradient at zero included."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


# ---------------------------------------------------------------------------
# functional forms
# ---------------------------------------------------------------------------

def jsd_categorical(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon divergence between rows of categoricals
    (``(..., k) -> (...)``), with 0 log 0 = 0."""
    m = (p + q) / 2.0

    def _kl(a, b):
        ratio = torch.log(a) - torch.log(b)
        return torch.sum(torch.where(a > 0, a * ratio, 0.0), dim=-1)

    return (_kl(p, m) + _kl(q, m)) / 2.0


def hellinger_categorical(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hellinger distance between rows of categoricals:
    ``(..., k) x (..., k) -> (...)``; NaN gradient at equal rows."""
    return norm(torch.sqrt(p) - torch.sqrt(q)) / math.sqrt(2.0)


def kl_multivariate_bernoulli(p, q, epsilon: float = _DEFAULT_EPS):
    """Mean-over-bits KL between multivariate Bernoullis, with the
    reference's asymmetric epsilon placement: ``(..., k) -> (...)``."""
    positive = p * torch.log(epsilon + p / (q + _Q_FLOOR))
    negative = (1.0 - p) * torch.log(epsilon + (1.0 - p) / (1.0 - q + _Q_FLOOR))
    return torch.mean(positive + negative, dim=-1)


def _pairwise_kl_mvb(p, q, epsilon: float):
    """Sum-over-bits pairwise Bernoulli KL: ``(n, k) x (m, k) -> (n, m)``."""
    log_p_q = torch.log(epsilon + torch.einsum("nk,mk->nmk", p,
                                               1.0 / (q + _Q_FLOOR)))
    positive = torch.sum(p[:, None, :] * log_p_q, dim=-1)
    log_np_nq = torch.log(epsilon + torch.einsum(
        "nk,mk->nmk", 1.0 - p, 1.0 / (1.0 - q + _Q_FLOOR)))
    negative = torch.sum((1.0 - p[:, None, :]) * log_np_nq, dim=-1)
    return positive + negative


def _row_pairwise_kl_mvb(p, q, epsilon: float):
    """``(n, m, k) x (n, p, k) -> (n, m, p)``."""
    log_p_q = torch.log(epsilon + torch.einsum("nmk,npk->nmpk", p,
                                               1.0 / (q + _Q_FLOOR)))
    positive = torch.sum(p[:, :, None, :] * log_p_q, dim=-1)
    log_np_nq = torch.log(epsilon + torch.einsum(
        "nmk,npk->nmpk", 1.0 - p, 1.0 / (1.0 - q + _Q_FLOOR)))
    negative = torch.sum((1.0 - p[:, :, None, :]) * log_np_nq, dim=-1)
    return positive + negative


def entropy_multivariate_bernoulli(p, epsilon: float = _DEFAULT_EPS):
    """Mean-over-bits entropy."""
    positive = -p * torch.log(p + epsilon)
    negative = -(1.0 - p) * torch.log(1.0 - p + epsilon)
    return torch.mean(positive + negative, dim=-1)


def cross_entropy_multivariate_bernoulli(p, q, epsilon: float = _Q_FLOOR):
    """KL + the entropy of p, both mean over bits; note the epsilon
    default, ``_Q_FLOOR``, not :func:`kl_multivariate_bernoulli`'s."""
    return kl_multivariate_bernoulli(p, q, epsilon) + \
        entropy_multivariate_bernoulli(p, epsilon)


def _sq_norm(x, keepdim=False):
    return torch.sum(x * x, dim=-1, keepdim=keepdim)


# ---------------------------------------------------------------------------
# distance families
# ---------------------------------------------------------------------------

class MVBernoulliKLDivergence:
    def __init__(self, epsilon: float = _Q_FLOOR):
        self.epsilon = epsilon

    def rowwise(self, p, q):
        return kl_multivariate_bernoulli(p, q, self.epsilon)

    def pairwise(self, p, q):
        return _pairwise_kl_mvb(p, q, self.epsilon)

    def row_pairwise(self, p, q):
        return _row_pairwise_kl_mvb(p, q, self.epsilon)


class MVBernoulliMeanKLDivergence:
    """Symmetrised KL; the q->p term is added transposed, so cell
    (i, j) is ``(KL(p_i||q_j) + KL(q_j||p_i)) / 2``."""

    def __init__(self, epsilon: float = _Q_FLOOR):
        self.epsilon = epsilon

    def rowwise(self, p, q):
        return (kl_multivariate_bernoulli(p, q, self.epsilon)
                + kl_multivariate_bernoulli(q, p, self.epsilon)) / 2.0

    def pairwise(self, p, q):
        return (_pairwise_kl_mvb(p, q, self.epsilon)
                + _pairwise_kl_mvb(q, p, self.epsilon).T) / 2.0

    def row_pairwise(self, p, q):
        kl_pq = _row_pairwise_kl_mvb(p, q, self.epsilon)
        kl_qp = _row_pairwise_kl_mvb(q, p, self.epsilon)
        return (kl_pq + kl_qp.transpose(-1, -2)) / 2.0


class MVBernoulliCrossEntropy:
    """KL + the entropy of p."""

    def __init__(self, epsilon: float = _Q_FLOOR):
        self.epsilon = epsilon

    def rowwise(self, p, q):
        return cross_entropy_multivariate_bernoulli(p, q, self.epsilon)

    def pairwise(self, p, q):
        return _pairwise_kl_mvb(p, q, self.epsilon) + \
            entropy_multivariate_bernoulli(p, self.epsilon)[:, None]

    def row_pairwise(self, p, q):
        return _row_pairwise_kl_mvb(p, q, self.epsilon) + \
            entropy_multivariate_bernoulli(p, self.epsilon)[:, :, None]


class MVBernoulliL2:
    """L2 in probability space; ``pairwise`` is *squared*."""

    def rowwise(self, p, q):
        d = p - q
        return torch.sqrt(_sq_norm(d) + 1e-12)

    def pairwise(self, p, q):
        return _sq_norm(p, True) + _sq_norm(q, True).T - 2.0 * (p @ q.T)

    def row_pairwise(self, p, q):
        cross = torch.einsum("nmk,npk->nmp", p, q)
        sq = _sq_norm(p)[:, :, None] + _sq_norm(q)[:, None, :] - 2.0 * cross
        return torch.sqrt(clip(sq, 0.0) + 1e-12)


class MVBernoulliTanhCosine:
    """Cosine distance on tanh codes."""

    @staticmethod
    def _normalize(x):
        return x / clip(norm(x, keepdim=True), 1e-12)

    def rowwise(self, p, q):
        return 1.0 - torch.sum(self._normalize(p) * self._normalize(q), dim=-1)

    def pairwise(self, p, q):
        return 1.0 - self._normalize(p) @ self._normalize(q).T

    def row_pairwise(self, p, q):
        return 1.0 - torch.einsum("nmk,npk->nmp", self._normalize(p),
                                  self._normalize(q))


class CategoricalL2:
    """L2 between categorical probability rows."""

    def rowwise(self, p, q):
        d = p - q
        return torch.sqrt(_sq_norm(d) + 1e-12)

    def pairwise(self, p, q):
        sq = _sq_norm(p, True) + _sq_norm(q, True).T - 2.0 * (p @ q.T)
        return torch.sqrt(clip(sq, 0.0) + 1e-12)

    def row_pairwise(self, p, q):
        cross = torch.einsum("nmk,npk->nmp", p, q)
        sq = _sq_norm(p)[:, :, None] + _sq_norm(q)[:, None, :] - 2.0 * cross
        return torch.sqrt(clip(sq, 0.0) + 1e-12)


class CategoricalJSD:
    """JSD between categorical rows."""

    def rowwise(self, p, q):
        return jsd_categorical(p, q)

    def pairwise(self, p, q):
        return jsd_categorical(p[:, None, :], q[None, :, :])

    def row_pairwise(self, p, q):
        return jsd_categorical(p[:, :, None, :], q[:, None, :, :])


# keyed by the CLI's --distance_type values
CODE_DISTANCES = {
    "L2": MVBernoulliL2,
    "KL": MVBernoulliKLDivergence,
    "MeanKL": MVBernoulliMeanKLDivergence,
    "CrossEntropy": MVBernoulliCrossEntropy,
    "Cosine": MVBernoulliTanhCosine,
    "JS": CategoricalJSD,
    "CategoricalL2": CategoricalL2,
}


def code_distance_name(distance) -> str:
    """The registry key of a code distance instance."""
    for name, cls in CODE_DISTANCES.items():
        if type(distance) is cls:
            return name
    raise ValueError(f"{type(distance).__name__} is not a registered "
                     "code distance")


def _balance_terms(log_bucket, epsilon: float):
    """KL(mean bucket distribution || uniform) and the mean per-sample
    entropy of ``(batch, NB)`` log bucket probabilities."""
    p_bucket = torch.exp(log_bucket)
    q = torch.mean(p_bucket, dim=0)
    kl_uniform = torch.sum(q * torch.log(q * log_bucket.shape[1] + epsilon))
    sample_entropy = -torch.mean(torch.sum(p_bucket * log_bucket, dim=1))
    return kl_uniform, sample_entropy


def bucket_balance_loss(probs, confidence_weight: float = 0.3,
                        epsilon: float = 1e-12):
    """Bucket load-balancing regulariser for Bernoulli bit codes: the
    exact expected bucket distribution of ``(batch, bits)`` per-bit
    probabilities (bits <= 16), one log-space product against the
    enumerated codes; KL of the batch mean from uniform plus
    ``confidence_weight`` times the mean per-sample entropy."""
    bits = probs.shape[-1]
    if bits > 16:
        raise ValueError(f"balance loss materialises 2^bits buckets; {bits} > 16")
    n_buckets = 2 ** bits
    shifts = torch.arange(bits - 1, -1, -1, device=probs.device)
    codes = ((torch.arange(n_buckets, device=probs.device)[:, None] >> shifts)
             & 1).to(probs.dtype)                              # (NB, bits)
    # away from saturation: 1/p gradients explode once the confidence
    # term drives bits hard to 0/1
    probs = clip(probs, 1e-6, 1.0 - 1e-6)
    log_bucket = torch.log(probs) @ codes.T + torch.log(1.0 - probs) @ (1.0 - codes).T
    kl_uniform, sample_entropy = _balance_terms(log_bucket, epsilon)
    return kl_uniform + confidence_weight * sample_entropy


MAX_JOINT_BITS = 14  # (batch, 2^bits) histogram memory cap


def band_balance_loss(band_probs, confidence_weight: float = 0.3,
                      epsilon: float = 1e-12):
    """:func:`bucket_balance_loss` for product-quantisation heads
    (``(batch, n_bands, band_size)`` per-band softmaxes): the exact JOINT
    bucket distribution over all ``B**M`` buckets up to
    ``MAX_JOINT_BITS`` total bits, else per-band marginals plus the
    confidence term (a weaker proxy)."""
    p = clip(band_probs, 1e-9, 1.0)
    _, n_bands, band_size = p.shape
    bits_per_band = int(math.log2(band_size))
    total_bits = n_bands * bits_per_band
    if 2 ** total_bits == band_size ** n_bands and total_bits <= MAX_JOINT_BITS:
        nb = band_size ** n_bands
        # codes[j, m] = band m's sub-code of bucket j (band 0 high bits)
        shifts = bits_per_band * torch.arange(n_bands - 1, -1, -1,
                                              device=p.device)
        codes = (torch.arange(nb, device=p.device)[:, None] >> shifts) \
            & (band_size - 1)
        onehot = (codes[..., None] == torch.arange(
            band_size, device=p.device)).to(p.dtype)           # (NB, M, B)
        log_bucket = torch.einsum("bmc,nmc->bn", torch.log(p), onehot)
        kl_uniform, sample_entropy = _balance_terms(log_bucket, epsilon)
        return kl_uniform + confidence_weight * sample_entropy
    q = torch.mean(p, dim=0)                                   # (M, B)
    q = q / torch.sum(q, dim=-1, keepdim=True)
    kl_uniform = torch.sum(q * torch.log(q * band_size + epsilon))
    sample_entropy = -torch.mean(torch.sum(torch.sum(p * torch.log(p), dim=-1),
                                           dim=-1))
    return kl_uniform + confidence_weight * sample_entropy


def get_code_distance(name: str):
    try:
        return CODE_DISTANCES[name]()
    except KeyError:
        raise ValueError(
            f"unknown code distance {name!r}; one of {sorted(CODE_DISTANCES)}")
