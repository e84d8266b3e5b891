"""Port parity of the balance losses and of the gradient rules at ties:
``nlsh_tpu_torch.ops.code_distances`` against ``nlsh_tpu.ops.code_distances``
on the same numpy inputs, values and gradients (``jax.grad`` against
autograd), rtol 1e-5 (atol 1e-5 of the tensor's largest magnitude).

Ties use crafted inputs where the arithmetic is exact: ``jnp.maximum`` /
``jnp.clip`` give each side half the gradient at equality
(``torch.clamp`` would give the input all of it), and the norm of a zero
vector has a NaN gradient in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.ops import code_distances as J
from nlsh_tpu.train.siamese import contrastive_loss as j_contrastive
from nlsh_tpu.train.triplet import triplet_loss as j_triplet
from nlsh_tpu_torch.ops import code_distances as T
from nlsh_tpu_torch.train.siamese import contrastive_loss
from nlsh_tpu_torch.train.triplet import triplet_loss
from torch_train_common import both as _both, close as _close, codes as _codes

@pytest.mark.parametrize("bits", [3, 6, 8])
def test_bucket_balance_loss_matches_jax(bits):
    p = _codes("KL", (64, bits), bits)
    got, want, tg, jg = _both(lambda a, b: J.bucket_balance_loss(a * b),
                              lambda a, b: T.bucket_balance_loss(a * b),
                              p, np.ones_like(p))
    _close(got, want)
    _close(tg[0], jg[0])


def test_bucket_balance_loss_refuses_wide_codes():
    with pytest.raises(ValueError, match="16"):
        T.bucket_balance_loss(torch.full((2, 17), 0.5))


@pytest.mark.parametrize("n_bands,band_size", [(3, 4), (2, 16), (4, 8), (5, 16)])
def test_band_balance_loss_matches_jax(n_bands, band_size):
    """(3, 4), (2, 16): the exact joint histogram; (4, 8) = 12 bits, still
    joint; (5, 16) = 20 bits > 14: the marginal fallback."""
    z = np.random.default_rng(n_bands).normal(
        size=(32, n_bands, band_size)).astype(np.float32)
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    p = (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)
    got, want, tg, jg = _both(lambda a, b: J.band_balance_loss(a * b),
                              lambda a, b: T.band_balance_loss(a * b),
                              p, np.ones_like(p))
    _close(got, want)
    _close(tg[0], jg[0])


# -- ties -------------------------------------------------------------------------

def _dyadic(shape, seed, denom=8):
    """Probabilities k/denom: every sum of products is exact in f32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(1, denom, shape) / denom).astype(np.float32)


def _one_ulp_apart(p, q, p_at, q_at):
    """Put ``[0.5, 0, ...]`` at ``p[p_at]`` and ``[0.5 + 1 ulp, 0, ...]``
    at ``q[q_at]``: distinct rows whose ``p_sq + q_sq - 2 cross`` rounds
    to exactly 0, a tie with ``maximum(., 0)`` whose gradient
    ``2 (p - q)`` is not 0."""
    p[p_at], q[q_at] = 0.0, 0.0
    p[p_at + (0,)] = 0.5
    q[q_at + (0,)] = np.nextafter(np.float32(0.5), np.float32(1))


@pytest.mark.parametrize("name,shape", [("L2", "row_pairwise"),
                                        ("CategoricalL2", "pairwise"),
                                        ("CategoricalL2", "row_pairwise")])
def test_maximum_tie_takes_jax_half_gradient(name, shape, monkeypatch):
    """At the tie JAX's half gradient, amplified 5e5 by ``sqrt(. +
    1e-12)``, comes out of the port; ``torch.clamp``'s whole one would
    not."""
    if shape == "pairwise":
        p, q = _dyadic((4, 6), 0), _dyadic((3, 6), 1)
        _one_ulp_apart(p, q, (2,), (0,))
    else:
        p, q = _dyadic((3, 2, 6), 0), _dyadic((3, 3, 6), 1)
        _one_ulp_apart(p, q, (0, 1), (0, 0))
    jd, td = J.get_code_distance(name), T.get_code_distance(name)
    got, want, tg, jg = _both(getattr(jd, shape), getattr(td, shape), p, q)
    assert (want == np.float32(1e-6)).sum() == 1           # sqrt(0 + 1e-12)
    _close(got, want)
    for a, b in zip(tg, jg):
        _close(a, b)
    monkeypatch.setattr(T, "clip", lambda x, lo=None, hi=None:
                        torch.clamp(x, min=lo, max=hi))
    _, _, clamped, _ = _both(getattr(jd, shape), getattr(td, shape), p, q)
    assert not np.allclose(clamped[0], jg[0], rtol=1e-3, atol=1e-4)


def test_hinge_losses_at_the_clip_take_half_the_gradient():
    """d_pos - d_neg + margin == 0 exactly (a dot-product 'distance' on
    dyadic rows): the triplet hinge and both contrastive clips."""
    a = np.array([[0.5, 0.25], [0.25, 0.5]], np.float32)
    p = np.array([[0.5, 0.5], [0.5, 0.0]], np.float32)       # 0.375, 0.125
    n = np.array([[1.0, 1.5], [0.5, 1.0]], np.float32)       # 0.875, 0.625

    def jdot(x, y):
        return jnp.sum(x * y, axis=-1)

    def tdot(x, y):
        return torch.sum(x * y, dim=-1)

    got, want, tg, jg = _both(
        lambda x, y: j_triplet(x, y, jnp.asarray(n), jdot, margin=0.5),
        lambda x, y: triplet_loss(x, y, torch.from_numpy(n), tdot, margin=0.5),
        a, p)
    _close(got, want)
    for g_t, g_j in zip(tg, jg):
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-7)
    assert np.abs(jg[0]).max() > 0     # half, not nothing

    label = np.array([1.0, 0.0], np.float32)
    for kw in ({"positive_margin": 0.375, "negative_margin": 0.125},
               {"positive_margin": 0.125, "negative_margin": 0.375}):
        got, want, tg, jg = _both(
            lambda x, y: j_contrastive(x, y, jnp.asarray(label), jdot, **kw),
            lambda x, y: contrastive_loss(x, y, torch.from_numpy(label), tdot,
                                          **kw), a, p)
        _close(got, want)
        for g_t, g_j in zip(tg, jg):
            np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-7)


def test_clip_follows_jnp_clip_at_both_bounds():
    x = np.array([1e-6, 0.3, 1.0, 1.0 - 1e-6, 0.0, 2.0], np.float32)
    for lo, hi in ((1e-6, 1.0 - 1e-6), (1e-9, 1.0), (0.0, None), (None, 1.0)):
        jg = jax.grad(lambda v: jnp.sum(jnp.clip(v, lo, hi) * jnp.arange(6.0)))(
            jnp.asarray(x))
        t = torch.tensor(x, requires_grad=True)
        torch.sum(T.clip(t, lo, hi) * torch.arange(6.0)).backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(
            T.clip(torch.from_numpy(x), lo, hi).numpy(),
            np.asarray(jnp.clip(jnp.asarray(x), lo, hi)))


def test_balance_losses_at_their_clips():
    """Bits at exactly 1e-6 (bucket balance) and one-hot bands at exactly
    1.0 (band balance) sit on the clip bounds."""
    p = _codes("KL", (16, 4), 5)
    p[0, 1] = np.float32(1e-6)
    p[3, 2] = np.float32(1.0 - 1e-6)
    got, want, tg, jg = _both(lambda a, b: J.bucket_balance_loss(a * b),
                              lambda a, b: T.bucket_balance_loss(a * b),
                              p, np.ones_like(p))
    _close(got, want)
    _close(tg[0], jg[0])
    bands = np.full((8, 3, 4), 0.25, np.float32)
    for i in range(4):                       # one-hot bands: 1.0 and 0.0
        bands[i, i % 3] = np.eye(4, dtype=np.float32)[i]
    got, want, tg, jg = _both(lambda a, b: J.band_balance_loss(a * b),
                              lambda a, b: T.band_balance_loss(a * b),
                              bands, np.ones_like(bands))
    _close(got, want)
    _close(tg[0], jg[0])


def test_cosine_of_a_zero_code_has_jax_nan_gradient():
    p = np.tanh(np.random.default_rng(0).normal(size=(3, 4))).astype(np.float32)
    p[1] = 0.0
    q = np.tanh(np.random.default_rng(1).normal(size=(3, 4))).astype(np.float32)
    jd, td = J.get_code_distance("Cosine"), T.get_code_distance("Cosine")
    got, want, tg, jg = _both(jd.rowwise, td.rowwise, p, q)
    _close(got, want)
    assert np.isnan(jg[0][1]).all() and np.isnan(tg[0][1]).all()
    np.testing.assert_allclose(tg[0][[0, 2]], jg[0][[0, 2]], rtol=1e-5,
                               atol=1e-6)
