"""Port parity: bit packing, encoders and the MultivariateBernoulli head
of ``nlsh_tpu_torch`` against the JAX package, on the same numpy inputs.

Tolerances: packing, hard codes and flip-probe ids are integers and
must match exactly; encoder features (atol 1e-5) and probabilities
(atol 1e-6) differ only by f32 summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.models.encoders import MLPEncoder as JMLP
from nlsh_tpu.models.encoders import SirenEncoder as JSiren
from nlsh_tpu.models.hashings import MultivariateBernoulli as JMVB
from nlsh_tpu.ops import packing as jpacking
from nlsh_tpu_torch.models import (
    MLPEncoder, MultivariateBernoulli, SirenEncoder, get_hashing,
)
from nlsh_tpu_torch.ops import packing
from nlsh_tpu_torch.utils.checkpoint import params_from_jax


def _pair(kind, d=20, hidden=(32, 24), bits=8, seed=0, **kw):
    """A JAX hashing head with fresh params, and the port's twin loaded
    with the same weights."""
    if kind == "siren":
        jenc, tenc = JSiren(d, hidden), SirenEncoder(d, hidden)
    else:
        jenc, tenc = JMLP(d, hidden, **kw), MLPEncoder(d, hidden, **kw)
    jh = JMVB(jenc, bits)
    params = jh.init(jax.random.PRNGKey(seed))
    th = MultivariateBernoulli(tenc, bits)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    return jh, params, th


def _x(n=300, d=20, seed=1):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_packing_matches_jax():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 2, (40, 9, 11)).astype(np.int32)
    ids = packing.pack_bits(torch.from_numpy(codes))
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jpacking.pack_bits(jnp.asarray(codes))))
    np.testing.assert_array_equal(packing.unpack_bits(ids, 11).numpy(), codes)
    t_ids, t_valid = packing.hash_codes(torch.from_numpy(codes))
    j_ids, j_valid = jpacking.hash_codes(jnp.asarray(codes))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    assert t_ids.dtype == torch.int32
    with pytest.raises(ValueError):
        packing.bit_weights(31)


@pytest.mark.parametrize("kind,kw", [
    ("siren", {}), ("mlp", {}), ("mlp", {"with_layernorm": True}),
])
def test_encoder_forward_matches_jax(kind, kw):
    jh, params, th = _pair(kind, **kw)
    x = _x()
    want = np.asarray(jh.encoder.apply(params["encoder"], jnp.asarray(x)))
    got = th.encoder(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["siren", "mlp"])
def test_mvb_probs_and_hard_hash_match_jax(kind):
    jh, params, th = _pair(kind)
    x = _x()
    with torch.no_grad():
        p = th.probs(torch.from_numpy(x)).numpy()
        hard = th.hash_hard(torch.from_numpy(x)).numpy()
        ids1, valid1 = th.hash(torch.from_numpy(x), n_probes=1)
    np.testing.assert_allclose(
        p, np.asarray(jh.probs(params, jnp.asarray(x))), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        hard, np.asarray(jh.hash_hard(params, jnp.asarray(x))))
    np.testing.assert_array_equal(ids1[:, 0].numpy(), hard)
    assert valid1.all()


@pytest.mark.parametrize("n_probes", [2, 5, 16, 300])
def test_flip_probe_ids_match_jax(n_probes):
    """Flip probes pick the least-confident bits with lax.top_k's
    lowest-index-first tie rule; the port's stable sort must agree
    bitwise (n_probes=300 > 2**bits exercises the capped flip count)."""
    jh, params, th = _pair("siren")
    x = _x()
    j_ids, j_valid = jh.hash(params, jnp.asarray(x), n_probes=n_probes,
                             probe_mode="flip")
    with torch.no_grad():
        t_ids, t_valid = th.hash(torch.from_numpy(x), n_probes=n_probes,
                                 probe_mode="flip")
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))


def test_flip_ties_keep_lowest_bit_index():
    """Equal confidences: the lowest bit positions are flipped first, as
    lax.top_k(-conf) does."""
    th = MultivariateBernoulli(MLPEncoder(4, (4,)), 6)
    p = torch.tensor([[0.9, 0.6, 0.6, 0.6, 0.1, 0.6]])
    ids, _ = th._hash_flip(p, 4)
    jh = JMVB(JMLP(4, (4,)), 6)
    j_ids, _ = jh._hash_flip(jnp.asarray(p.numpy()), 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))


def test_sample_probes_follow_bit_probabilities():
    """Sampled probes come from a torch.Generator, so they are checked by
    distribution: probe 0 is the hard code, and each sampled bit's
    frequency lies within 3 sigma of its probability."""
    _, _, th = _pair("siren", bits=8)
    n = 20000
    x = torch.from_numpy(np.repeat(_x(1), n, axis=0))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        p = th.probs(x[:1])[0].numpy()
        hard = int(th.hash_hard(x[:1])[0])
        ids, valid = th.hash(x, n_probes=2, generator=gen)
    ids = ids.numpy()
    assert ((ids == hard).any(axis=1)).all()  # the hard code is always probed
    sampled = np.where(ids[:, 0] == hard, ids[:, 1], ids[:, 0])
    bits = packing.unpack_bits(torch.from_numpy(sampled), 8).numpy()
    freq = bits.mean(axis=0)
    sigma = np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= 3 * sigma + 1.0 / n).all(), (freq, p)
    with pytest.raises(ValueError):
        th.hash(x[:2], n_probes=2)  # sampling needs a generator


def test_get_hashing_names_unported_heads():
    enc = SirenEncoder(8, (16,))
    assert isinstance(get_hashing("MultivariateBernoulli", enc, 4),
                      MultivariateBernoulli)
    assert get_hashing("MultivariateBernoulliTanh", enc, 4).tanh_output
    # every head of the JAX package is ported now: none is named as missing
    cat = get_hashing("Categorical", enc, 4)
    assert type(cat).__name__ == "Categorical" and cat.n_buckets == 4
    pq = get_hashing("ProductQuantization", enc, 6)
    assert type(pq).__name__ == "ProductQuantization"
    assert (pq.n_bands, pq.bits_per_band, pq.n_buckets) == (3, 2, 64)
    with pytest.raises(ValueError):
        get_hashing("nope", enc, 4)
