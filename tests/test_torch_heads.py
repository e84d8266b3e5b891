"""Port parity of the ``Categorical`` and ``ProductQuantization`` heads.

The port's modules, loaded with the JAX package's params, against the
JAX heads on the same numpy inputs.  Tolerances: probabilities atol 1e-6
(f32 summation order); hard codes, top-n probes and flip probes are
integers and match exactly.  Sampled PQ probes draw from a
``torch.Generator`` and cannot equal ``jax.random.categorical``'s: they
are held to what defines them (probe 0 is the hard code, ids sorted,
repeats masked, one seed gives one answer, band frequencies follow the
band probabilities).

The PQ flip probes count their digit slots with integers in the port.
The JAX package divides float logs, which at ``n_probes = B**j`` may give
one slot too few (duplicate probes that ``valid`` still claims distinct).
Where the JAX count is right the two are equal bitwise; where it is not,
the test says so and holds the port to distinct probes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.models import get_encoder as j_encoder
from nlsh_tpu.models import get_hashing as j_hashing
from nlsh_tpu.models.hashings import ProductQuantization as JPQ
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.models import (
    Categorical,
    ProductQuantization,
    get_encoder,
    get_hashing,
)
from nlsh_tpu_torch.models.hashings import pq_band_split
from nlsh_tpu_torch.utils.checkpoint import params_from_jax

D = 20


def _pair(kind, hash_size, enc="siren", seed=0):
    jh = j_hashing(kind, j_encoder(enc, D, [32, 24]), hash_size)
    params = jh.init(jax.random.PRNGKey(seed))
    th = get_hashing(kind, get_encoder(enc, D, [32, 24]), hash_size)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    return jh, params, th.eval()


def _x(n=300, seed=1):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _both(jh, params, th, x, **kw):
    j_ids, j_valid = jh.hash(params, jnp.asarray(x), **kw)
    with torch.no_grad():
        t_ids, t_valid = th.hash(torch.from_numpy(x), **kw)
    assert t_ids.dtype == torch.int32 and t_valid.dtype == torch.bool
    return (t_ids.numpy(), t_valid.numpy(),
            np.asarray(j_ids), np.asarray(j_valid))


@pytest.mark.parametrize("hash_size,want", [(12, (3, 4)), (6, (3, 2)),
                                            (7, (7, 1)), (8, (2, 4))])
def test_get_hashing_splits_bands_like_jax(hash_size, want):
    assert pq_band_split(hash_size) == want
    jh = j_hashing("ProductQuantization", j_encoder("mlp", D, [8]), hash_size)
    th = get_hashing("ProductQuantization", get_encoder("mlp", D, [8]),
                     hash_size)
    assert isinstance(th, ProductQuantization)
    assert (th.n_bands, th.bits_per_band) == (jh.n_bands, jh.bits_per_band)
    assert (th.band_size, th.hash_size, th.n_buckets) == (
        jh.band_size, jh.hash_size, jh.n_buckets)
    assert th.out.out_features == jh.output_dim


@pytest.mark.parametrize("kind,hash_size", [("Categorical", 37),
                                            ("ProductQuantization", 12),
                                            ("ProductQuantization", 6)])
@pytest.mark.parametrize("enc", ["siren", "mlp"])
def test_predict_and_hard_hash_match_jax(kind, hash_size, enc):
    jh, params, th = _pair(kind, hash_size, enc)
    x = _x()
    with torch.no_grad():
        p = th.predict(torch.from_numpy(x)).numpy()
        probs = th.probs(torch.from_numpy(x)).numpy()
        hard = th.hash_hard(torch.from_numpy(x))
    want = np.asarray(jh.predict(params, jnp.asarray(x)))
    assert p.shape == want.shape
    np.testing.assert_allclose(p, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(p, probs)
    assert hard.dtype == torch.int32
    np.testing.assert_array_equal(
        hard.numpy(), np.asarray(jh.hash_hard(params, jnp.asarray(x))))
    assert th.n_buckets == jh.n_buckets
    t_ids, t_valid, j_ids, j_valid = _both(jh, params, th, x, n_probes=1)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_ids[:, 0], hard.numpy())
    assert t_valid.all() and j_valid.all()


@pytest.mark.parametrize("n_probes", [2, 5, 37, 50])
def test_categorical_probes_match_jax(n_probes):
    """The n most probable buckets, sorted; slots past ``hash_size``
    repeat the last id and are masked."""
    jh, params, th = _pair("Categorical", 37)
    assert isinstance(th, Categorical)
    t_ids, t_valid, j_ids, j_valid = _both(jh, params, th, _x(),
                                           n_probes=n_probes,
                                           probe_mode="flip")
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_valid, j_valid)
    assert t_valid.sum(axis=1).max() == min(n_probes, 37)
    with pytest.raises(ValueError, match="positive integer"):
        th.hash(torch.from_numpy(_x(2)), n_probes=0)


def test_categorical_ties_keep_the_lowest_bucket():
    """Equal probabilities: ``lax.top_k`` keeps the lowest bucket ids, and
    so does the port's stable sort (``torch.topk`` promises no order)."""
    jh, params, th = _pair("Categorical", 8)
    zero = jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), params)
    params_from_jax(th, zero)                     # uniform softmax: all tie
    x = _x(5)
    t_ids, t_valid, j_ids, j_valid = _both(jh, zero, th, x, n_probes=3)
    np.testing.assert_array_equal(t_ids, j_ids)
    assert (t_ids == np.array([0, 1, 2])).all() and t_valid.all()
    with torch.no_grad():
        assert th.hash_hard(torch.from_numpy(x)).tolist() == [0] * 5


def _jax_slots(n_probes, band_size, n_bands):
    """The JAX package's float count of digit slots."""
    n = max(int(np.ceil(np.log(max(n_probes, 2)) / np.log(band_size))), 1)
    return min(n, n_bands)


def _int_slots(n_probes, band_size, n_bands):
    j = 1
    while band_size ** j < n_probes and j < n_bands:
        j += 1
    return j


@pytest.mark.parametrize("hash_size", [12, 6, 5])
@pytest.mark.parametrize("n_probes", [2, 3, 4, 7, 16, 17, 30, 32])
def test_pq_flip_probes_match_jax(hash_size, n_probes):
    jh, params, th = _pair("ProductQuantization", hash_size)
    if n_probes > th.n_buckets:
        with pytest.raises(ValueError, match="exceeds n_buckets"):
            th.hash(torch.from_numpy(_x(4)), n_probes=n_probes,
                    probe_mode="flip")
        return
    t_ids, t_valid, j_ids, j_valid = _both(jh, params, th, _x(),
                                           n_probes=n_probes,
                                           probe_mode="flip")
    assert t_valid.all() and t_ids.shape == (300, n_probes)
    for row in t_ids[:50]:
        assert len(set(row.tolist())) == n_probes   # pairwise distinct
    np.testing.assert_array_equal(t_ids[:, 0], np.asarray(
        jh.hash_hard(params, jnp.asarray(_x()))))
    if _jax_slots(n_probes, th.band_size, th.n_bands) >= _int_slots(
            n_probes, th.band_size, th.n_bands):
        # enough slots there too (surplus slots only ever get digit 0)
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_valid, j_valid)


@pytest.mark.parametrize("bits_per_band,n_bands", [(1, 10), (2, 5), (3, 4),
                                                   (4, 3)])
def test_pq_flip_probes_distinct_at_powers_of_band_size(bits_per_band,
                                                        n_bands):
    """``n_probes = B**j``: the integer slot count is exactly ``j``, and
    every probe is distinct.  Where the float count falls short, the JAX
    package's probes repeat; the test records which powers those are."""
    B = 2 ** bits_per_band
    jh = JPQ(j_encoder("mlp", D, [16]), n_bands, bits_per_band)
    params = jh.init(jax.random.PRNGKey(3))
    th = ProductQuantization(get_encoder("mlp", D, [16]), n_bands,
                             bits_per_band)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    x = _x(40)
    short = []
    for j in range(1, n_bands + 1):
        n_probes = B ** j
        if n_probes > 4096:
            break
        assert _int_slots(n_probes, B, n_bands) == j
        t_ids, t_valid, j_ids, j_valid = _both(jh, params, th, x,
                                               n_probes=n_probes,
                                               probe_mode="flip")
        assert t_valid.all()
        assert all(len(set(r.tolist())) == n_probes for r in t_ids)
        # a fixed prefix as n_probes grows
        if j > 1:
            np.testing.assert_array_equal(t_ids[:, : B ** (j - 1)], prev)
        prev = t_ids
        if _jax_slots(n_probes, B, n_bands) < j:
            short.append(n_probes)
            assert any(len(set(r.tolist())) < n_probes for r in j_ids)
        else:
            np.testing.assert_array_equal(t_ids, j_ids)
    # every power of the band size is covered, whichever way the float
    # logs of this platform round
    assert all(_jax_slots(n, B, n_bands) < _int_slots(n, B, n_bands)
               for n in short)


def test_pq_flip_ties_keep_lowest_band_and_sub_code():
    """Equal margins order the bands by index (stable argsort); equal
    probabilities rank the sub-codes by index (stable sort)."""
    th = ProductQuantization(get_encoder("mlp", D, [8]), 3, 2)
    jh = JPQ(j_encoder("mlp", D, [8]), 3, 2)
    p = torch.tensor([[[0.4, 0.4, 0.1, 0.1], [0.25, 0.25, 0.25, 0.25],
                       [0.1, 0.4, 0.4, 0.1]],
                      [[0.7, 0.1, 0.1, 0.1], [0.1, 0.7, 0.1, 0.1],
                       [0.1, 0.1, 0.7, 0.1]]])
    for n_probes in (4, 9, 16, 64):
        t_ids, t_valid = th._hash_flip(p, n_probes)
        j_ids, _ = jh._hash_flip(jnp.asarray(p.numpy()), n_probes)
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert th._pack_bands(torch.tensor([[1, 2, 3]])).tolist() == [0b011011]


def test_pq_sampled_probes():
    jh, params, th = _pair("ProductQuantization", 6)
    x = torch.from_numpy(_x(200))
    with torch.no_grad():
        hard = th.hash_hard(x).numpy()
        a_ids, a_valid = th.hash(x, n_probes=6,
                                 generator=torch.Generator().manual_seed(5))
        b_ids, b_valid = th.hash(x, n_probes=6,
                                 generator=torch.Generator().manual_seed(5))
        c_ids, _ = th.hash(x, n_probes=6,
                           generator=torch.Generator().manual_seed(6))
    a_ids, a_valid = a_ids.numpy(), a_valid.numpy()
    np.testing.assert_array_equal(a_ids, b_ids.numpy())   # one seed, one answer
    np.testing.assert_array_equal(a_valid, b_valid.numpy())
    assert (a_ids != c_ids.numpy()).any()
    assert (np.diff(a_ids, axis=1) >= 0).all()             # sorted per row
    assert a_valid[:, 0].all()
    np.testing.assert_array_equal(a_valid[:, 1:],
                                  a_ids[:, 1:] != a_ids[:, :-1])
    assert (a_ids == hard[:, None]).any(axis=1).all()      # probe 0: hard code
    assert a_ids.min() >= 0 and a_ids.max() < th.n_buckets
    with pytest.raises(ValueError, match="generator"):
        th.hash(x[:2], n_probes=2)


def test_pq_sampled_bands_follow_band_probabilities():
    _, _, th = _pair("ProductQuantization", 6)
    n = 20000
    x = torch.from_numpy(np.repeat(_x(1), n, axis=0))
    with torch.no_grad():
        p = th._band_probs(x[:1])[0].numpy()               # (3, 4)
        hard = int(th.hash_hard(x[:1])[0])
        ids, _ = th.hash(x, n_probes=2,
                         generator=torch.Generator().manual_seed(0))
    ids = ids.numpy()
    sampled = np.where(ids[:, 0] == hard, ids[:, 1], ids[:, 0])
    for band in range(3):
        sub = (sampled >> (2 * (2 - band))) & 3
        freq = np.bincount(sub, minlength=4) / n
        sigma = np.sqrt(p[band] * (1 - p[band]) / n)
        assert (np.abs(freq - p[band]) <= 4 * sigma + 1.0 / n).all()


@pytest.mark.parametrize("kind,hash_size", [("Categorical", 48),
                                            ("ProductQuantization", 6)])
def test_heads_serve_through_the_indexer(kind, hash_size):
    """Each head indexes a corpus and the grouped serve (plain kernels on
    the CPU) answers as the gather engine does."""
    _, _, th = _pair(kind, hash_size)
    rng = np.random.default_rng(8)
    corpus = rng.normal(size=(1500, D)).astype(np.float32)
    queries = rng.normal(size=(30, D)).astype(np.float32)
    kw = dict(k=10, hash_times=4, probe_mode="flip")
    grouped = Indexer(th, corpus, device="cpu", engine="grouped",
                      block_rows=128)
    assert int(grouped.table.counts.sum()) == 1500
    g_ids, g_cand = grouped.query(queries, **kw)
    x_ids, x_cand = Indexer(th, corpus, device="cpu",
                            engine="gather").query(queries, **kw)
    np.testing.assert_array_equal(g_cand, x_cand)
    assert (g_ids == x_ids).mean() >= 0.98
