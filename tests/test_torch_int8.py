"""int8 serving layouts, their engines and K7, the int8 block probe.

The port against the JAX package on the same numpy inputs.  On corpora
of small dyadic values every division of the quantisation is exact, so
the int8 bytes, ``row_map``, scales and norms compare bitwise.  On
Gaussian data the cosine normalisation of the two frameworks may differ
by an ulp, which moves a value sitting on a .5 rounding boundary by one
step: there the bytes may differ by 1, only on such elements, and the
test counts them.  Served ids agree on at least 0.98 of slots and
``n_candidates`` exactly (the gates of ``tests/test_serving.py``).  K7's
plain version is held bitwise to the probe's own einsum reference
(``benchmarks/int8_probe.py``): with integer queries every partial sum
is an exact f32 integer.  The CUDA kernel is held to the plain version
on the card (``cuda`` marker)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.index.bucket_table import build_bucket_table as j_build
from nlsh_tpu.index.indexer import Indexer as JIndexer
from nlsh_tpu.models.encoders import MLPEncoder as JMLP
from nlsh_tpu.models.hashings import MultivariateBernoulli as JMVB
from nlsh_tpu.ops.pallas import query_kernel as jqk
from nlsh_tpu_torch.index import Indexer, build_bucket_table, hash_corpus
from nlsh_tpu_torch.models import MLPEncoder, MultivariateBernoulli
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.utils.checkpoint import params_from_jax

METRICS = ["cosine", "euclidean"]
MODES = ["per_row", "global"]


def _dyadic(rng, n, d):
    return (rng.integers(-16, 17, (n, d)) / 8.0).astype(np.float32)


def _tables(ids, nb):
    return j_build(jnp.asarray(ids), nb), build_bucket_table(
        torch.from_numpy(ids), nb)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", MODES)
def test_ext_scales_match_jax(metric, mode):
    rng = np.random.default_rng(1)
    for corpus, exact in ((_dyadic(rng, 300, 40), True),
                          (rng.normal(size=(300, 40)).astype(np.float32),
                           metric == "euclidean")):
        got = qk.ext_scales(torch.from_numpy(corpus), metric, mode)
        want = np.asarray(jqk.ext_scales(jnp.asarray(corpus), metric, mode))
        assert got.dtype == torch.float32 and got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got.numpy(), want)
        else:  # cosine on Gaussian rows: the row maxima may differ by an ulp
            np.testing.assert_allclose(got.numpy(), want, rtol=5e-7, atol=0)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("align", [None, 8])
def test_int8_layout_matches_jax_bitwise(metric, mode, align):
    rng = np.random.default_rng(3)
    n, d, nb = 900, 100, 16
    corpus = _dyadic(rng, n, d)
    ids = rng.integers(0, nb, n).astype(np.int32)
    ids[ids == 5] = 4  # an empty bucket
    jt, tt = _tables(ids, nb)
    jl = jqk.serving_layout(jt, jnp.asarray(corpus), metric=metric,
                            dtype=jnp.int8, align=align, block_rows=128,
                            scale_mode=mode)
    tl = qk.serving_layout(tt, torch.from_numpy(corpus), metric=metric,
                           dtype=torch.int8, align=align, block_rows=128,
                           scale_mode=mode)
    assert tl.data.dtype == torch.int8
    for name in ("data", "row_map", "starts", "counts", "scale"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)), name)
    assert tl.scale.ndim == (1 if mode == "per_row" else 0)
    if mode == "per_row":  # padding rows keep scale 1.0
        assert (tl.scale.numpy()[tl.row_map.numpy() < 0] == 1.0).all()
    if metric == "cosine":
        assert tl.norms is None and jl.norms is None
    else:
        np.testing.assert_array_equal(tl.norms.numpy(), np.asarray(jl.norms))
    for name in ("cap", "d_pad", "align", "total_blocks", "n_rows"):
        assert getattr(tl, name) == getattr(jl, name), name


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", MODES)
def test_int8_layout_on_gaussian_data(metric, mode):
    """General data: bytes equal except +-1 on elements whose quantised
    value sits on a .5 boundary (counted, and few); the rest bitwise."""
    rng = np.random.default_rng(7)  # cosine: 1-2 boundary elements
    corpus = rng.normal(size=(20000, 100)).astype(np.float32)
    ids = rng.integers(0, 8, 20000).astype(np.int32)
    jt, tt = _tables(ids, 8)
    jl = jqk.serving_layout(jt, jnp.asarray(corpus), metric=metric,
                            dtype=jnp.int8, block_rows=128, scale_mode=mode)
    tl = qk.serving_layout(tt, torch.from_numpy(corpus), metric=metric,
                           dtype=torch.int8, block_rows=128, scale_mode=mode)
    np.testing.assert_array_equal(tl.row_map.numpy(), np.asarray(jl.row_map))
    got = tl.data.numpy().astype(np.int32)
    want = np.asarray(jl.data).astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    rm = tl.row_map.numpy()
    off = np.argwhere(diff > 0)
    ext = corpus if metric == "euclidean" else \
        corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    scale = np.asarray(jl.scale)
    for r, c in off:  # each one a .5 boundary of the quantisation
        s = scale if scale.ndim == 0 else scale[r]
        frac = abs(ext[rm[r], c] / s) % 1.0
        assert abs(frac - 0.5) < 1e-4, (r, c, frac)
    assert len(off) <= 0.001 * got.size, len(off)
    if mode == "global" or metric == "euclidean":
        np.testing.assert_allclose(tl.scale.numpy(), scale, rtol=5e-7)


@pytest.mark.parametrize("metric", METRICS)
def test_extend_queries_folds_the_global_scale(metric):
    rng = np.random.default_rng(5)
    corpus = _dyadic(rng, 400, 30)
    ids = rng.integers(0, 8, 400).astype(np.int32)
    jt, tt = _tables(ids, 8)
    q = rng.normal(size=(9, 30)).astype(np.float32)
    for mode in MODES:
        jl = jqk.serving_layout(jt, jnp.asarray(corpus), metric=metric,
                                dtype=jnp.int8, scale_mode=mode)
        tl = qk.serving_layout(tt, torch.from_numpy(corpus), metric=metric,
                               dtype=torch.int8, scale_mode=mode)
        got = qk.extend_queries(tl, torch.from_numpy(q)).numpy()
        want = np.asarray(jqk.extend_queries(jl, jnp.asarray(q)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        f32 = qk.serving_layout(tt, torch.from_numpy(corpus), metric=metric)
        plain = qk.extend_queries(f32, torch.from_numpy(q)).numpy()
        fold = float(tl.scale) if mode == "global" else 1.0
        np.testing.assert_allclose(got, plain * fold, atol=1e-7, rtol=1e-6)


def _indexers(metric, engine, mode, seed=9):
    rng = np.random.default_rng(seed)
    corpus = _dyadic(rng, 1200, 16)
    queries = rng.normal(size=(40, 16)).astype(np.float32)
    jh = JMVB(JMLP(16, (32,)), 5)
    params = jh.init(jax.random.PRNGKey(seed))
    th = MultivariateBernoulli(MLPEncoder(16, (32,)), 5)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    j_engine = {"grouped": "pallas-grouped", "windowed": "pallas-windowed",
                "fixed": "pallas"}[engine]
    ji = JIndexer(jh, params, jnp.asarray(corpus), metric=metric,
                  engine=j_engine, serving_dtype=jnp.int8, int8_scale=mode)
    ti = Indexer(th, corpus, device="cpu", metric=metric, engine=engine,
                 serving_dtype=torch.int8, int8_scale=mode)
    return queries, ji, ti


@pytest.mark.parametrize("engine", ["grouped", "windowed", "fixed"])
@pytest.mark.parametrize("metric,mode", [
    ("cosine", "per_row"), ("cosine", "global"), ("euclidean", "per_row"),
])
def test_int8_indexers_match_jax(engine, metric, mode):
    queries, ji, ti = _indexers(metric, engine, mode)
    np.testing.assert_array_equal(ti.layout.data.numpy(),
                                  np.asarray(ji.layout.data))
    j_ids, j_cand = ji.query(jnp.asarray(queries), k=10, hash_times=6,
                             probe_mode="flip")
    t_ids, t_cand = ti.query(queries, k=10, hash_times=6, probe_mode="flip")
    np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
    assert (t_ids == np.asarray(j_ids)).mean() >= 0.98


def test_int8_layout_knobs_rebuild_and_serve_like_f32():
    """``serving_dtype`` and ``int8_scale`` are layout knobs; the int8
    serve keeps the f32 serve's candidates and most of its ids."""
    queries, _, ti = _indexers("cosine", "grouped", "per_row", seed=10)
    i8_ids, i8_cand = ti.query(queries, k=10, hash_times=6, probe_mode="flip")
    assert ti.layout.scale.ndim == 1
    ti.int8_scale = "global"
    assert ti.layout.scale.ndim == 0
    ti.serving_dtype = torch.float32
    assert ti.layout.data.dtype == torch.float32 and ti.layout.scale is None
    ids, cand = ti.query(queries, k=10, hash_times=6, probe_mode="flip")
    np.testing.assert_array_equal(cand, i8_cand)
    assert np.mean([len(set(a) & set(b)) / 10
                    for a, b in zip(ids, i8_ids)]) >= 0.85
    with pytest.raises(ValueError, match="scale_mode"):
        Indexer(ti.hashing, queries, device="cpu", int8_scale="per_block")


def _probe_case():
    """``benchmarks/int8_probe.py``'s operands: 64 (128, 128) int8 blocks,
    8 integer queries in [-16, 16], a permuted block order, seed 0."""
    br, lane, nq, n_blocks = 128, 128, 8, 64
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(n_blocks * br, lane)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    scale = np.abs(corpus).max() / 127.0
    corpus_q = np.clip(np.round(corpus / scale), -127, 127).astype(np.int8)
    queries = rng.integers(-16, 17, size=(nq, lane)).astype(np.float32)
    block_ids = rng.permutation(n_blocks).astype(np.int32)
    return corpus_q, queries, block_ids, br


def test_plain_k7_matches_the_probe_reference_bitwise():
    corpus_q, queries, block_ids, br = _probe_case()
    ref = np.asarray(jnp.einsum(
        "qd,bkd->bqk", jnp.asarray(queries),
        jnp.asarray(corpus_q.reshape(-1, br, 128))[jnp.asarray(block_ids)]
        .astype(jnp.float32), precision=jax.lax.Precision.HIGHEST))
    before = dict(qk.KERNEL_LAUNCHES)
    got = qk.int8_block_scores(torch.from_numpy(corpus_q),
                               torch.from_numpy(queries),
                               torch.from_numpy(block_ids), br)
    assert qk.KERNEL_LAUNCHES == before  # the plain version is no launch
    assert got.shape == (64, 8, br) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="int8"):
        qk.int8_block_scores(torch.from_numpy(corpus_q).float(),
                             torch.from_numpy(queries),
                             torch.from_numpy(block_ids), br)


def test_int8_per_row_beats_global_on_skewed_norms():
    """Rows much shorter than the longest lose most of their int8
    resolution under one global scale; per-row scales keep them."""
    rng = np.random.default_rng(5)
    n, d = 512, 16
    base = rng.normal(size=(n, d)).astype(np.float32)
    base[:8] *= 100.0  # outlier rows dominate the global max
    corpus = torch.from_numpy(base)
    torch.manual_seed(0)
    hashing = MultivariateBernoulli(MLPEncoder(d, (16,)), 4)
    table = build_bucket_table(hash_corpus(hashing, corpus),
                               hashing.n_buckets)

    def dequant_err(mode):
        lay = qk.serving_layout(table, corpus, metric="euclidean",
                                dtype=torch.int8, scale_mode=mode)
        scale = lay.scale.numpy()
        data = lay.data.numpy().astype(np.float32)
        deq = data * (scale if scale.ndim == 0 else scale[:, None])
        rm = lay.row_map.numpy()
        valid = rm >= 0
        err = np.abs(deq[valid][:, :d] - base[rm[valid]])
        small = np.linalg.norm(base[rm[valid]], axis=1) < 50
        return float(err[small].max())

    e_global, e_row = dequant_err("global"), dequant_err("per_row")
    assert e_row < e_global / 10, (e_row, e_global)


# -- the CUDA kernel against its plain version, on the card ----------------

@pytest.mark.cuda
def test_k7_kernel_matches_plain_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    corpus_q, queries, block_ids, br = _probe_case()
    t = [torch.from_numpy(a).cuda() for a in (corpus_q, queries, block_ids)]
    before = qk.KERNEL_LAUNCHES["int8_block_scores"]
    got = qk.int8_block_scores(*t, br)
    assert qk.KERNEL_LAUNCHES["int8_block_scores"] == before + 1
    assert torch.equal(got, qk.int8_block_scores_plain(*t, br))
