"""Port parity of the grouped serving path and the ``Indexer``.

``serving_query_grouped`` of the port (plain kernels on the CPU) against
the JAX package's (Pallas in interpret mode) on the same layout inputs,
and the port's ``Indexer`` against the JAX ``Indexer(engine=
"pallas-grouped")`` and ``Indexer(engine="pallas-windowed")``.  ``n_candidates`` must match exactly; ids agree on
at least 0.98 of slots (the gate of ``tests/test_serving.py``: f32
summation order may swap near-tied neighbours); scores within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.index.bucket_table import build_bucket_table as j_build
from nlsh_tpu.index.indexer import Indexer as JIndexer
from nlsh_tpu.index.serving import serving_query_grouped as j_serve
from nlsh_tpu.models.encoders import MLPEncoder as JMLP
from nlsh_tpu.models.hashings import MultivariateBernoulli as JMVB
from nlsh_tpu.ops.pallas import query_kernel as jqk
from nlsh_tpu_torch.index import Indexer, build_bucket_table
from nlsh_tpu_torch.index.serving import serving_query_grouped
from nlsh_tpu_torch.models import MLPEncoder, MultivariateBernoulli
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.utils.checkpoint import params_from_jax


def _served(metric, seed=7, n=900, d=24, nb=16, nq=21, P=5):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    ids = rng.integers(0, nb, n).astype(np.int32)
    pid = np.sort(rng.integers(0, nb, (nq, P)).astype(np.int32), axis=1)
    pv = np.concatenate([np.ones((nq, 1), bool), pid[:, 1:] != pid[:, :-1]], 1)
    jt = j_build(jnp.asarray(ids), nb)
    jl = jqk.serving_layout(jt, jnp.asarray(corpus), metric=metric,
                            block_rows=128)
    tt = build_bucket_table(torch.from_numpy(ids), nb)
    tl = qk.serving_layout(tt, torch.from_numpy(corpus), metric=metric,
                           block_rows=128)
    return queries, pid, pv, (jl, jt), (tl, tt)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("row_k", [7, 20])   # 20 > ROW_TOPK: the K2 branch
@pytest.mark.parametrize("query_chunk", [16384, 8])  # 8: chunks 8 + 8 + 5
def test_grouped_serving_matches_jax(metric, row_k, query_chunk):
    queries, pid, pv, (jl, jt), (tl, tt) = _served(metric)
    k = 7
    j_ids, j_scores, j_cand = j_serve(
        jl, jnp.asarray(queries), jnp.asarray(pid), jnp.asarray(pv),
        jt.counts, k=k, interpret=True, query_chunk=query_chunk, row_k=row_k)
    t_ids, t_scores, t_cand = serving_query_grouped(
        tl, torch.from_numpy(queries), torch.from_numpy(pid),
        torch.from_numpy(pv), tt.counts, k=k, query_chunk=query_chunk,
        row_k=row_k)
    np.testing.assert_array_equal(t_cand.numpy(), np.asarray(j_cand))
    assert (t_ids.numpy() == np.asarray(j_ids)).mean() >= 0.98
    j_scores = np.asarray(j_scores)
    fin = np.isfinite(j_scores)
    np.testing.assert_array_equal(np.isfinite(t_scores.numpy()), fin)
    np.testing.assert_allclose(t_scores.numpy()[fin], j_scores[fin],
                               atol=1e-5, rtol=0)
    assert t_ids.dtype == torch.int32 and t_ids.shape == (queries.shape[0], k)


def test_grouped_serving_g_total_override_and_plain():
    """An exact group bound serves the same result as the static one, and
    ``plain=True`` is the same path on the CPU."""
    queries, pid, pv, _, (tl, tt) = _served("cosine", seed=8)
    args = (tl, torch.from_numpy(queries), torch.from_numpy(pid),
            torch.from_numpy(pv), tt.counts)
    base = serving_query_grouped(*args, k=5)
    exact = qk.grouped_exact_bound(tt.counts, args[2], args[3], tl.cap, 32,
                                   tl.br)
    for got in (serving_query_grouped(*args, k=5, g_total_override=exact),
                serving_query_grouped(*args, k=5, plain=True)):
        for a, b in zip(got, base):
            assert torch.equal(a, b)


def _indexers(metric, seed=9):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(1200, 16)).astype(np.float32)
    queries = rng.normal(size=(40, 16)).astype(np.float32)
    jh = JMVB(JMLP(16, (32,)), 5)
    params = jh.init(jax.random.PRNGKey(seed))
    th = MultivariateBernoulli(MLPEncoder(16, (32,)), 5)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    ji = JIndexer(jh, params, jnp.asarray(corpus), metric=metric,
                  engine="pallas-grouped")
    ti = Indexer(th, corpus, device="cpu", metric=metric)
    return queries, ji, ti


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_indexer_matches_jax_grouped_engine(metric):
    queries, ji, ti = _indexers(metric)
    for name in ("row_ids", "starts", "counts"):
        np.testing.assert_array_equal(getattr(ti.table, name).numpy(),
                                      np.asarray(getattr(ji.table, name)))
    j_ids, j_cand = ji.query(jnp.asarray(queries), k=10, hash_times=6,
                             probe_mode="flip")
    t_ids, t_cand = ti.query(queries, k=10, hash_times=6, probe_mode="flip")
    np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
    assert (t_ids == np.asarray(j_ids)).mean() >= 0.98
    ti.engine = "gather"  # the JAX package's "xla" engine
    ji.engine = "xla"
    g_ids, g_cand = ti.query(queries, k=10, hash_times=6, probe_mode="flip")
    x_ids, _ = ji.query(jnp.asarray(queries), k=10, hash_times=6,
                        probe_mode="flip")
    np.testing.assert_array_equal(g_cand, t_cand)
    assert (g_ids == np.asarray(x_ids)).mean() >= 0.98
    assert (g_ids == t_ids).mean() >= 0.98


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_indexer_matches_jax_windowed_engine(metric):
    """The windowed engine on a dense (8-row-aligned) layout against the
    JAX ``Indexer(engine="pallas-windowed")``, and against the port's own
    grouped engine; switching engines rebuilds the layout."""
    queries, ji, ti = _indexers(metric, seed=11)
    ji.engine, ti.engine = "pallas-windowed", "windowed"
    assert ti.layout.align == 8
    for name in ("row_map", "starts", "counts"):
        np.testing.assert_array_equal(getattr(ti.layout, name).numpy(),
                                      np.asarray(getattr(ji.layout, name)))
    j_ids, j_cand = ji.query(jnp.asarray(queries), k=10, hash_times=6,
                             probe_mode="flip")
    w_ids, w_cand = ti.query(queries, k=10, hash_times=6, probe_mode="flip")
    np.testing.assert_array_equal(w_cand, np.asarray(j_cand))
    assert (w_ids == np.asarray(j_ids)).mean() >= 0.98
    ti.engine = "grouped"
    assert ti.layout.align == ti.layout.cap
    g_ids, g_cand = ti.query(queries, k=10, hash_times=6, probe_mode="flip")
    np.testing.assert_array_equal(g_cand, w_cand)
    assert (g_ids == w_ids).mean() >= 0.98


def test_indexer_async_fetch_sampling_and_knobs():
    queries, _, ti = _indexers("cosine", seed=10)
    ids, cand = ti.query(queries, k=5, hash_times=4,
                         generator=torch.Generator().manual_seed(1))
    a_ids, a_cand = Indexer.fetch(ti.query_async(
        queries, k=5, hash_times=4, generator=torch.Generator().manual_seed(1)))
    np.testing.assert_array_equal(ids, a_ids)
    np.testing.assert_array_equal(cand, a_cand)
    assert ti.layout.data.dtype == torch.float32
    ti.serving_dtype = torch.bfloat16  # a knob change rebuilds the layout
    assert ti.layout.data.dtype == torch.bfloat16
    assert ti.query(queries, k=5, hash_times=4, probe_mode="flip")[0].shape == (40, 5)
    assert ti.n_buckets_used() == int((ti.table.counts > 0).sum())
    with pytest.raises(ValueError):
        ti.engine = "pallas"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_indexer_grouped_engine_on_the_card(cuda_device, metric):
    """The Indexer serves through K1 (k <= 16) and K2 (k > 16) on the
    card and agrees with the gather engine."""
    rng = np.random.default_rng(6)
    corpus = rng.normal(size=(20000, 32)).astype(np.float32)
    queries = rng.normal(size=(300, 32)).astype(np.float32)
    torch.manual_seed(0)
    hashing = MultivariateBernoulli(MLPEncoder(32, (64,)), 6)
    idx = Indexer(hashing, corpus, device=cuda_device, metric=metric)
    for k, kernel in ((10, "grouped_scores_topk"), (20, "grouped_scores")):
        before = qk.KERNEL_LAUNCHES[kernel]
        ids, cand = idx.query(queries, k=k, hash_times=8, probe_mode="flip")
        assert qk.KERNEL_LAUNCHES[kernel] > before
        idx.engine = "gather"
        g_ids, g_cand = idx.query(queries, k=k, hash_times=8,
                                  probe_mode="flip")
        idx.engine = "grouped"
        np.testing.assert_array_equal(cand, g_cand)
        assert (ids == g_ids).mean() >= 0.98


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_indexer_windowed_engine_on_the_card(cuda_device, metric):
    """The Indexer serves through K3 (k <= 16) and K4 (k > 16) on the
    card and agrees with the grouped engine."""
    rng = np.random.default_rng(7)
    corpus = rng.normal(size=(20000, 32)).astype(np.float32)
    queries = rng.normal(size=(300, 32)).astype(np.float32)
    torch.manual_seed(1)
    hashing = MultivariateBernoulli(MLPEncoder(32, (64,)), 8)
    idx = Indexer(hashing, corpus, device=cuda_device, metric=metric)
    for k, kernel in ((10, "windowed_scores_topk"), (20, "windowed_scores")):
        idx.engine = "windowed"
        before = qk.KERNEL_LAUNCHES[kernel]
        ids, cand = idx.query(queries, k=k, hash_times=8, probe_mode="flip")
        assert qk.KERNEL_LAUNCHES[kernel] > before
        idx.engine = "grouped"
        g_ids, g_cand = idx.query(queries, k=k, hash_times=8,
                                  probe_mode="flip")
        np.testing.assert_array_equal(cand, g_cand)
        assert (ids == g_ids).mean() >= 0.98
