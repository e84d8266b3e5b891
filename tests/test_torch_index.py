"""Port parity of the index build and the gather engine: CSR table,
``hash_corpus``, the serving layout, the grouped prep and
``query_bucket_table`` against the JAX package on the same inputs.

Integer outputs must match bitwise.  The layout's float rows are also
compared bitwise, on corpora of small dyadic values: their squared
norms sum exactly in f32 in any order, so the only rounding left is the
correctly rounded sqrt and division both packages share (on general
data the two frameworks' reductions differ in order, by an ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.index.bucket_table import build_bucket_table as j_build
from nlsh_tpu.index.indexer import hash_corpus as j_hash_corpus
from nlsh_tpu.index.query import query_bucket_table as j_query
from nlsh_tpu.models.encoders import SirenEncoder as JSiren
from nlsh_tpu.models.hashings import MultivariateBernoulli as JMVB
from nlsh_tpu.ops.pallas import query_kernel as jqk
from nlsh_tpu_torch.index import build_bucket_table, hash_corpus, query_bucket_table
from nlsh_tpu_torch.models import MultivariateBernoulli, SirenEncoder
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.utils.checkpoint import params_from_jax


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _assert_same(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _probes(rng, nq, n_probes, n_buckets):
    raw = np.sort(rng.integers(0, n_buckets, (nq, n_probes)).astype(np.int32), axis=1)
    valid = np.concatenate(
        [np.ones((nq, 1), bool), raw[:, 1:] != raw[:, :-1]], axis=1)
    valid &= rng.random((nq, n_probes)) > 0.1  # some probes switched off
    valid[:, 0] = True
    return raw, valid


def test_bucket_table_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, 3000).astype(np.int32)
    ids[::17] = 64  # the deleted-row sentinel: in no bucket
    t = build_bucket_table(torch.from_numpy(ids), 64)
    j = j_build(jnp.asarray(ids), 64)
    for name in ("row_ids", "starts", "counts"):
        _assert_same(getattr(t, name), getattr(j, name), name)
        assert getattr(t, name).dtype == torch.int32
    assert t.max_count() == int(j.max_count())
    assert t.n_nonempty() == int(j.n_nonempty())
    assert t.occupancy_std() == pytest.approx(float(j.occupancy_std()), rel=1e-5)


def test_hash_corpus_matches_jax():
    jh = JMVB(JSiren(16, (32, 32)), 7)
    params = jh.init(jax.random.PRNGKey(1))
    th = MultivariateBernoulli(SirenEncoder(16, (32, 32)), 7)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    corpus = np.random.default_rng(2).normal(size=(5000, 16)).astype(np.float32)
    got = hash_corpus(th, torch.from_numpy(corpus), chunk=1024)
    want = j_hash_corpus(jh, params, jnp.asarray(corpus), chunk=1024)
    _assert_same(got, want, "codes")
    t = build_bucket_table(got, 128)
    j = j_build(want, 128)
    _assert_same(t.row_ids, j.row_ids, "row_ids")


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("cap,align,block_rows", [
    (None, None, 128), (64, None, 128), (None, 8, 256),
])
def test_layout_matches_jax_bitwise(metric, dtype, cap, align, block_rows):
    rng = np.random.default_rng(3)
    n, d, nb = 900, 100, 16
    corpus = (rng.integers(-16, 17, (n, d)) / 8.0).astype(np.float32)
    ids = rng.integers(0, nb, n).astype(np.int32)
    ids[ids == 5] = 4  # an empty bucket
    jt = j_build(jnp.asarray(ids), nb)
    tt = build_bucket_table(torch.from_numpy(ids), nb)
    jl = jqk.serving_layout(jt, jnp.asarray(corpus), metric=metric, cap=cap,
                            dtype=jnp.dtype(dtype), align=align,
                            block_rows=block_rows)
    tl = qk.serving_layout(tt, torch.from_numpy(corpus), metric=metric,
                           cap=cap, dtype=getattr(torch, dtype), align=align,
                           block_rows=block_rows)
    for name in ("data", "row_map", "starts", "counts"):
        _assert_same(getattr(tl, name), getattr(jl, name), name)
    assert tl.data.dtype == getattr(torch, dtype)
    if metric == "cosine":
        assert tl.norms is None and jl.norms is None
    else:
        _assert_same(tl.norms, jl.norms, "norms")
    for name in ("cap", "d_pad", "align", "total_blocks", "block_rows", "n_rows"):
        assert getattr(tl, name) == getattr(jl, name), name
    q = rng.normal(size=(7, d)).astype(np.float32)
    np.testing.assert_allclose(
        qk.extend_queries(tl, torch.from_numpy(q)).numpy(),
        np.asarray(jqk.extend_queries(jl, jnp.asarray(q))), atol=1e-6, rtol=0)


def test_layout_rows_agree_on_gaussian_data():
    """General data: the same layout up to the f32 reduction order of
    the row norms."""
    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(700, 24)).astype(np.float32)
    ids = rng.integers(0, 8, 700).astype(np.int32)
    jl = jqk.serving_layout(j_build(jnp.asarray(ids), 8), jnp.asarray(corpus))
    tl = qk.serving_layout(build_bucket_table(torch.from_numpy(ids), 8),
                           torch.from_numpy(corpus))
    _assert_same(tl.row_map, jl.row_map)
    np.testing.assert_allclose(tl.data.numpy(), np.asarray(jl.data),
                               atol=2.5e-7, rtol=0)  # 2 ulp of a unit row
    # int8 (per-row scales): the same bytes but for +-1 where an ulp of
    # the normalisation moves a value across a .5 rounding boundary
    jl8 = jqk.serving_layout(j_build(jnp.asarray(ids), 8), jnp.asarray(corpus),
                             dtype=jnp.int8)
    tl8 = qk.serving_layout(build_bucket_table(torch.from_numpy(ids), 8),
                            torch.from_numpy(corpus), dtype=torch.int8)
    _assert_same(tl8.row_map, jl8.row_map)
    diff = np.abs(tl8.data.numpy().astype(np.int32)
                  - np.asarray(jl8.data).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= 1e-3 * diff.size
    np.testing.assert_allclose(tl8.scale.numpy(), np.asarray(jl8.scale),
                               rtol=5e-7, atol=0)  # a few ulp


def _run_ranks_by_scan(sk):
    """The run ranks as a scan: each run's first position carried forward
    by a running max (the JAX package's ``associative_scan(max)``)."""
    pos = torch.arange(sk.shape[0])
    unique = torch.ones_like(sk, dtype=torch.bool)
    unique[1:] = sk[1:] != sk[:-1]
    return unique, pos - torch.cummax(torch.where(unique, pos, -1), 0).values


def _sorted_keys(case):
    rng = np.random.default_rng(23)
    if case == "long_runs":
        keys = np.repeat(rng.choice(5000, 40, replace=False),
                         rng.integers(1, 400, 40))
    elif case == "all_equal":
        keys = np.full(777, 12)
    elif case == "all_distinct":
        keys = rng.choice(10 ** 6, 1000, replace=False)
    elif case == "sentinel_n_buckets":  # the grouped prep's dead events
        keys = np.concatenate([rng.integers(0, 64, 500), np.full(90, 64)])
    elif case == "sentinel_2_30":  # the windowed prep's dead sub-events
        keys = np.concatenate([rng.integers(0, 300, 500),
                               np.full(250, 2 ** 30)])
    elif case == "one":
        keys = np.array([3])
    else:
        keys = np.zeros(0)
    return torch.from_numpy(np.sort(keys).astype(np.int64))


@pytest.mark.parametrize("case", [
    "long_runs", "all_equal", "all_distinct", "sentinel_n_buckets",
    "sentinel_2_30", "one", "empty"])
def test_run_ranks_equal_the_scan_bitwise(case):
    """``_run_ranks`` searches each key's run start in the sorted keys;
    its mask and int64 ranks are the scan's, bit for bit."""
    sk = _sorted_keys(case)
    unique, rank = qk._run_ranks(sk)
    want_unique, want_rank = _run_ranks_by_scan(sk)
    assert rank.dtype == torch.int64 and unique.dtype == torch.bool
    assert torch.equal(unique, want_unique)
    assert torch.equal(rank, want_rank)


@pytest.mark.parametrize("group_q,block_rows,shrink", [
    (32, 128, False), (8, 128, False), (4, 64, False), (32, 128, True),
])
def test_grouped_prep_matches_jax_bitwise(group_q, block_rows, shrink):
    """The six prep outputs at the same g_total (``shrink``: a g_total
    below the need, so both drop the same overflow groups)."""
    rng = np.random.default_rng(5)
    n, nb, nq, P, d_pad = 2000, 32, 70, 6, 128
    ids = rng.integers(0, nb, n).astype(np.int32)
    ids[:300] = 3  # a bucket above the cap
    jt = j_build(jnp.asarray(ids), nb)
    corpus = rng.normal(size=(n, 20)).astype(np.float32)
    jl = jqk.serving_layout(jt, jnp.asarray(corpus), cap=256,
                            block_rows=block_rows)
    pid, pv = _probes(rng, nq, P, nb)
    qe = rng.normal(size=(nq, d_pad)).astype(np.float32)
    max_blocks = jl.cap // block_rows
    g_total = jqk.grouped_static_bound(nq * P, max_blocks, jl.total_blocks,
                                       group_q)
    g_total = -(-g_total // 8) * 8
    exact = jqk.grouped_exact_bound(jl.counts, pid, pv, jl.cap, group_q,
                                    block_rows)
    if shrink:
        g_total = max(8, (exact // 2) // 8 * 8)
    want = jqk._grouped_prep_v2(
        jl.starts, jl.counts, jnp.asarray(pid), jnp.asarray(pv),
        jnp.asarray(qe), jnp.asarray(jl.cap, jnp.int32), g_total=g_total,
        max_blocks=max_blocks, group_q=group_q, block_rows=block_rows)
    starts = torch.from_numpy(np.array(jl.starts))
    counts = torch.from_numpy(np.array(jl.counts))
    tpid, tpv = torch.from_numpy(pid), torch.from_numpy(pv)
    got = qk._grouped_prep_v2(starts, counts, tpid, tpv, torch.from_numpy(qe),
                              jl.cap, g_total=g_total, max_blocks=max_blocks,
                              group_q=group_q, block_rows=block_rows)
    names = ("grp_block", "grp_qvecs", "grp_cnt", "ev_row", "ev_block", "ev_valid")
    for name, g, w in zip(names, got, want):
        _assert_same(g, w, name)
    assert qk.grouped_exact_bound(counts, tpid, tpv, jl.cap, group_q,
                                  block_rows) == exact
    assert int(qk.count_groups_v2(starts, counts, tpid, tpv, jl.cap, group_q,
                                  block_rows)) == exact
    assert qk.round_group_override(exact, g_total) == \
        jqk.round_group_override(exact, g_total)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_gather_engine_matches_jax(metric):
    rng = np.random.default_rng(6)
    n, d, nb, nq, P, k = 1500, 24, 32, 60, 5, 7
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    ids = rng.integers(0, nb, n).astype(np.int32)
    pid, pv = _probes(rng, nq, P, nb)
    jt = j_build(jnp.asarray(ids), nb)
    budget = int(jt.max_count())
    j_ids, j_d, j_cand = j_query(jt, jnp.asarray(corpus), jnp.asarray(queries),
                                 jnp.asarray(pid), jnp.asarray(pv), k=k,
                                 probe_budget=budget, metric=metric,
                                 query_chunk=16)
    t_ids, t_d, t_cand = query_bucket_table(
        build_bucket_table(torch.from_numpy(ids), nb), torch.from_numpy(corpus),
        torch.from_numpy(queries), torch.from_numpy(pid), torch.from_numpy(pv),
        k=k, probe_budget=budget, metric=metric, query_chunk=16)
    _assert_same(t_cand, j_cand, "n_candidates")
    assert (t_ids.numpy() == np.asarray(j_ids)).mean() >= 0.98
    fin = np.isfinite(np.asarray(j_d))
    np.testing.assert_allclose(t_d.numpy()[fin], np.asarray(j_d)[fin],
                               atol=1e-5, rtol=1e-5)
    assert (t_ids.numpy()[~fin] == -1).all()
