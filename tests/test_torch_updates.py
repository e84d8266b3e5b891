"""Port parity of the ``Indexer``'s incremental updates.

``add`` / ``remove`` / ``compact`` of the port against the JAX package's
``Indexer`` on the same numpy inputs, on every engine of the port.
Tolerances: ``n_candidates``, ``n_fresh``, ``n_deleted`` and the rebuilt
CSR arrays are integers and match exactly; top-k ids agree on at least
0.98 of slots (f32 summation order may swap near-tied neighbours) and
exactly on the gather engine's crafted cases.  ``_merge_fresh`` and
``_drop_deleted`` are held to the JAX functions on crafted ties, where
``lax.top_k`` keeps the lowest position and the port sorts stably.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.index import indexer as jindexer
from nlsh_tpu.index.indexer import Indexer as JIndexer
from nlsh_tpu.models.encoders import MLPEncoder as JMLP
from nlsh_tpu.models.hashings import MultivariateBernoulli as JMVB
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.index import indexer as tindexer
from nlsh_tpu_torch.models import MLPEncoder, MultivariateBernoulli
from nlsh_tpu_torch.utils.checkpoint import params_from_jax

ENGINES = [("grouped", "pallas-grouped"), ("windowed", "pallas-windowed"),
           ("fixed", "pallas"), ("gather", "xla")]
KW = dict(k=10, hash_times=6, probe_mode="flip")


def _setup(metric="cosine", seed=4, n=2400, d=16, bits=5, nq=48):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, d))
    pts = centers[rng.integers(0, 20, n + nq)] + 0.5 * rng.normal(
        size=(n + nq, d))
    pts = pts.astype(np.float32)
    jh = JMVB(JMLP(d, (32,)), bits)
    params = jh.init(jax.random.PRNGKey(seed))
    th = MultivariateBernoulli(MLPEncoder(d, (32,)), bits)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    return pts[:n], pts[n:], jh, params, th


def _pair(engine, j_engine, corpus, jh, params, th, metric="cosine", **kw):
    ji = JIndexer(jh, params, jnp.asarray(corpus), metric=metric,
                  engine=j_engine, block_rows=128, **kw)
    ti = Indexer(th, corpus, device="cpu", metric=metric, engine=engine,
                 block_rows=128, **kw)
    return ji, ti


def _same_answers(ji, ti, queries, floor=0.98, **kw):
    kw = {**KW, **kw}
    j_ids, j_cand = ji.query(jnp.asarray(queries), **kw)
    t_ids, t_cand = ti.query(queries, **kw)
    assert t_ids.dtype == np.int32 and t_ids.shape == np.asarray(j_ids).shape
    np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
    assert (t_ids == np.asarray(j_ids)).mean() >= floor
    return t_ids, t_cand


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("engine,j_engine", ENGINES)
def test_add_remove_compact_match_jax(engine, j_engine, metric):
    corpus, queries, jh, params, th = _setup(metric)
    n0, held = 2000, corpus[2000:]
    ji, ti = _pair(engine, j_engine, corpus[:n0], jh, params, th, metric)
    base_ids, base_cand = _same_answers(ji, ti, queries)

    # inserts are served by the very next query, from the buffer
    for idx in (ji, ti):
        idx.add(held[:150])
        idx.add(held[150:])
    assert ti.n_fresh == ji.n_fresh == 400
    ids, cand = _same_answers(ji, ti, queries)
    np.testing.assert_array_equal(cand, base_cand + 400)
    assert (ids >= n0).any()        # some buffered rows are answers

    # tombstones: half among the current answers, some in the buffer
    rng = np.random.default_rng(0)
    answered = np.unique(ids[ids >= 0])
    dead = np.unique(np.concatenate([
        rng.choice(answered, 20, replace=False),
        rng.choice(n0, 15, replace=False),
        n0 + rng.choice(400, 5, replace=False)])).astype(np.int32)
    for idx in (ji, ti):
        idx.remove(dead[:10])
        idx.remove(dead[5:])            # overlapping calls: a set union
    assert ti.n_deleted == ji.n_deleted == dead.size
    ids2, cand2 = _same_answers(ji, ti, queries)
    assert not np.isin(ids2, dead).any()
    # n_candidates counts tombstoned candidates until compact
    np.testing.assert_array_equal(cand2, cand)

    for idx in (ji, ti):
        idx.compact()
    assert ti.n_fresh == ti.n_deleted == 0
    assert ti.corpus.shape[0] == corpus.shape[0]
    for name in ("row_ids", "starts", "counts"):
        np.testing.assert_array_equal(getattr(ti.table, name).numpy(),
                                      np.asarray(getattr(ji.table, name)))
    assert ti.probe_budget == ji.probe_budget     # the default follows
    ids3, _ = _same_answers(ji, ti, queries)
    assert not np.isin(ids3, dead).any()
    # ... and equals an index built from scratch with the sentinel codes
    codes = tindexer.hash_corpus(th, torch.from_numpy(corpus))
    codes[torch.from_numpy(dead).long()] = th.n_buckets
    table = tindexer.build_bucket_table(codes, th.n_buckets)
    scratch = Indexer(th, corpus, device="cpu", metric=metric, engine=engine,
                      block_rows=128, table=table)
    s_ids, s_cand = scratch.query(queries, **KW)
    np.testing.assert_array_equal(ids3, s_ids)


@pytest.mark.parametrize("engine,j_engine", ENGINES)
def test_many_tombstones_overfetch_far_above_the_fused_k(engine, j_engine):
    """600 tombstones make the engines fetch k + 1,024: the grouped and
    windowed serves leave their fused top-k (per-block k <= 16) for the raw
    panels, and k_eff exceeds many buckets' live rows."""
    corpus, queries, jh, params, th = _setup(seed=6)
    ji, ti = _pair(engine, j_engine, corpus, jh, params, th)
    rng = np.random.default_rng(1)
    first, _ = ti.query(queries, **KW)
    dead = np.unique(np.concatenate([
        first[:, :3].ravel(), rng.choice(corpus.shape[0], 600)]))[:600]
    for idx in (ji, ti):
        idx.remove(dead.astype(np.int32))
    assert ti.n_deleted == 600
    ids, _ = _same_answers(ji, ti, queries)
    assert not np.isin(ids, dead).any()
    # the exact answer: rerank of the same candidates without the dead ids
    plain = Indexer(th, corpus, device="cpu", engine="gather")
    plain.remove(dead.astype(np.int32))
    g_ids, _ = plain.query(queries, **KW)
    assert (ids == g_ids).mean() >= 0.98


def test_user_budget_persists_over_compact_and_default_follows():
    corpus, queries, jh, params, th = _setup(seed=7)
    for budget in (24, None):
        ji, ti = _pair("grouped", "pallas-grouped", corpus[:1500], jh, params,
                       th, probe_budget=budget)
        before = ti.probe_budget
        _ = ti.layout
        for idx in (ji, ti):
            idx.add(corpus[1500:])
            idx.compact()
        assert ti._layout is None               # compact drops the layout
        assert ti.probe_budget == ji.probe_budget
        if budget is not None:
            assert ti.probe_budget == before == 24
        else:
            assert ti.probe_budget == ti.table.max_count() >= before
        _same_answers(ji, ti, queries)
    ti.compact()                                # nothing pending: a no-op
    assert ti._layout is not None


def test_save_refuses_pending_updates_and_remove_checks_range(tmp_path):
    corpus, _, jh, params, th = _setup(n=600)
    ji, ti = _pair("gather", "xla", corpus[:500], jh, params, th)
    for idx in (ji, ti):
        idx.add(corpus[500:])
    for bad in ([-1], [600], [0, 9999]):
        with pytest.raises(ValueError) as want:
            ji.remove(bad)
        with pytest.raises(ValueError) as got:
            ti.remove(bad)
        assert str(got.value) == str(want.value)
    ti.remove(599)                              # a buffered row, as a scalar
    ji.remove(599)
    for idx, path in ((ji, "j.npz"), (ti, "t.npz")):
        with pytest.raises(ValueError, match="compact\\(\\) before save"):
            idx.save(str(tmp_path / path))
    ti.compact()
    ti.save(str(tmp_path / "t.npz"))
    back = Indexer.load(str(tmp_path / "t.npz"), th, ti.corpus, device="cpu")
    assert int(back.table.counts.sum()) == 599  # the tombstone stays dropped
    with pytest.raises(ValueError, match="registered metric"):
        Indexer(th, corpus, device="cpu", metric="nope").add(corpus[:2])


# -- the two plain functions on crafted ties --------------------------------

def test_merge_fresh_ties_keep_the_lowest_position():
    """Duplicated rows give exactly equal distances: base winners come
    before buffered rows, earlier buffered rows before later ones; padded
    base slots (-1) rank last and stay -1."""
    rng = np.random.default_rng(2)

    def rows(n):
        # four entries of +-1 in 16: the norm is exactly 2, so every
        # normalised entry, dot product and squared distance is exact in
        # f32 and equal rows tie exactly under both metrics
        out = np.zeros((n, 16), np.float32)
        for r in out:
            r[rng.choice(16, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
        return out

    corpus = rows(30)
    fresh = np.concatenate([corpus[[3, 3, 7]], rows(2)])
    queries = np.concatenate([corpus[[3, 7]], rows(3)])
    base_ids = np.array([[3, 5, -1, -1], [7, 3, 9, -1], [1, 2, -1, -1],
                         [-1, -1, -1, -1], [4, 4, 6, 8]], np.int32)
    n_cand = np.arange(5, dtype=np.int32)
    for metric in ("cosine", "euclidean"):
        for k in (4, 3):
            want_ids, want_n = jindexer._merge_fresh(
                jnp.asarray(corpus), jnp.asarray(fresh), jnp.asarray(queries),
                jnp.asarray(base_ids[:, :k]), jnp.asarray(n_cand), k=k,
                metric=metric)
            got_ids, got_n = tindexer._merge_fresh(
                torch.from_numpy(corpus), torch.from_numpy(fresh),
                torch.from_numpy(queries), torch.from_numpy(base_ids[:, :k]),
                torch.from_numpy(n_cand), k=k, metric=metric)
            assert got_ids.dtype == torch.int32
            np.testing.assert_array_equal(got_ids.numpy(),
                                          np.asarray(want_ids))
            np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    # query 0 is corpus row 3, which the buffer holds twice more
    assert got_ids[0].tolist()[:3] == [3, 30, 31]
    # all-padded base: only buffered rows (5 of them), no -1 inside top 3
    assert (got_ids[3] >= 30).all()


def test_merge_fresh_pads_when_fewer_than_k_candidates():
    corpus = np.eye(4, dtype=np.float32)
    fresh = np.ones((1, 4), np.float32)
    queries = np.eye(4, dtype=np.float32)[:2]
    base_ids = np.array([[0, -1, -1], [-1, -1, -1]], np.int32)
    args = (corpus, fresh, queries, base_ids, np.zeros(2, np.int32))
    want, _ = jindexer._merge_fresh(*map(jnp.asarray, args), k=3,
                                    metric="euclidean")
    got, _ = tindexer._merge_fresh(*map(torch.from_numpy, args), k=3,
                                   metric="euclidean")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[0, 4, -1], [4, -1, -1]]


@pytest.mark.parametrize("k", [1, 3, 6])
def test_drop_deleted_is_a_stable_partition(k):
    ids = np.array([[5, 9, 2, 7, 11, 4], [9, 9, 5, -1, 2, -1],
                    [-1, -1, -1, -1, -1, -1], [1, 3, 6, 8, 10, 12],
                    [2, 5, 9, 2, 5, 9]], np.int32)
    for dead in ([2, 5, 9], [0], [12], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]):
        dead = np.asarray(dead, np.int32)
        want = jindexer._drop_deleted(jnp.asarray(ids), jnp.asarray(dead), k=k)
        got = tindexer._drop_deleted(torch.from_numpy(ids),
                                     torch.from_numpy(dead), k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tindexer._drop_deleted(torch.from_numpy(ids),
                                 torch.tensor([2, 5, 9], dtype=torch.int32), 6)
    assert got[0].tolist() == [7, 11, 4, -1, -1, -1]    # order kept


def test_table_argument_skips_the_hash(monkeypatch):
    corpus, queries, _, _, th = _setup(n=500)
    built = Indexer(th, corpus, device="cpu", engine="gather")
    monkeypatch.setattr(tindexer, "hash_corpus",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError))
    again = Indexer(th, corpus, device="cpu", engine="gather",
                    table=built.table)
    assert not again._budget_user
    assert again.probe_budget == built.probe_budget
    for got, want in zip(again.query(queries, **KW),
                         built.query(queries, **KW)):
        np.testing.assert_array_equal(got, want)
