"""Port parity of the ensemble (``MultiTableIndexer``) and its params.

The port (plain kernels on the CPU) against the JAX package's
``MultiTableIndexer`` (Pallas engines in interpret mode) on the same
numpy inputs and the same stacked params: per-table hashes, the stacked
CSR tables, the flat serving layouts and ``exact_query_size`` bitwise;
``calibrate`` equal; ids of every engine on at least 0.98 of slots of
the JAX ``"xla"`` engine's (the gate of ``tests/test_parallel.py``),
``n_candidates`` exact per engine.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.models import get_encoder as j_encoder
from nlsh_tpu.models import get_hashing as j_hashing
from nlsh_tpu.ops.pallas import query_kernel as jqk
from nlsh_tpu.parallel.multitable import MultiTableIndexer as JMT
from nlsh_tpu.parallel.multitable import init_multi_table
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.parallel import MultiTableIndexer
from nlsh_tpu_torch.utils.checkpoint import read_msgpack, stacked_params_from_jax

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PARAMS_T8 = os.path.join(
    _ROOT, "benchmarks", "artifacts", "bench_cache",
    "cfgparams_mthr_glove100_b12_s600_b2048_t8_v2.msgpack")
BR = 128
L, DIM, BITS = 3, 16, 6


def _jax_tree(tree):
    """flax msgpack keeps a list as a map keyed "0", "1", ...; the JAX
    package's params hold lists."""
    if isinstance(tree, dict):
        if tree and all(k == str(i) for i, k in enumerate(tree)):
            return [_jax_tree(v) for v in tree.values()]
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def test_stacked_params_hash_like_jax_vmap():
    """The committed 8-table ensemble: each of the 8 modules hashes a few
    hundred rows exactly as ``vmap(hash_hard)`` of the JAX package."""
    tree = read_msgpack(_PARAMS_T8)["hashing"]

    def make():
        return get_hashing("MultivariateBernoulli",
                           get_encoder("siren", 100, [256, 256]), 12)

    hashings = stacked_params_from_jax(make, tree)
    assert len(hashings) == 8
    rows = np.random.default_rng(0).normal(size=(300, 100)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    jh = j_hashing("MultivariateBernoulli", j_encoder("siren", 100, [256, 256]),
                   12)
    want = np.asarray(jax.vmap(lambda p: jh.hash_hard(p, jnp.asarray(rows)))(
        _jax_tree(tree)))
    with torch.no_grad():
        got = np.stack([h.hash_hard(torch.from_numpy(rows)).numpy()
                        for h in hashings])
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 100
    bad = {"encoder": tree["encoder"], "out": {"w": tree["out"]["w"][:7],
                                              "b": tree["out"]["b"]}}
    with pytest.raises(ValueError, match="table axis"):
        stacked_params_from_jax(make, bad)


def _ensemble(metric="cosine", seed=0, n=1200, nq=40, n_tables=L):
    """The same small ensemble in both packages: narrow SIREN, 6 bits,
    random stacked params carried across, a clustered corpus of small
    dyadic values (exact f32 row norms, so layouts compare bitwise)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, DIM))
    pts = centers[rng.integers(0, 24, n + nq)] + 0.4 * rng.normal(
        size=(n + nq, DIM))
    pts = (np.round(pts * 8) / 8).astype(np.float32)
    corpus, queries = pts[:n], pts[n:]
    jh = j_hashing("MultivariateBernoulli", j_encoder("siren", DIM, [32]),
                   BITS)
    stacked = init_multi_table(jh, n_tables, jax.random.PRNGKey(seed))
    hashings = stacked_params_from_jax(
        lambda: get_hashing("MultivariateBernoulli",
                            get_encoder("siren", DIM, [32]), BITS),
        jax.tree.map(np.asarray, stacked))
    return corpus, queries, jh, stacked, hashings


def _jmt(jh, stacked, corpus, engine, metric="cosine"):
    return JMT(jh, stacked, jnp.asarray(corpus), metric=metric, engine=engine,
               block_rows=BR)


def _tmt(hashings, corpus, engine, metric="cosine"):
    return MultiTableIndexer(hashings, corpus, device="cpu", metric=metric,
                             engine=engine, block_rows=BR)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_stacked_tables_layouts_and_query_size_bitwise(metric):
    corpus, queries, jh, stacked, hashings = _ensemble(metric, seed=1)
    for engine, j_engine in (("windowed", "pallas-windowed"),
                             ("grouped", "pallas-grouped")):
        jm = _jmt(jh, stacked, corpus, j_engine, metric)
        tm = _tmt(hashings, corpus, engine, metric)
        for name in ("row_ids", "starts", "counts"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)),
                                          err_msg=name)
        assert tm.probe_budget == jm.probe_budget
        jl, tl = jm._serving_layout(), tm._serving_layout()
        for name in ("data", "row_map", "starts", "counts"):
            np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                          np.asarray(getattr(jl, name)),
                                          err_msg=f"{engine}: {name}")
        if metric == "cosine":
            assert tl.norms is None and jl.norms is None
        else:
            np.testing.assert_array_equal(tl.norms.numpy(),
                                          np.asarray(jl.norms))
        assert (tl.cap, tl.align, tl.total_blocks, tl.n_rows) == (
            jl.cap, jl.align, jl.total_blocks, jl.n_rows)
        assert tl.align == (8 if engine == "windowed" else BR)
    for ht in (1, 3):
        want = jm.exact_query_size(jnp.asarray(queries), hash_times=ht,
                                   probe_mode="flip")
        got = tm.exact_query_size(queries, hash_times=ht, probe_mode="flip")
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32


def test_dedupe_topk_matches_jax():
    rng = np.random.default_rng(2)
    n_rows = 50
    ids = rng.integers(0, n_rows, (30, 24)).astype(np.int32)
    ids[:, 3] = ids[:, 0]                   # duplicates
    ids[rng.random(ids.shape) < 0.2] = -1   # empty slots
    ids[0] = -1                             # a query with no candidates
    scores = np.round(rng.normal(size=ids.shape), 1).astype(np.float32)
    scores[ids < 0] = -np.inf
    for k in (5, 24):
        w_ids, w_top = JMT._dedupe_topk(jnp.asarray(ids), jnp.asarray(scores),
                                        k, n_rows)
        g_ids, g_top = MultiTableIndexer._dedupe_topk(
            torch.from_numpy(ids), torch.from_numpy(scores), k, n_rows)
        np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))
        np.testing.assert_array_equal(g_top.numpy(), np.asarray(w_top))
        assert g_ids.dtype == torch.int32
    assert (g_ids[0] == -1).all()
    for row in g_ids.numpy():
        real = row[row >= 0]
        assert len(set(real)) == len(real)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_engines_match_jax(metric):
    """windowed, grouped and gather ids vs the JAX "xla" engine; each
    engine's n_candidates equals its JAX counterpart's (summed occupancy
    on windowed/grouped, distinct count on gather)."""
    corpus, queries, jh, stacked, hashings = _ensemble(metric, seed=3)
    kw = dict(k=5, hash_times=3, probe_mode="flip")
    jx = _jmt(jh, stacked, corpus, "xla", metric)
    x_ids, x_cand = jx.query(jnp.asarray(queries), **kw)
    tm = _tmt(hashings, corpus, "gather", metric)
    g_ids, g_cand = tm.query(queries, **kw)
    np.testing.assert_array_equal(g_cand, np.asarray(x_cand))
    assert (g_ids == np.asarray(x_ids)).mean() >= 0.98
    for engine, j_engine in (("windowed", "pallas-windowed"),
                             ("grouped", "pallas-grouped")):
        tm.engine = engine
        t_ids, t_cand = tm.query(queries, **kw)
        j_ids, j_cand = _jmt(jh, stacked, corpus, j_engine, metric).query(
            jnp.asarray(queries), **kw)
        np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
        assert (t_cand >= g_cand).all()  # summed occupancy >= distinct
        assert (t_ids == np.asarray(x_ids)).mean() >= 0.98, engine
        assert (t_ids == g_ids).mean() >= 0.98, engine


def test_calibrate_guard_and_engine_switch():
    corpus, queries, jh, stacked, hashings = _ensemble(seed=4)
    jm = _jmt(jh, stacked, corpus, "pallas-windowed")
    tm = _tmt(hashings, corpus, "auto")
    assert tm.engine == "windowed"
    kw = dict(k=5, hash_times=2, probe_mode="flip")
    g = tm.calibrate(queries, hash_times=2, probe_mode="flip")
    assert g == jm.calibrate(jnp.asarray(queries), hash_times=2,
                             probe_mode="flip") >= 8
    # a batch within the calibration serves on the calibrated table
    layout = tm._serving_layout()
    gp, gv = tm._flat_probes(*tm._probes(torch.from_numpy(queries), 2,
                                         probe_mode="flip"))
    override, needed = tm.windowed_group_bound(layout, gp, gv)
    assert override == g and needed <= g
    assert needed == jqk.windowed_exact_bound(
        layout.starts.numpy(), layout.counts.numpy(), gp.numpy(), gv.numpy(),
        layout.cap, qk.GROUP_W, BR)
    c_ids, c_cand = tm.query(queries, **kw)
    ref = _tmt(hashings, corpus, "windowed")
    r_ids, r_cand = ref.query(queries, **kw)
    np.testing.assert_array_equal(c_cand, r_cand)
    np.testing.assert_array_equal(c_ids, r_ids)

    # a starved calibration: a batch that exceeds it takes the static
    # bound and loses nothing
    tm.calibrate(queries[:4], hash_times=1)
    gp4, gv4 = tm._flat_probes(*tm._probes(torch.from_numpy(queries), 4,
                                           probe_mode="flip"))
    override, needed = tm.windowed_group_bound(layout, gp4, gv4)
    assert override is None and needed > tm._g_cal
    s_ids, s_cand = tm.query(queries, k=5, hash_times=4, probe_mode="flip")
    f_ids, f_cand = ref.query(queries, k=5, hash_times=4, probe_mode="flip")
    np.testing.assert_array_equal(s_cand, f_cand)
    np.testing.assert_array_equal(s_ids, f_ids)
    # ...while serving it on the starved table would drop candidates
    from nlsh_tpu_torch.index.serving import serving_query_windowed

    bad, _, _ = serving_query_windowed(
        layout, torch.from_numpy(queries), gp4, gv4, layout.counts, k=15,
        row_k=5, g_total_override=tm._g_cal)
    good, _, _ = serving_query_windowed(
        layout, torch.from_numpy(queries), gp4, gv4, layout.counts, k=15,
        row_k=5)
    assert not torch.equal(bad, good)

    # an engine switch drops the stack and the calibration
    tm.engine = "grouped"
    assert tm._stacked is None and tm._g_cal is None
    assert tm._serving_layout().align == BR
    g_ids, g_cand = tm.query(queries, **kw)
    assert (g_ids == r_ids).mean() >= 0.98
    np.testing.assert_array_equal(g_cand, r_cand)
    with pytest.raises(ValueError, match="unknown engine"):
        tm.engine = "xla"


def test_sampled_probes_follow_the_generator():
    corpus, queries, _, _, hashings = _ensemble(seed=5, n=600, nq=12)
    tm = _tmt(hashings, corpus, "gather")
    a = tm.query(queries, k=5, hash_times=4,
                 generator=torch.Generator().manual_seed(3))
    b = MultiTableIndexer.fetch(tm.query_async(
        queries, k=5, hash_times=4, generator=torch.Generator().manual_seed(3)))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    pids, _ = tm._probes(torch.from_numpy(queries), 4)
    assert pids.shape == (L, 12, 4)
    assert not torch.equal(pids[0], pids[1])  # each table its own draws


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_ensemble_on_the_card(cuda_device, metric):
    """The ensemble serves through K3 on the card (calibrated and
    guarded), agrees with its plain scorer, the grouped engine (K1) and
    the gather engine; after a starved calibration the guard takes the
    static bound and the serve answers exactly as the calibrated one."""
    corpus, queries, _, _, hashings = _ensemble(metric, seed=6, n=6000,
                                                nq=300)
    idx = MultiTableIndexer(hashings, corpus, device=cuda_device,
                            metric=metric, block_rows=512)
    kw = dict(k=10, hash_times=3, probe_mode="flip")
    idx.calibrate(queries, hash_times=3, probe_mode="flip")
    before = qk.KERNEL_LAUNCHES["windowed_scores_topk"]
    ids, cand = idx.query(queries, **kw)
    assert qk.KERNEL_LAUNCHES["windowed_scores_topk"] > before
    p_ids, p_cand = idx.query(queries, plain=True, **kw)
    np.testing.assert_array_equal(cand, p_cand)
    assert (ids == p_ids).mean() >= 0.999
    g_starved = idx.calibrate(queries[:4], hash_times=1, probe_mode="flip")
    gp, gv = idx._flat_probes(*idx._probes(
        torch.as_tensor(queries, device=cuda_device), 3, probe_mode="flip"))
    override, needed = idx.windowed_group_bound(idx._serving_layout(), gp, gv)
    assert override is None and needed > g_starved
    s_ids, s_cand = idx.query(queries, **kw)
    np.testing.assert_array_equal(s_cand, cand)
    np.testing.assert_array_equal(s_ids, ids)
    idx.engine = "grouped"
    g_ids, g_cand = idx.query(queries, **kw)
    np.testing.assert_array_equal(cand, g_cand)
    assert (ids == g_ids).mean() >= 0.999
    idx.engine = "gather"
    x_ids, x_cand = idx.query(queries, **kw)
    assert (x_cand <= cand).all()
    assert (ids == x_ids).mean() >= 0.98
