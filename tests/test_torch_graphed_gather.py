"""The last repeated serve programs as one dispatch: the windowed
ensemble guard's ``lax.cond`` inside the serve's graph
(``utils.graphs.cond``), the gather engine as one graph per batch
(single table, ensemble, sharded), and the sweep step as one graph per
sweep and engine with ``n`` a device input.

On the CPU (a graph's body runs eagerly there) each body is held to the
JAX package: the guarded ensemble body at a calibrated, a starved and no
group count, alone and batched, bitwise JAX ``_fused_mt_serve`` with its
``lax.cond``; ``cond`` taking each branch; the gather bodies bitwise JAX
``Indexer(engine="xla")`` / ``MultiTableIndexer(engine="xla")`` and the
old chunk loop, the sharded one against the JAX sharded gather; the sweep
body at several ``n`` bitwise JAX ``_sweep_step``.

On the card (``cuda`` marker, skipped without one) each replay equals its
eager body bit for bit, a starved ensemble batch is served inside one
replay (alone and batched), several ``cond`` share one graph,
``query_async`` and a sweep step's replay make no host sync
(``torch.cuda.set_sync_debug_mode("error")``), and a planted ``.item()``
fails the capture.  The module imports no JAX (the CPU tests import it
inside), so the card's tests run where JAX is not installed, in a
process of their own (two fail a capture on purpose):

    python -m pytest --noconftest -m cuda tests/test_torch_graphed_gather.py
"""

import numpy as np
import pytest
import torch

from nlsh_tpu_torch.index import Indexer, build_bucket_table, hash_corpus
from nlsh_tpu_torch.index.indexer import _gather_body
from nlsh_tpu_torch.index.query import query_bucket_table
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.parallel import Mesh, MultiTableIndexer, ShardedIndexer
from nlsh_tpu_torch.parallel.multitable import (
    _fused_mt_serve,
    _fused_mt_serve_batched,
    _mt_serve_body,
    _windowed_needed_groups,
    init_multi_table,
)
from nlsh_tpu_torch.utils import graphs

L, DIM, BITS, BR, K, P = 3, 16, 6, 128, 5, 2
STARVED = 8  # groups: far below any batch's need here
SWEEP_ENGINES = ["gather", "grouped", "windowed", "fixed"]


# -- cond ---------------------------------------------------------------------

@pytest.mark.parametrize("taken", [True, False])
def test_cond_takes_one_branch_on_the_cpu(taken, monkeypatch):
    """On the CPU ``cond`` reads ``pred`` and runs the one branch it
    names, a tuple or a tensor; the warm-up's both-branch run is for card
    tensors only."""
    calls = []

    def branch(name, scale):
        def fn(x):
            calls.append(name)
            return x * scale, x + scale
        return fn

    x = torch.arange(4.0)
    pred = torch.tensor(taken)
    a, b = graphs.cond(pred, branch("true", 2.0), branch("false", 3.0), x)
    s = 2.0 if taken else 3.0
    assert torch.equal(a, x * s) and torch.equal(b, x + s)
    assert calls == ["true" if taken else "false"]
    monkeypatch.setattr(graphs, "_warming", True)
    one = graphs.cond(pred.reshape(1, 1).to(torch.int32),
                      lambda: x[:1] * 0, lambda: x[:1] + 7)
    assert torch.equal(one, x[:1] * 0 if taken else x[:1] + 7)


# -- the guarded ensemble body ------------------------------------------------

def _ensemble(seed: int, n: int = 1021, nq: int = 32):
    """A small ensemble in both packages: narrow SIREN, 6 bits, random
    stacked params carried across, a clustered corpus of small dyadic
    values (exact f32 norms and dots)."""
    import jax
    import jax.numpy as jnp

    from nlsh_tpu.models import get_encoder as j_encoder
    from nlsh_tpu.models import get_hashing as j_hashing
    from nlsh_tpu.parallel.multitable import MultiTableIndexer as JMT
    from nlsh_tpu.parallel.multitable import init_multi_table as j_init
    from nlsh_tpu_torch.utils.checkpoint import stacked_params_from_jax

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, DIM))
    pts = centers[rng.integers(0, 24, n + nq)] + 0.4 * rng.normal(
        size=(n + nq, DIM))
    pts = (np.round(pts * 8) / 8).astype(np.float32)
    jh = j_hashing("MultivariateBernoulli", j_encoder("siren", DIM, [32]),
                   BITS)
    stacked = j_init(jh, L, jax.random.PRNGKey(seed))
    hashings = stacked_params_from_jax(
        lambda: get_hashing("MultivariateBernoulli",
                            get_encoder("siren", DIM, [32]), BITS),
        jax.tree.map(np.asarray, stacked))

    def pair(engine, j_engine, mesh=None, j_mesh=None):
        jm = JMT(jh, stacked, jnp.asarray(pts[:n]), metric="cosine",
                 engine=j_engine, block_rows=BR, mesh=j_mesh)
        tm = MultiTableIndexer(hashings, pts[:n], device="cpu", mesh=mesh,
                               metric="cosine", engine=engine, block_rows=BR)
        return jm, tm

    return pts[n:], jh, stacked, pair


@pytest.fixture(scope="module")
def guarded():
    """The windowed ensemble, its calibrated count and its batch's need."""
    queries, jh, stacked, pair = _ensemble(seed=2)
    jm, tm = pair("windowed", "pallas-windowed")
    g_cal = tm.calibrate(queries, hash_times=P, probe_mode="flip")
    gp, gv = tm._flat_probes(*tm._probes(torch.from_numpy(queries),
                                         hash_times=P, probe_mode="flip"))
    need = int(_windowed_needed_groups(tm._serving_layout(), gp, gv))
    assert STARVED < need <= g_cal
    return queries, jh, stacked, jm, tm, g_cal


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("calibration", ["calibrated", "starved", "none"])
def test_guarded_body_matches_jax_lax_cond(guarded, calibration, batched):
    """The body's ``cond`` (the calibrated serve where the batch fits, the
    static bound where it does not) bitwise the JAX package's
    ``lax.cond``, one batch and a fresh-query pool of 3; every case gives
    the same answer."""
    import jax
    import jax.numpy as jnp

    from nlsh_tpu.parallel.multitable import _fused_mt_serve as j_mt
    from nlsh_tpu.parallel.multitable import (
        _fused_mt_serve_batched as j_batched,
    )

    queries, jh, stacked, jm, tm, g_cal = guarded
    g = {"calibrated": g_cal, "starved": STARVED, "none": None}[calibration]
    kw = dict(k=K, hash_times=P, n_rows=tm.n_rows, g_override=g,
              probe_mode="flip")
    layout, j_layout = tm._serving_layout(), jm._serving_layout()
    if batched:
        pool = np.stack([queries, queries[::-1], queries * 0.5])
        want = np.asarray(j_batched(jh, stacked, j_layout, jnp.asarray(pool),
                                    jax.random.PRNGKey(0),
                                    engine="pallas-windowed", repeats=3,
                                    **kw))
        got = _fused_mt_serve_batched(tm.hashings, layout,
                                      torch.from_numpy(pool),
                                      engine="windowed", repeats=3, **kw)
    else:
        want = np.asarray(j_mt(jh, stacked, j_layout, jnp.asarray(queries),
                               jax.random.PRNGKey(0),
                               engine="pallas-windowed", **kw))
        got = _fused_mt_serve(tm.hashings, layout, torch.from_numpy(queries),
                              engine="windowed", **kw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    body = _mt_serve_body(tm.hashings, layout, k=K, hash_times=P,
                          engine="windowed", n_rows=tm.n_rows, g_override=None,
                          probe_mode="flip")
    np.testing.assert_array_equal(
        want[0] if batched else want,
        body(torch.from_numpy(queries), None).numpy())


# -- the gather engine --------------------------------------------------------

@pytest.mark.parametrize("query_chunk", [None, 8])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_single_gather_body_matches_jax_and_the_chunk_loop(metric,
                                                           query_chunk):
    """``Indexer(engine="gather")`` (the body run eagerly on the CPU) bitwise
    the JAX ``Indexer(engine="xla")`` and the chunk loop called directly,
    one chunk and four; ``query_async`` returns the packed tensor."""
    import jax.numpy as jnp

    from nlsh_tpu.index.indexer import Indexer as JIndexer
    from torch_fused_common import _single

    corpus, queries, jh, params, th = _single(seed=5)
    ji = JIndexer(jh, params, jnp.asarray(corpus), metric=metric,
                  engine="xla")
    ti = Indexer(th, corpus, device="cpu", metric=metric, engine="gather")
    kw = dict(k=K, hash_times=4, probe_mode="flip", query_chunk=query_chunk)
    j_ids, j_cand = ji.query(jnp.asarray(queries), **kw)
    packed = ti.query_async(queries, **kw)
    assert torch.is_tensor(packed) and packed.shape == (len(queries), K + 1)
    np.testing.assert_array_equal(packed[:, :-1].numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(packed[:, -1].numpy(), np.asarray(j_cand))
    q = torch.from_numpy(queries)
    pid, pv = th.hash(q, n_probes=4, probe_mode="flip")
    ids, _, cand = query_bucket_table(
        ti.table, ti.corpus, q, pid, pv, k=K, probe_budget=ti.probe_budget,
        metric=metric, query_chunk=query_chunk or 256)
    assert torch.equal(packed, torch.cat([ids, cand[:, None]], dim=1))
    assert len(ti._graphs) == 0  # CPU tensors run the body eagerly


@pytest.mark.parametrize("n_dev", [None, 3])
def test_ensemble_gather_body_matches_jax(n_dev):
    """The ensemble's gather (no mesh, and a mesh of three CPU entries, a
    table each: one device) bitwise the JAX
    ``MultiTableIndexer(engine="xla")`` on as many virtual devices, flip
    probes, and the eager path of a mesh over several devices bit for
    bit."""
    import jax.numpy as jnp

    from nlsh_tpu.parallel import make_mesh as j_make_mesh
    from nlsh_tpu_torch.parallel import make_mesh

    queries, _, _, pair = _ensemble(seed=7, n=900)
    mesh = None if n_dev is None else make_mesh(n_dev, "table",
                                                platform="cpu")
    j_mesh = None if n_dev is None else j_make_mesh(n_dev, axis="table")
    if n_dev is not None:
        assert mesh.on_one_device()
    jm, tm = pair("gather", "xla", mesh, j_mesh)
    kw = dict(k=K, hash_times=P, probe_mode="flip")
    j_ids, j_cand = jm.query(jnp.asarray(queries), **kw)
    packed = tm.query_async(queries, **kw)
    assert torch.is_tensor(packed) and packed.shape == (len(queries), K + 1)
    np.testing.assert_array_equal(packed[:, :-1].numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(packed[:, -1].numpy(), np.asarray(j_cand))
    q = torch.from_numpy(queries)
    pids, pvalid = tm._probes(q, P, probe_mode="flip")
    assert torch.equal(packed, tm._gather_serve(q, pids, pvalid, K))
    np.testing.assert_array_equal(tm.query(queries, plain=True, **kw)[0],
                                  np.asarray(j_ids))


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_gather_body_matches_jax_and_the_eager_path(n_dev,
                                                            monkeypatch):
    """``ShardedIndexer(engine="gather")`` on a mesh of CPU entries (one
    device: the graph's path, its body eager here) against the JAX
    sharded gather, and bit for bit against the path of a mesh over
    several devices; sampled probes follow the generator either way."""
    from torch_sharded_common import (
        QUERIES,
        assert_same_answers,
        jax_index,
        make_heads,
        port_index,
        tquery,
    )

    heads = make_heads()
    t = port_index(heads, n_dev, "gather")
    assert t.mesh.on_one_device()
    got = tquery(t)
    assert_same_answers(got, jax_index(heads, n_dev, "gather")[1])
    q = torch.from_numpy(QUERIES)
    kw = dict(k=K, hash_times=4)
    on_one = [t.query_async(q, probe_mode="flip", **kw),
              t.query_async(q, generator=torch.Generator().manual_seed(3),
                            **kw)]
    monkeypatch.setattr(Mesh, "on_one_device", lambda self: False)
    eager = [t.query_async(q, probe_mode="flip", **kw),
             t.query_async(q, generator=torch.Generator().manual_seed(3),
                           **kw)]
    for a, b in zip(on_one, eager):
        assert torch.equal(a, b)


# -- the sweep step -----------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_case():
    """The small synthetic case in both packages, its JAX table and raw
    codes, and the port's table over the same codes."""
    import jax
    import jax.numpy as jnp

    from nlsh_tpu.cli.evaluate import sample_probe_codes as j_codes
    from nlsh_tpu.index import build_bucket_table as j_build
    from nlsh_tpu.index.indexer import hash_corpus as j_hash
    from torch_eval_common import small_case

    data, jh, params, th = small_case()
    corpus = np.asarray(data.training, np.float32)
    queries = np.asarray(data.testing, np.float32)
    jt = j_build(j_hash(jh, params, jnp.asarray(corpus)), jh.n_buckets)
    raw = np.asarray(j_codes(jh, params, jnp.asarray(queries), 6,
                             jax.random.PRNGKey(0)))
    tt = build_bucket_table(hash_corpus(th, torch.from_numpy(corpus)),
                            th.n_buckets)
    np.testing.assert_array_equal(tt.row_ids.numpy(), np.asarray(jt.row_ids))
    return corpus, queries, raw, jt, tt, max(tt.max_count(), 1)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_sweep_body_matches_jax_sweep_step(sweep_case, n):
    """The gather sweep body at ``n`` (a 0-d int32 tensor, as the graph
    takes it) bitwise the JAX package's ``_sweep_step`` (``n`` traced)."""
    import jax.numpy as jnp

    from nlsh_tpu.cli.evaluate import _sweep_step
    from nlsh_tpu.index.query import default_query_chunk
    from nlsh_tpu_torch.cli.evaluate import sweep_body

    corpus, queries, raw, jt, tt, budget = sweep_case
    j_ids, j_cand = _sweep_step(
        jt, jnp.asarray(corpus), jnp.asarray(queries), jnp.asarray(raw),
        jnp.asarray(n), k=K, probe_budget=budget, metric="cosine",
        query_chunk=default_query_chunk(raw.shape[1], budget,
                                        corpus.shape[1]))
    body = sweep_body(tt, torch.from_numpy(corpus), torch.from_numpy(queries),
                      torch.from_numpy(raw), K, budget, "cosine", "gather")
    packed = body(torch.tensor(n, dtype=torch.int32))
    np.testing.assert_array_equal(packed[:, :-1].numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(packed[:, -1].numpy(), np.asarray(j_cand))


@pytest.mark.parametrize("engine", SWEEP_ENGINES)
def test_sweep_step_is_its_body_at_every_value(sweep_case, engine):
    """``sweep_step(n)`` (the graph's path; its body eager on the CPU) is
    the body at every ``n``, and the kernel engines give the gather
    engine's candidates."""
    from nlsh_tpu_torch.cli.evaluate import sweep_body, sweep_step

    corpus, queries, raw, _, tt, budget = sweep_case
    args = (tt, torch.from_numpy(corpus), torch.from_numpy(queries),
            torch.from_numpy(raw), K, budget, "cosine")
    step = sweep_step(*args, engine)
    body, gather = sweep_body(*args, engine), sweep_body(*args, "gather")
    for n in range(1, raw.shape[1] + 1):
        nt = torch.tensor(n, dtype=torch.int32)
        got = step(n)
        assert torch.equal(got, body(nt))
        assert torch.equal(got[:, -1], gather(nt)[:, -1])


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (a captured graph has no CPU mode)")
    return torch.device("cuda", 0)


def _card_data(seed=12):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, 32))
    pts = centers[rng.integers(0, 64, 20600)] + 0.3 * rng.normal(
        size=(20600, 32))
    pts = pts.astype(np.float32)
    return pts[:20000], torch.from_numpy(pts[20000:]).reshape(2, 300, 32)


def _card_head(bits=7, seed=0):
    return get_hashing("MultivariateBernoulli", get_encoder("mlp", 32, [64]),
                       bits).init(torch.Generator().manual_seed(seed))


def _card_ensemble(device, engine, n_dev=None):
    corpus, qs = _card_data()
    hashings = init_multi_table(_card_head(5), 4,
                                torch.Generator().manual_seed(1))
    mesh = None if n_dev is None else Mesh([device] * n_dev, "table")
    idx = MultiTableIndexer(hashings, corpus, engine=engine, device=device,
                            mesh=mesh)
    return idx, qs.to(device)


def _card_index(device, kind):
    """``(index, query batches, the eager body of a batch)``."""
    corpus, qs = _card_data()
    qs = qs.to(device)
    kw = dict(k=10, hash_times=4, probe_mode="flip")
    if kind == "single":
        idx = Indexer(_card_head(), corpus, device=device, engine="gather")
        body = _gather_body(
            idx.hashing, idx.table, idx.corpus, probe_budget=idx.probe_budget,
            metric=idx.metric, query_chunk=64, **kw)
        return idx, qs, lambda q: body(q, None), dict(query_chunk=64, **kw)
    if kind.startswith("sharded"):
        n_dev = int(kind[-1])
        idx = ShardedIndexer(_card_head(), corpus,
                             Mesh([device] * n_dev, "shard"), engine="gather")
        body = idx._gather_body(10, 4, "flip", 64)
        return idx, qs, lambda q: body(q, None), dict(query_chunk=64, **kw)
    idx, qs = _card_ensemble(device, "gather",
                             None if kind == "ensemble" else 2)
    body = idx._gather_body(10, 4, "flip")
    return idx, qs, lambda q: body(q, None), kw


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["single", "ensemble", "ensemble_mesh",
                                  "sharded_1", "sharded_4"])
def test_gather_replay_equals_the_eager_body(cuda_device, kind):
    """One graph per batch shape: each replay gives the gather body's
    eager ids and candidates bit for bit, a second batch reuses the graph
    and gives its own answer, and the graph's pool is recorded."""
    idx, qs, eager, kw = _card_index(cuda_device, kind)
    for q in qs:
        packed = idx.query_async(q, **kw)
        assert len(idx._graphs) == 1
        with torch.no_grad():
            assert torch.equal(packed, eager(q))
        assert torch.equal(idx.query_async(q, **kw), packed)
    assert idx._graphs.pool_bytes()[0] > 0
    assert not torch.equal(idx.query_async(qs[0], **kw),
                           idx.query_async(qs[1], **kw))


@pytest.mark.cuda
def test_a_starved_batch_is_served_inside_one_replay(cuda_device):
    """After a starved calibration the windowed ensemble's replay takes
    the static-bound branch on the card: the calibrated serve's ids and
    candidates, one graph, one K3 launch per replay, the eager body's
    answer bit for bit."""
    idx, qs = _card_ensemble(cuda_device, "windowed")
    kw = dict(k=10, hash_times=4, probe_mode="flip")
    q = qs[0]
    idx.calibrate(q, hash_times=4, probe_mode="flip")
    calibrated = idx.query_async(q, **kw)
    g_starved = idx.calibrate(q[:2], hash_times=1, probe_mode="flip")
    layout = idx._serving_layout()
    gp, gv = idx._flat_probes(*idx._probes(q, 4, probe_mode="flip"))
    assert int(_windowed_needed_groups(layout, gp, gv)) > g_starved
    starved = idx.query_async(q, **kw)  # the capture
    assert len(idx._graphs) == 1
    before = qk.KERNEL_LAUNCHES["windowed_scores_topk"]
    again = idx.query_async(q, **kw)
    assert qk.KERNEL_LAUNCHES["windowed_scores_topk"] == before + 1
    assert torch.equal(starved, calibrated) and torch.equal(again, calibrated)
    body = _mt_serve_body(idx.hashings, layout, k=10, hash_times=4,
                          engine="windowed", n_rows=idx.n_rows,
                          g_override=g_starved, probe_mode="flip")
    with torch.no_grad():
        assert torch.equal(body(q, None), calibrated)


@pytest.mark.cuda
def test_several_conds_in_one_graph_take_their_branches(cuda_device):
    """Four ``cond`` in one captured body, each on its own flag: every
    replay takes the branch each flag names, on one graph."""
    cache = graphs.GraphCache()

    def body(x, flags):
        return torch.stack([
            graphs.cond(flags[i], lambda i=i: x * (i + 2), lambda i=i: x - i)
            for i in range(4)])

    x = torch.arange(6.0, device=cuda_device)
    for bits in ([1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 1], [0, 1, 0, 1]):
        flags = torch.tensor(bits, dtype=torch.bool, device=cuda_device)
        want = torch.stack([x * (i + 2) if b else x - i
                            for i, b in enumerate(bits)])
        assert torch.equal(cache.run("conds", body, (x, flags)), want)
    assert len(cache) == 1


@pytest.mark.cuda
def test_batched_guard_takes_each_repeats_branch(cuda_device):
    """``_fused_mt_serve_batched`` at a calibrated and a starved count:
    one graph of three guarded repeats, each repeat its eager body's
    answer bit for bit, as the JAX package's ``lax.map`` of ``lax.cond``
    gives it."""
    idx, qs = _card_ensemble(cuda_device, "windowed")
    g_cal = idx.calibrate(qs[0], hash_times=4, probe_mode="flip")
    layout = idx._serving_layout()
    kw = dict(k=10, hash_times=4, n_rows=idx.n_rows, probe_mode="flip")
    pool = torch.stack([qs[0], qs[1], qs[0].flip(0)])
    for g in (g_cal, STARVED):
        got = _fused_mt_serve_batched(idx.hashings, layout, pool,
                                      engine="windowed", repeats=3,
                                      g_override=g, graphs=graphs.GraphCache(),
                                      **kw)
        body = _mt_serve_body(idx.hashings, layout, engine="windowed",
                              g_override=g, **kw)
        with torch.no_grad():
            for i in range(3):
                assert torch.equal(got[i], body(pool[i], None)), (g, i)


def _sweep_steps(device):
    from nlsh_tpu_torch.cli.evaluate import sample_probe_codes, sweep_body
    from nlsh_tpu_torch.cli.evaluate import sweep_step

    corpus, qs = _card_data()
    head = _card_head().to(device)
    c = torch.from_numpy(corpus).to(device)
    q = qs[0].to(device)
    table = build_bucket_table(hash_corpus(head, c), head.n_buckets)
    raw = sample_probe_codes(head, q, 8,
                             torch.Generator(device=device).manual_seed(0))
    args = (table, c, q, raw, 10, table.max_count(), "cosine")
    return {e: (sweep_step(*args, e), sweep_body(*args, e))
            for e in SWEEP_ENGINES}


@pytest.mark.cuda
def test_sweep_replays_equal_the_eager_body(cuda_device):
    """One graph per sweep and engine, replayed at every ``n``: bit for
    bit the body run eagerly at that ``n``."""
    for engine, (step, body) in _sweep_steps(cuda_device).items():
        for n in range(1, 9):
            got = step(n)
            with torch.no_grad():
                want = body(torch.tensor(n, dtype=torch.int32,
                                         device=cuda_device))
            assert torch.equal(got, want), (engine, n)


@pytest.mark.cuda
def test_replays_make_no_host_sync(cuda_device):
    """After its capture, ``query_async`` on the guarded (starved)
    windowed ensemble, on the single-table and the ensemble's gather
    engine, and a sweep step's replay run under
    ``set_sync_debug_mode("error")``."""
    kw = dict(k=10, hash_times=4, probe_mode="flip")
    mt, qs = _card_ensemble(cuda_device, "windowed")
    mt.calibrate(qs[0][:2], hash_times=1, probe_mode="flip")
    single, _, _, single_kw = _card_index(cuda_device, "single")
    gather, _, _, _ = _card_index(cuda_device, "ensemble")
    sweep = _sweep_steps(cuda_device)
    runs = [lambda: mt.query_async(qs[0], **kw),
            lambda: single.query_async(qs[0], **single_kw),
            lambda: gather.query_async(qs[0], **kw)]
    runs += [lambda s=step: s(5) for step, _ in sweep.values()]
    for run in runs:
        run()  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for run in runs:
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["gather", "sweep"])
def test_a_host_read_in_the_body_fails_the_capture(cuda_device, where,
                                                   monkeypatch):
    """A ``.item()`` planted in the gather body or the sweep body raises
    at the capture, with no eager fallback."""
    from nlsh_tpu_torch.cli import evaluate
    from nlsh_tpu_torch.index import indexer

    module, name = (indexer, "_gather_body") if where == "gather" else \
        (evaluate, "sweep_body")
    original = getattr(module, name)

    def planted(*args, **kwargs):
        body = original(*args, **kwargs)
        return lambda *a: body(*a) * int(body(*a).sum().item() != 0)

    monkeypatch.setattr(module, name, planted)
    if where == "gather":
        idx, qs, _, kw = _card_index(cuda_device, "single")
        with pytest.raises(RuntimeError):
            idx.query_async(qs[0], **kw)
        assert len(idx._graphs) == 0
    else:
        step = _sweep_steps(cuda_device)["gather"][0]
        with pytest.raises(RuntimeError):
            step(3)
    torch.cuda.synchronize()
