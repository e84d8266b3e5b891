"""Port parity of the one-dispatch single-table serve.

``_fused_serve`` and ``_fused_serve_batched`` of the port (plain kernels
on the CPU, where the body runs eagerly) against the JAX package's
(Pallas in interpret mode, as ``tests/test_serving.py`` runs it) on the
same numpy inputs and the same params, bitwise at flip probes: the
grouped, windowed and fixed-cap engines on an f32 layout (cosine; the
per-row int8 layout is ``tests/test_torch_fused_int8.py``), the batched
serve of a rolled set and of a fresh-query pool.  Then the
``Indexer`` through the fused serve against its eager ``plain=True``
serve, with a fresh-row buffer and with tombstones, sampled probes
included.

The ``cuda``-marked tests run the captured graphs on the card: a replay
against the eager body bitwise, a second batch reusing the graph, the
cache dropped with the layout, launch counts per replay, the cache's
bound, and a host sync inside the body making the capture raise.  Run
them there with ``python -m pytest -q -m cuda tests/test_torch_fused.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.index.indexer import _fused_serve_batched as j_fused_batched
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.index.indexer import (
    _fused_serve,
    _fused_serve_batched,
    _serve_body,
    repeat_generator,
)
from nlsh_tpu_torch.models import (
    Categorical,
    MLPEncoder,
    MultivariateBernoulli,
    ProductQuantization,
)
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.utils.graphs import MAX_GRAPHS, GraphCache
from torch_fused_common import (
    DIM,
    K,
    P,
    _pair,
    check_fused_serve_matches_jax,
)

@pytest.mark.parametrize("engine", ["grouped", "windowed", "fixed"])
def test_fused_serve_matches_jax_bitwise(engine):
    check_fused_serve_matches_jax(engine, int8=False)


@pytest.mark.parametrize("pool", [False, True], ids=["roll", "pool"])
def test_fused_serve_batched_matches_jax(pool):
    """``repeats`` batches in one serve: bitwise the JAX package's, and
    each repeat equal to a standalone ``_fused_serve`` of its batch (the
    set rolled by ``i * 1009`` rows, or the pool's ``i``-th batch)."""
    queries, (jh, params, ji), ti = _pair("fixed", False, seed=4)
    R = 3
    qs = np.stack([queries[::-1], queries, queries * 0.5]) if pool \
        else queries
    want = np.asarray(j_fused_batched(
        jh, params, ji.layout, ji.table.counts, jnp.asarray(qs),
        jax.random.PRNGKey(0), k=K, hash_times=P, probe_mode="flip",
        grouped="fixed", repeats=R))
    args = (ti.hashing, ti.layout, ti.table.counts)
    kw = dict(k=K, hash_times=P, probe_mode="flip", grouped="fixed")
    got = _fused_serve_batched(*args, torch.from_numpy(qs), repeats=R, **kw)
    assert got.shape == (R, queries.shape[0], K + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(R):
        batch = qs[i] if pool else np.roll(queries, i * 1009, axis=0)
        np.testing.assert_array_equal(
            got[i].numpy(),
            _fused_serve(*args, torch.from_numpy(batch), **kw).numpy())
    assert not np.array_equal(want[0], want[1])
    with pytest.raises(ValueError, match="fresh-query pool"):
        _fused_serve_batched(*args, torch.from_numpy(np.stack([queries] * 2)),
                             repeats=R, **kw)


def test_batched_sampled_probes_follow_the_repeat_generators():
    """Sampled probes: repeat ``i`` equals a standalone serve with
    ``repeat_generator(generator, i)``, whose seed comes from the host
    (the counterpart of ``fold_in(key, i)``); a sampled serve needs a
    generator."""
    queries, _, ti = _pair("grouped", False, seed=5)
    q = torch.from_numpy(queries)
    args = (ti.hashing, ti.layout, ti.table.counts)
    kw = dict(k=K, hash_times=6, probe_mode="sample", grouped="grouped")
    gen = torch.Generator().manual_seed(11)
    got = _fused_serve_batched(*args, q, gen, repeats=3, **kw)
    seeds = set()
    for i in range(3):
        g_i = repeat_generator(gen, i)
        seeds.add(g_i.initial_seed())
        np.testing.assert_array_equal(
            got[i].numpy(), _fused_serve(*args, torch.roll(q, i * 1009, 0),
                                         g_i, **kw).numpy())
    assert len(seeds) == 3 and gen.initial_seed() not in seeds
    assert repeat_generator(None, 0) is None
    with pytest.raises(ValueError, match="generator"):
        _fused_serve(*args, q, **kw)


@pytest.mark.parametrize("engine", ["grouped", "windowed", "fixed"])
def test_indexer_fused_path_matches_its_eager_serve(engine):
    """``Indexer.query`` through the fused serve against ``plain=True``
    (the eager path): flip and default-seeded sampled probes, then with
    a fresh-row buffer (merged after the fused serve) and with
    tombstones (the over-fetched ``k + 64`` is a new graph key; the drop
    follows the serve).  ``query_async`` returns the packed tensor (and so
    do ``plain=True`` and the gather engine); ``fetch`` takes it."""
    queries, _, ti = _pair(engine, False, seed=6)
    extra = queries[:20] + np.float32(1 / 64)  # nearer than any corpus row

    def both(**kw):
        got = ti.query(queries, k=K, **kw)
        want = ti.query(queries, k=K, plain=True, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return got

    both(hash_times=P)
    base = both(hash_times=P, probe_mode="flip")
    packed = ti.query_async(queries, k=K, hash_times=P, probe_mode="flip")
    assert torch.is_tensor(packed) and packed.shape == (len(queries), K + 1)
    plain = ti.query_async(queries, k=K, hash_times=P, probe_mode="flip",
                           plain=True)
    assert torch.equal(plain, packed)
    ti.add(extra)
    ids, cand = both(hash_times=P, probe_mode="flip")
    assert (ids >= ti.corpus.shape[0]).any()
    np.testing.assert_array_equal(cand, base[1] + len(extra))
    ti.remove(np.unique(ids[:, 0][ids[:, 0] >= 0])[:30])
    ids, _ = both(hash_times=P, probe_mode="flip")
    assert not np.isin(ids, ti._deleted).any()
    assert len(ti._graphs) == 0  # CPU tensors run the body eagerly
    ti.engine = "gather"
    res = ti.query_async(queries, k=K, hash_times=P, probe_mode="flip")
    assert torch.is_tensor(res) and res.shape == (len(queries), K + 1)
    assert (Indexer.fetch(res)[0] == ids).mean() >= 0.98


def test_graph_cache_runs_cpu_inputs_eagerly():
    cache = GraphCache()
    x = torch.arange(6.0)
    assert torch.equal(cache.run("k", lambda a, b: a * 2, (x, None)), x * 2)
    assert len(cache) == 0 and cache.pool_bytes() == []


@pytest.mark.parametrize("head", ["mvb", "pq", "categorical"])
def test_heads_take_their_uniforms_from_outside(head):
    """``probe_uniforms`` is the draw ``hash`` makes from a generator, so
    a graph can take it as a static input: ``hash(uniforms=)`` gives the
    same ids; nothing is drawn for flip probes, one probe or a
    deterministic head."""
    torch.manual_seed(0)
    enc = MLPEncoder(DIM, (32,))
    h = {"mvb": lambda: MultivariateBernoulli(enc, 6),
         "pq": lambda: ProductQuantization(enc, 3, 2),
         "categorical": lambda: Categorical(enc, 12)}[head]()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(9, DIM)).astype(np.float32))
    u = h.probe_uniforms(9, 5, torch.Generator().manual_seed(3))
    assert h.probe_uniforms(9, 1, None) is None
    assert h.probe_uniforms(9, 5, None, probe_mode="flip") is None
    want = h.hash(x, 5, torch.Generator().manual_seed(3))
    got = h.hash(x, 5, uniforms=u)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if head == "categorical":
        assert u is None
    else:
        assert u.shape == (9, 4, h.sample_width)


def test_sync_free_prep_helpers_match_torch():
    """The prep's histogram and repeat, written without a host read,
    equal ``bincount`` and ``repeat_interleave``."""
    key = torch.from_numpy(np.random.default_rng(3).integers(0, 9, 200))
    assert torch.equal(qk._histogram(key, 9), torch.bincount(key, minlength=9))
    t = torch.arange(7, dtype=torch.int32)
    assert torch.equal(qk._repeat_each(t, 3), t.repeat_interleave(3))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_index(device, engine: str, dtype=torch.float32, seed: int = 12):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(20000, 32)).astype(np.float32)
    queries = rng.normal(size=(2, 300, 32)).astype(np.float32)
    torch.manual_seed(seed)
    hashing = MultivariateBernoulli(MLPEncoder(32, (64,)), 7)
    idx = Indexer(hashing, corpus, device=device, metric="cosine",
                  engine=engine, serving_dtype=dtype)
    return idx, torch.from_numpy(queries).to(device)


_KERNEL = {"grouped": "grouped_scores_topk",
           "windowed": "windowed_scores_topk", "fixed": "bucket_scores_auto"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("engine", ["grouped", "windowed", "fixed"])
def test_replay_equals_the_eager_body(cuda_device, engine, dtype):
    """A replay gives the eager body's ids and candidates bit for bit; a
    second batch of new queries reuses the graph and gives its own eager
    answer; each replay counts its kernel's launches."""
    idx, qs = _card_index(cuda_device, engine, dtype)
    kw = dict(k=10, hash_times=8, probe_mode="flip")
    body = _serve_body(idx.hashing, idx.layout, idx.table.counts,
                       grouped=engine, **kw)
    for i, q in enumerate(qs):
        packed = idx.query_async(q, **kw)
        assert len(idx._graphs) == 1
        with torch.no_grad():
            eager = body(q, None)
        assert torch.equal(packed, eager)
        before = qk.KERNEL_LAUNCHES[_KERNEL[engine]]
        again = idx.query_async(q, **kw)
        assert qk.KERNEL_LAUNCHES[_KERNEL[engine]] > before
        assert torch.equal(again, packed)
    assert not torch.equal(idx.query_async(qs[0], **kw),
                           idx.query_async(qs[1], **kw))
    assert all(b > 0 for b in idx._graphs.pool_bytes())


@pytest.mark.cuda
def test_sampled_replay_equals_the_eager_path(cuda_device):
    """Sampled probes through the graph: the default seed-0 generator's
    uniforms drawn before the replay give the eager path's ids."""
    idx, qs = _card_index(cuda_device, "grouped")
    got = idx.query(qs[0], k=10, hash_times=8)
    body = _serve_body(idx.hashing, idx.layout, idx.table.counts, k=10,
                       hash_times=8, probe_mode="sample", grouped="grouped")
    u = idx.hashing.probe_uniforms(
        300, 8, torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    with torch.no_grad():
        want = body(qs[0], u).cpu().numpy()
    np.testing.assert_array_equal(got[0], want[:, :-1])
    np.testing.assert_array_equal(got[1], want[:, -1])


@pytest.mark.cuda
def test_replacing_the_layout_drops_its_graphs(cuda_device):
    idx, qs = _card_index(cuda_device, "grouped")
    kw = dict(k=10, hash_times=8, probe_mode="flip")
    idx.query(qs[0], **kw)
    idx.query(qs[0], k=20, hash_times=8, probe_mode="flip")
    assert len(idx._graphs) == 2
    idx.serving_dtype = torch.bfloat16
    idx.query(qs[0], **kw)
    assert len(idx._graphs) == 1
    idx.add(qs[1, :5].cpu().numpy())
    idx.query(qs[0], **kw)
    assert len(idx._graphs) == 1  # an insert captures nothing new
    idx.compact()
    assert len(idx._graphs) == 0
    ids, _ = idx.query(qs[0], **kw)
    assert len(idx._graphs) == 1 and ids.shape == (300, 10)


@pytest.mark.cuda
def test_the_cache_keeps_the_most_recently_used_graphs(cuda_device):
    """Past ``MAX_GRAPHS`` query shapes the least recently used graph goes
    (and its pool with it); a shape met again is captured again."""
    cache = GraphCache()
    xs = [torch.arange(float(n), device=cuda_device)
          for n in range(1, MAX_GRAPHS + 3)]
    for x in xs:
        assert torch.equal(cache.run("double", lambda a: a * 2, (x,)), x * 2)
    assert len(cache) == MAX_GRAPHS
    cache.run("double", lambda a: a * 2, (xs[-1],))
    assert torch.equal(cache.run("double", lambda a: a * 2, (xs[0],)),
                       xs[0] * 2)
    assert len(cache) == MAX_GRAPHS


@pytest.mark.cuda
def test_a_host_sync_in_the_body_fails_the_capture(cuda_device):
    """The capture is the check that a path reads nothing on the host: a
    ``.item()`` inside the body raises, and nothing is cached."""
    cache = GraphCache()
    x = torch.arange(8.0, device=cuda_device)
    with pytest.raises(RuntimeError):
        cache.run("sync", lambda a: a * float(a.sum().item()), (x,))
    assert len(cache) == 0
    torch.cuda.synchronize()
    assert torch.equal(cache.run("ok", lambda a: a + 1, (x,)), x + 1)


def _window_keys(rng, n: int, device):
    """Sorted window keys the size of the ensemble's sub-events: runs of
    1-40 equal windows, then the dead sub-events' ``2**30`` run."""
    lengths = rng.integers(1, 41, n // 10)
    keys = np.repeat(np.arange(lengths.size) * 3, lengths)[: n - n // 8]
    keys = np.concatenate([keys, np.full(n - keys.size, 2 ** 30)])
    return torch.from_numpy(keys.astype(np.int64)).to(device)


@pytest.mark.cuda
def test_captured_run_ranks_equal_the_scan(cuda_device):
    """``_run_ranks`` captured in a graph (the capture fails on any host
    read) and replayed on new keys of ~1M: the mask and ranks of the
    eager scan, bit for bit."""
    rng = np.random.default_rng(23)
    n = 960_000
    cache = GraphCache()
    for _ in range(2):
        sk = _window_keys(rng, n, cuda_device)
        unique, rank = cache.run("ranks", qk._run_ranks, (sk,))
        pos = torch.arange(n, device=cuda_device)
        want_unique = torch.ones_like(sk, dtype=torch.bool)
        want_unique[1:] = sk[1:] != sk[:-1]
        first = torch.cummax(torch.where(want_unique, pos, -1), 0).values
        assert torch.equal(unique, want_unique)
        assert torch.equal(rank, pos - first)
    assert cache.captures == 1 and cache.replays == 2
