"""The one-dispatch serves of a mesh of one device: ``ShardedIndexer``'s
grouped, windowed and fixed-cap serves and the table-sharded ensemble's
windowed and fixed-cap serves, each one captured CUDA graph per batch
shape on the card (the JAX package's ``_serving_query_fn`` and
``_query_serving_sharded``).

On the CPU (a graph's body runs eagerly there) over meshes of 2 and 4
CPU entries: the serve's body against the JAX package's sharded serve
over as many of the conftest's virtual devices (candidates equal query
by query; ids equal on >= 0.99 of the slots, a differing slot holding
two rows at one distance within 1e-5, as ``test_torch_sharded.py`` and
``test_torch_multitable_mesh.py`` hold them) and bit for bit against the
port's eager serve (``plain=True``, and the path of a mesh over several
devices), flip and sampled probes.

On the card (``cuda`` marker, skipped without one), over meshes that
repeat the card: each replay equals the body run eagerly bit for bit, a
second batch reuses the graph, the graphs go with the layouts they read,
and a host read in the body fails the capture.  The module imports no
JAX (the CPU tests import it inside), so the card's tests run where JAX
is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_sharded.py
"""

import numpy as np
import pytest
import torch

from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.parallel import Mesh, MultiTableIndexer, ShardedIndexer
from nlsh_tpu_torch.parallel import make_mesh
from nlsh_tpu_torch.parallel.multitable import init_multi_table

K, PROBES = 5, 4
ENGINES = ["grouped", "windowed", "fixed"]
MT_ENGINES = ["windowed", "fixed"]


def _several_devices(monkeypatch):
    """Serve as a mesh over several devices does: eagerly."""
    monkeypatch.setattr(Mesh, "on_one_device", lambda self: False)


def _equal(a, b):
    if isinstance(a, tuple):
        a = torch.cat([a[0], a[1][:, None].to(a[0].dtype)], dim=1)
    if isinstance(b, tuple):
        b = torch.cat([b[0], b[1][:, None].to(b[0].dtype)], dim=1)
    assert a.dtype == b.dtype and torch.equal(a, b)


# -- on the CPU ---------------------------------------------------------------

@pytest.fixture(scope="module")
def heads():
    from torch_sharded_common import make_heads

    return make_heads()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_body_matches_jax_and_the_eager_serve(heads, n_dev, engine,
                                                      monkeypatch):
    from torch_sharded_common import (
        QUERIES,
        assert_same_answers,
        jax_index,
        port_index,
        tquery,
    )

    t = port_index(heads, n_dev, engine)
    assert t.mesh.on_one_device()
    got = tquery(t)
    assert_same_answers(got, jax_index(heads, n_dev, engine)[1])
    q = torch.from_numpy(QUERIES)
    for probe_mode in ("flip", "sample"):
        kw = dict(k=K, hash_times=PROBES, probe_mode=probe_mode)
        fused = t.query_async(
            q, generator=torch.Generator().manual_seed(7), **kw)
        _equal(fused, t.query_async(
            q, generator=torch.Generator().manual_seed(7), plain=True, **kw))
        with monkeypatch.context() as m:
            _several_devices(m)
            _equal(fused, t.query_async(
                q, generator=torch.Generator().manual_seed(7), **kw))
    np.testing.assert_array_equal(
        ShardedIndexer.fetch(t.query_async(q, k=K, hash_times=PROBES,
                                           probe_mode="flip"))[0], got[0])


@pytest.mark.parametrize("engine", MT_ENGINES)
@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_ensemble_body_matches_jax_and_the_eager_serve(n_dev, engine,
                                                            monkeypatch):
    import jax
    import jax.numpy as jnp

    from nlsh_tpu.models.encoders import MLPEncoder
    from nlsh_tpu.models.hashings import MultivariateBernoulli
    from nlsh_tpu.parallel import MultiTableIndexer as JMT
    from nlsh_tpu.parallel import make_mesh as j_make_mesh
    from nlsh_tpu.parallel.multitable import init_multi_table as j_init
    from nlsh_tpu_torch.utils.checkpoint import stacked_params_from_jax
    from torch_sharded_common import CORPUS, DIM, QUERIES

    bits, n_tables = 5, 4
    jh = MultivariateBernoulli(MLPEncoder(DIM, (16,)), bits)
    stacked = j_init(jh, n_tables, jax.random.PRNGKey(3))
    hashings = stacked_params_from_jax(
        lambda: get_hashing("MultivariateBernoulli",
                            get_encoder("mlp", DIM, [16]), bits),
        jax.tree.map(np.asarray, stacked))
    j_engine = {"windowed": "pallas-windowed", "fixed": "pallas"}[engine]
    jmt = JMT(jh, stacked, jnp.asarray(CORPUS),
              mesh=j_make_mesh(n_dev, axis="table"), engine=j_engine)
    j_ids, j_cand = (np.asarray(a) for a in jmt.query(
        jnp.asarray(QUERIES), k=K, hash_times=2, probe_mode="flip"))
    t = MultiTableIndexer(hashings, CORPUS, engine=engine,
                          mesh=make_mesh(n_dev, "table", platform="cpu"))
    ids, cand = t.query(QUERIES, k=K, hash_times=2, probe_mode="flip")
    np.testing.assert_array_equal(cand, j_cand)
    assert ids.shape == j_ids.shape and (ids == j_ids).mean() >= 0.99
    q = torch.from_numpy(QUERIES)
    for probe_mode in ("flip", "sample"):
        kw = dict(k=K, hash_times=2, probe_mode=probe_mode)
        fused = t.query_async(
            q, generator=torch.Generator().manual_seed(7), **kw)
        assert isinstance(fused, torch.Tensor)  # packed, one graph
        _equal(fused, t.query_async(
            q, generator=torch.Generator().manual_seed(7), plain=True, **kw))
        with monkeypatch.context() as m:
            _several_devices(m)
            _equal(fused, t.query_async(
                q, generator=torch.Generator().manual_seed(7), **kw))


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
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


def _sharded(device, n_dev, engine):
    corpus, qs = _card_data()
    idx = ShardedIndexer(_card_head(), corpus, Mesh([device] * n_dev, "shard"),
                         engine=engine)
    return idx, qs.to(device)


def _ensemble(device, engine):
    corpus, qs = _card_data()
    hashings = init_multi_table(_card_head(5), 4,
                                torch.Generator().manual_seed(1))
    idx = MultiTableIndexer(hashings, corpus, engine=engine,
                            mesh=Mesh([device] * 2, "table"))
    return idx, qs.to(device)


def _body(idx, probe_mode="flip"):
    if isinstance(idx, ShardedIndexer):
        return idx._serve_body(10, PROBES, probe_mode)
    return idx._mesh_serve_body(10, PROBES, probe_mode)


_KERNEL = {"grouped": "grouped_scores_topk",
           "windowed": "windowed_scores_topk", "fixed": "bucket_scores_auto"}
_CASES = [("sharded", 1, e) for e in ENGINES] + \
    [("sharded", 4, e) for e in ENGINES] + \
    [("ensemble", 2, e) for e in MT_ENGINES]


def _index(device, kind, n_dev, engine):
    return _sharded(device, n_dev, engine) if kind == "sharded" else \
        _ensemble(device, engine)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n_dev,engine", _CASES)
def test_replay_equals_the_eager_body(cuda_device, kind, n_dev, engine):
    """Each replay gives the body's eager ids and candidates bit for bit;
    a second batch of new queries reuses the graph and gives its own
    eager answer; a replay counts its kernel's launches."""
    idx, qs = _index(cuda_device, kind, n_dev, engine)
    kw = dict(k=10, hash_times=PROBES, probe_mode="flip")
    for q in qs:
        packed = idx.query_async(q, **kw)
        assert len(idx._graphs) == 1
        with torch.no_grad():
            assert torch.equal(packed, _body(idx)(q, None))
        before = qk.KERNEL_LAUNCHES[_KERNEL[engine]]
        assert torch.equal(idx.query_async(q, **kw), packed)
        assert qk.KERNEL_LAUNCHES[_KERNEL[engine]] > before
    assert not torch.equal(idx.query_async(qs[0], **kw),
                           idx.query_async(qs[1], **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sharded", "ensemble"])
def test_sampled_replay_equals_the_eager_serve(cuda_device, kind,
                                               monkeypatch):
    """Sampled probes drawn before the replay from the caller's generator
    give the eager serve's answer (``plain=False`` off the graph: a mesh
    over several devices)."""
    idx, qs = _index(cuda_device, kind, 4 if kind == "sharded" else 2,
                     "windowed")
    kw = dict(k=10, hash_times=PROBES, probe_mode="sample")
    got = idx.query_async(
        qs[0], generator=torch.Generator(device=cuda_device).manual_seed(5),
        **kw)
    idx._graphs.clear()
    with monkeypatch.context() as m:
        _several_devices(m)
        want = idx.query_async(
            qs[0],
            generator=torch.Generator(device=cuda_device).manual_seed(5),
            **kw)
    assert len(idx._graphs) == 0
    _equal(got, want)


@pytest.mark.cuda
def test_the_graphs_go_with_their_layouts(cuda_device):
    """A new engine or dtype rebuilds the layouts and drops the graphs
    that read the old ones; the next batch captures anew."""
    kw = dict(k=10, hash_times=PROBES, probe_mode="flip")
    idx, qs = _sharded(cuda_device, 4, "grouped")
    idx.query_async(qs[0], **kw)
    assert len(idx._graphs) == 1
    idx.engine = "windowed"
    assert len(idx._graphs) == 0
    idx.query_async(qs[0], **kw)
    idx.serving_dtype = torch.bfloat16
    idx.query_async(qs[0], **kw)
    assert len(idx._graphs) == 1
    assert idx._graphs.pool_bytes()[0] > 0
    mt, qs = _ensemble(cuda_device, "windowed")
    mt.query_async(qs[0], **kw)
    assert len(mt._graphs) == 1
    mt.engine = "fixed"
    assert len(mt._graphs) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sharded", "ensemble"])
def test_a_host_read_in_the_body_fails_the_capture(cuda_device, kind,
                                                   monkeypatch):
    """A ``.item()`` planted in the serve's body raises at the capture,
    with no eager fallback, and nothing is cached."""
    idx, qs = _index(cuda_device, kind, 4 if kind == "sharded" else 2,
                     "windowed")
    name = "_serve_body" if kind == "sharded" else "_mesh_serve_body"
    original = getattr(idx, name)

    def planted(*args, **kwargs):
        body = original(*args, **kwargs)
        return lambda q, u: body(q, u) * int(body(q, u).sum().item() != 0)

    monkeypatch.setattr(idx, name, planted)
    with pytest.raises(RuntimeError):
        idx.query_async(qs[0], k=10, hash_times=PROBES, probe_mode="flip")
    assert len(idx._graphs) == 0
    torch.cuda.synchronize()
