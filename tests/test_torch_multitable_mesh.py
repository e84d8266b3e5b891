"""Port parity of the table-sharded ensemble (``MultiTableIndexer(mesh=)``).

The same seeded numpy corpus (1,021 x 8) and the same 8 tables' params
go through the JAX package's ``MultiTableIndexer`` over a ``"table"``
mesh of D of the conftest's virtual CPU devices (Pallas engines in
interpret mode) and through the port's over ``make_mesh(D, "table",
platform="cpu")``, with flip probes.  Held to: candidates equal query
by query (summed occupancies on the kernel engines, the psum of each
entry's distinct count on the gather engine); ids equal on >= 0.99 of
the slots (int8: >= 0.98) and equal to the unsharded ensemble's;
``exact_query_size``, ``calibrate`` and the stacked layouts bitwise;
``save``/``load(mesh=)`` across the two packages; the host-built stack
and the lazy corpus as the JAX package's (reached there by its row
threshold, here by ``layout_mode="host"``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.models.encoders import MLPEncoder
from nlsh_tpu.models.hashings import MultivariateBernoulli
from nlsh_tpu.parallel import MultiTableIndexer as JMT
from nlsh_tpu.parallel import make_mesh as j_make_mesh
from nlsh_tpu.parallel.multitable import init_multi_table
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.parallel import MultiTableIndexer, make_mesh
from nlsh_tpu_torch.utils.checkpoint import stacked_params_from_jax
from torch_sharded_common import CORPUS, DIM, N, QUERIES

L, BITS, K, PROBES = 8, 5, 5, 2
J_ENGINE = {"grouped": "pallas-grouped", "windowed": "pallas-windowed",
            "fixed": "pallas", "gather": "xla"}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}


@pytest.fixture(scope="module")
def ens():
    jh = MultivariateBernoulli(MLPEncoder(DIM, (16,)), BITS)
    stacked = init_multi_table(jh, L, jax.random.PRNGKey(3))
    hashings = stacked_params_from_jax(
        lambda: get_hashing("MultivariateBernoulli",
                            get_encoder("mlp", DIM, [16]), BITS),
        jax.tree.map(np.asarray, stacked))
    return jh, stacked, hashings


def _jmt(ens, engine, n_dev=None, dtype="f32", corpus=CORPUS, **kw):
    jh, stacked, _ = ens
    mesh = None if n_dev is None else j_make_mesh(n_dev, axis="table")
    return JMT(jh, stacked, jnp.asarray(corpus), mesh=mesh,
               engine=J_ENGINE[engine], serving_dtype=DTYPES[dtype][1], **kw)


def _tmt(ens, engine, n_dev=None, dtype="f32", corpus=CORPUS, **kw):
    where = dict(device="cpu") if n_dev is None else \
        dict(mesh=make_mesh(n_dev, "table", platform="cpu"))
    return MultiTableIndexer(ens[2], corpus, engine=engine,
                             serving_dtype=DTYPES[dtype][0], **where, **kw)


_ANSWERS = {}


def _janswer(ens, engine, n_dev=None, dtype="f32", **kw):
    """The JAX package's answer of a configuration, computed once."""
    key = (engine, n_dev, dtype, tuple(sorted(kw.items())))
    if key not in _ANSWERS:
        _ANSWERS[key] = _q(_jmt(ens, engine, n_dev, dtype, **kw),
                           jax_side=True)
    return _ANSWERS[key]


def _q(idx, jax_side=False):
    q = jnp.asarray(QUERIES) if jax_side else QUERIES
    ids, cand = idx.query(q, k=K, hash_times=PROBES, probe_mode="flip")
    return np.asarray(ids), np.asarray(cand)


def _same(got, want, min_agree=0.99):
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == want[0].shape and (got[0] < N).all()
    assert (got[0] == want[0]).mean() >= min_agree


@pytest.mark.parametrize("n_dev,engine", [
    (2, "windowed"), (8, "windowed"), (4, "grouped"), (8, "fixed"),
    (2, "gather"), (4, "gather")])
def test_table_sharded_engines_match_jax(ens, n_dev, engine):
    t = _tmt(ens, engine, n_dev)
    got = _q(t)
    _same(got, _janswer(ens, engine, n_dev))
    # the merged ids are the unsharded ensemble's; the kernel engines'
    # summed occupancy does not depend on the sharding
    plain = _q(_tmt(ens, engine))
    assert (got[0] == plain[0]).mean() >= 0.99
    if engine == "gather":
        assert (got[1] >= plain[1]).all()  # psum of distinct: an upper bound
    else:
        np.testing.assert_array_equal(got[1], plain[1])
        assert len(t._entry_layouts()) == n_dev


@pytest.mark.parametrize("n_dev,engine,dtype,scale", [
    (4, "grouped", "bf16", "per_row"), (2, "windowed", "int8", "per_row"),
    (4, "fixed", "int8", "global")])
def test_table_sharded_dtypes_match_jax(ens, n_dev, engine, dtype, scale):
    kw = dict(dtype=dtype, int8_scale=scale)
    _same(_q(_tmt(ens, engine, n_dev, **kw)),
          _janswer(ens, engine, n_dev, dtype, int8_scale=scale),
          0.98 if dtype == "int8" else 0.99)


def test_exact_query_size_and_calibrate_on_a_mesh(ens):
    """On a mesh both behave as the JAX methods do: the exact distinct
    count over every table, and the windowed group count of the flat
    layout of all L tables (which a table-sharded serve does not use)."""
    j = _jmt(ens, "windowed", 4)
    t = _tmt(ens, "windowed", 4)
    q = jnp.asarray(QUERIES)
    np.testing.assert_array_equal(
        t.exact_query_size(QUERIES, hash_times=PROBES, probe_mode="flip"),
        np.asarray(j.exact_query_size(q, hash_times=PROBES,
                                      probe_mode="flip")))
    g = t.calibrate(QUERIES, hash_times=PROBES, probe_mode="flip")
    assert g == j.calibrate(q, hash_times=PROBES, probe_mode="flip")
    assert g == _tmt(ens, "windowed").calibrate(QUERIES, hash_times=PROBES,
                                                probe_mode="flip")
    before = _q(t)
    assert t._g_cal == g
    _same(before, _q(_tmt(ens, "windowed", 4)), 1.0)


def test_stacked_layouts_per_entry_are_the_unsharded_stack(ens):
    """Entry d's flat layout is rows ``[d * lc * n_aligned, ...)`` of the
    unsharded flat layout, bitwise (grouped, f32)."""
    whole = _tmt(ens, "grouped")._serving_layout()
    t = _tmt(ens, "grouped", 4)
    n = whole.n_rows // L
    for d, lay in enumerate(t._entry_layouts()):
        sl = slice(d * 2 * n, (d + 1) * 2 * n)
        assert torch.equal(lay.data, whole.data[sl])
        assert torch.equal(lay.row_map, whole.row_map[sl])
        assert torch.equal(lay.starts + d * 2 * n,
                           whole.starts.view(L, -1)[2 * d:2 * d + 2]
                           .reshape(-1))
    with pytest.raises(ValueError, match="per entry"):
        t._serving_layout()
    with pytest.raises(ValueError, match="not divisible"):
        _tmt(ens, "grouped", 3)


def test_save_load_with_a_mesh_both_directions(ens, tmp_path):
    jh, stacked, hashings = ens
    t = _tmt(ens, "windowed", 2)
    t.save(str(tmp_path / "t.npz"))
    back = JMT.load(str(tmp_path / "t.npz"), jh, stacked, jnp.asarray(CORPUS),
                    mesh=j_make_mesh(2, axis="table"))
    assert back.engine == "pallas-windowed"
    for name in ("row_ids", "starts", "counts"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(t, name).numpy())
    _same(_q(t), _janswer(ens, "windowed", 2))
    j = _jmt(ens, "grouped", 4)
    j.save(str(tmp_path / "j.npz"))
    mine = MultiTableIndexer.load(str(tmp_path / "j.npz"), hashings, CORPUS,
                                  mesh=make_mesh(4, "table", platform="cpu"))
    assert mine.engine == "grouped" and mine.mesh.global_size() == 4
    np.testing.assert_array_equal(mine.row_ids.numpy(), np.asarray(j.row_ids))
    _same(_q(mine), _janswer(ens, "grouped", 4))
    with pytest.raises(ValueError, match="not divisible"):
        MultiTableIndexer.load(str(tmp_path / "j.npz"), hashings, CORPUS,
                               mesh=make_mesh(3, "table", platform="cpu"))


@pytest.mark.parametrize("n_dev", [None, 2])
def test_host_stack_and_lazy_corpus_match_jax(ens, n_dev, monkeypatch):
    """``layout_mode="host"``: the corpus stays in numpy (tables hashed a
    chunk at a time), the stacked layouts are built on the host, bitwise
    the JAX package's host-built stack (a dyadic corpus makes every norm
    exact), and the answers are its; the gather engine uploads the
    corpus on use."""
    corpus = np.round(CORPUS * 8) / 8
    jh, stacked, hashings = ens
    monkeypatch.setattr(JMT, "HOST_LAYOUT_ROWS", N // 2)
    mesh = None if n_dev is None else j_make_mesh(n_dev, axis="table")
    j = JMT(jh, stacked, corpus, mesh=mesh, engine="pallas-windowed",
            metric="euclidean")
    t = _tmt(ens, "windowed", n_dev, corpus=corpus, metric="euclidean",
             layout_mode="host")
    assert t.corpus is None and isinstance(j.corpus, np.ndarray)
    np.testing.assert_array_equal(t.row_ids.numpy(), np.asarray(j.row_ids))
    data, row_map, astarts, norms = (np.asarray(a) for a in
                                     j._build_stacked()[:4])
    lc = L if n_dev is None else L // n_dev
    n = data.reshape(L, -1, data.shape[-1]).shape[1]
    for d, lay in enumerate(t._entry_layouts()):
        rows = slice(d * lc * n, (d + 1) * lc * n)
        np.testing.assert_array_equal(
            lay.data.numpy(), data.reshape(L * n, -1)[rows])
        np.testing.assert_array_equal(lay.row_map.numpy(),
                                      row_map.reshape(-1)[rows])
        np.testing.assert_array_equal(lay.norms.numpy(),
                                      norms.reshape(-1)[rows])
    assert t.corpus is None
    _same(_q(t), _q(j, jax_side=True))
    t.engine = "gather"
    _, cand = _q(t)
    assert t.corpus is not None
    exact = t.exact_query_size(QUERIES, hash_times=PROBES, probe_mode="flip")
    if n_dev is None:
        np.testing.assert_array_equal(cand, exact)
    else:  # the psum of each entry's distinct count
        assert (cand >= exact).all() and (cand > exact).any()
