"""Port parity of the corpus-sharded index (``ShardedIndexer``), part 2:
bf16 and int8 layouts (per-row and global scale), the host-built
layouts, the lazy corpus, and the reference's fault F1.

The fixture and the comparisons are part 1's
(``tests/torch_sharded_common.py``).  int8 ids, whose quantised scores
tie often and are summed in another order by the two packages' scorers,
agree on >= 0.98 of the slots; candidates are equal everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.parallel import ShardedIndexer as JSharded
from nlsh_tpu.parallel import make_mesh as j_make_mesh
from nlsh_tpu_torch.parallel import ShardedIndexer, make_mesh
from torch_sharded_common import (
    CORPUS,
    K,
    N,
    PROBES,
    QUERIES,
    assert_same_answers,
    jax_index,
    jquery,
    make_heads,
    port_index,
    tquery,
)


@pytest.fixture(scope="module")
def heads():
    return make_heads()


@pytest.mark.parametrize("n_dev,engine,dtype,scale", [
    (2, "grouped", "bf16", "per_row"), (8, "windowed", "bf16", "per_row"),
    (4, "grouped", "int8", "per_row"), (2, "windowed", "int8", "global"),
    (8, "fixed", "int8", "per_row"), (4, "fixed", "int8", "global")])
def test_layout_dtypes_match_jax(heads, n_dev, engine, dtype, scale):
    kw = dict(dtype=dtype, int8_scale=scale)
    got = tquery(port_index(heads, n_dev, engine, **kw))
    want = jax_index(heads, n_dev, engine, **kw)[1]
    if dtype == "int8":
        assert_same_answers(got, want, min_agree=0.98, ties=False)
    else:
        assert_same_answers(got, want)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_host_layouts_match_jax_s_host_path(heads, n_dev):
    """``layout_mode="host"``: the numpy layouts equal the JAX package's
    host-built ones bitwise (a dyadic corpus makes every norm exact),
    serve as the device-built ones do, and on one entry the corpus never
    goes to the device (the lazy corpus) until the gather engine needs
    it."""
    corpus = np.round(CORPUS * 8) / 8
    jh, params, th = heads
    mesh = make_mesh(n_dev, "shard", platform="cpu")
    t = ShardedIndexer(th, corpus, mesh, engine="grouped", layout_mode="host")
    j = JSharded(jh, params, corpus, j_make_mesh(n_dev, axis="shard"),
                 engine="pallas-grouped", layout_mode="host")
    assert (t._corpus_local is None) == (n_dev == 1)
    j_data, j_map, j_starts = (np.asarray(a) for a in j._build_layouts()[:3])
    for s, lay in enumerate(t._build_layouts()):
        np.testing.assert_array_equal(lay.data.numpy(), j_data[s])
        np.testing.assert_array_equal(lay.row_map.numpy(), j_map[s])
        np.testing.assert_array_equal(lay.starts.numpy(), j_starts[s])
    got = tquery(t)
    j_ids, j_cand = j.query(jnp.asarray(QUERIES), k=K, hash_times=PROBES,
                            probe_mode="flip")
    np.testing.assert_array_equal(got[1], np.asarray(j_cand))
    assert (got[0] == np.asarray(j_ids)).mean() >= 0.99
    dev = ShardedIndexer(th, corpus, mesh, engine="grouped")
    d_ids, d_cand = tquery(dev)
    np.testing.assert_array_equal(got[1], d_cand)
    assert (got[0] == d_ids).mean() >= 0.99
    if n_dev == 1:
        t.engine = "gather"
        _, x_cand = tquery(t)
        assert t._corpus_local is not None
        np.testing.assert_array_equal(x_cand, d_cand)


def test_lazy_corpus_matches_jax_s_lazy_path(heads, monkeypatch):
    """The JAX package's lazy path (reached there by its row threshold,
    here by ``layout_mode="host"``) against the port's, on one entry:
    the tables (hashed a chunk at a time, CSR by the native library)
    bitwise, the answers equal."""
    jh, params, th = heads
    monkeypatch.setattr(JSharded, "HOST_LAYOUT_ROWS", N // 2)
    j = JSharded(jh, params, CORPUS, j_make_mesh(1, axis="shard"),
                 engine="pallas-grouped")
    assert j.corpus is None
    t = ShardedIndexer(th, CORPUS, make_mesh(1, "shard", platform="cpu"),
                       engine="grouped", layout_mode="host")
    assert t._corpus_local is None
    np.testing.assert_array_equal(t.row_ids.numpy(), np.asarray(j.row_ids))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    assert_same_answers(tquery(t), jquery(j))


def test_euclidean_global_int8_follows_jax_s_host_path(heads):
    """F1: the JAX package's device-built sharded layout takes a global
    int8 scale over cosine-normalised rows whatever the metric; its host
    path (and the port's device path) over the metric-extended rows.
    The port's device-built layout equals the JAX host path's bitwise
    and not the JAX device path's; its ids are the JAX host path's; its
    top-5 agrees with f32 as well as that path's does (0.964 on this
    8-dim fixture: one global scale over raw euclidean rows flips
    near-ties) and far better than the JAX device path's (0.583)."""
    jh, params, th = heads
    t = port_index(heads, 4, "grouped", metric="euclidean", dtype="int8",
                   int8_scale="global")
    kw = dict(metric="euclidean", dtype="int8", int8_scale="global")
    j_host, host_answer = jax_index(heads, 4, "grouped", layout_mode="host",
                                    **kw)
    j_dev, dev_answer = jax_index(heads, 4, "grouped", layout_mode="device",
                                  **kw)
    lays = t._build_layouts()
    h, d = j_host._build_layouts(), j_dev._build_layouts()
    assert float(lays[0].scale) == np.float32(h[7])
    assert float(lays[0].scale) != np.float32(d[7])
    for s, lay in enumerate(lays):
        np.testing.assert_array_equal(lay.data.numpy(), np.asarray(h[0])[s])
        np.testing.assert_array_equal(lay.norms.numpy(), np.asarray(h[3])[s])
    assert not np.array_equal(lays[0].data.numpy(), np.asarray(d[0])[0])
    got = tquery(t)
    assert_same_answers(got, host_answer, min_agree=0.98, ties=False)
    f_ids, f_cand = tquery(port_index(heads, 4, "grouped",
                                      metric="euclidean"))
    np.testing.assert_array_equal(got[1], f_cand)

    def agree(ids):
        return np.mean([len(set(a) & set(b)) / K
                        for a, b in zip(np.asarray(ids), f_ids)])

    assert agree(got[0]) >= 0.95
    assert agree(dev_answer[0]) < 0.7
    assert t.serving_dtype == torch.int8
