"""Port parity of the corpus-sharded index (``ShardedIndexer``), part 1:
the engines over meshes of 2, 4 and 8 entries, an engine switch,
persistence across the two packages, the packed results and the mesh.

The same seeded numpy corpus (1,021 x 8: not a multiple of 2, 4 or 8)
and the same head's params go through the JAX package's
``nlsh_tpu.parallel.ShardedIndexer`` over D of the conftest's virtual
CPU devices (Pallas engines in interpret mode) and through the port's
over ``make_mesh(D, platform="cpu")`` (plain kernels), with flip probes
(deterministic in both packages).  Held to: CSR tables, counts and the
bucket statistics bitwise; candidates equal query by query; ids equal
on >= 0.99 of the slots, a differing slot holding two rows at one
distance (within 1e-5); and the sharded answer equal to the port's
single-table ``Indexer``.  Layout dtypes, the host layouts and the lazy
corpus are in ``test_torch_sharded_layouts.py``.
"""

import numpy as np
import pytest
import torch

from nlsh_tpu.parallel import ShardedIndexer as JSharded
from nlsh_tpu.parallel import make_mesh as j_make_mesh
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.parallel import Mesh, ShardedIndexer, make_mesh
from torch_sharded_common import (
    CORPUS,
    K,
    N,
    NQ,
    PROBES,
    QUERIES,
    assert_same_answers,
    jax_index,
    make_heads,
    port_index,
    tquery,
)


@pytest.fixture(scope="module")
def heads():
    return make_heads()


@pytest.mark.parametrize("engine", ["grouped", "windowed", "fixed", "gather"])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_engines_match_jax(heads, n_dev, engine):
    j, want = jax_index(heads, n_dev, engine)
    t = port_index(heads, n_dev, engine)
    np.testing.assert_array_equal(t.row_ids.numpy(), np.asarray(j.row_ids))
    np.testing.assert_array_equal(t.starts.numpy(), np.asarray(j.starts))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    assert t.n_local == j.n_local and t.probe_budget == j.probe_budget
    assert t.n_buckets_used() == j.n_buckets_used()
    assert t.occupancy_std() == pytest.approx(j.occupancy_std(), rel=1e-6)
    got = tquery(t)
    assert_same_answers(got, want)
    # padding rows are never answered, and the sharded answer is the
    # single table's
    single = Indexer(heads[2], CORPUS, device="cpu", engine="gather")
    assert_same_answers(got, single.query(QUERIES, k=K, hash_times=PROBES,
                                          probe_mode="flip"))


def test_engine_switch_drops_the_layouts(heads):
    t = port_index(heads, 4, "grouped")
    g = tquery(t)
    assert t._build_layouts()[0].align == 512
    t.engine = "pallas-windowed"  # either package's name
    assert t.engine == "windowed" and t._layouts is None
    w = tquery(t)
    assert t._build_layouts()[0].align == 8
    assert_same_answers(w, g)
    assert_same_answers(w, jax_index(heads, 4, "windowed")[1])
    with pytest.raises(ValueError, match="unknown engine"):
        t.engine = "dense"


def test_save_load_both_directions(heads, tmp_path):
    """An index saved by either package loads in the other and answers
    as the original; a mesh of another size and another corpus are
    refused; the archive keeps the JAX package's names."""
    jh, params, th = heads
    t = port_index(heads, 4, "fixed")
    t.save(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "t.npz") as z:
        assert list(z["meta"][[2, 6, 7]]) == ["pallas", "4", str(N)]
    back = JSharded.load(str(tmp_path / "t.npz"), jh, params, CORPUS,
                         j_make_mesh(4, axis="shard"))
    assert back.engine == "pallas"
    np.testing.assert_array_equal(np.asarray(back.row_ids),
                                  t.row_ids.numpy())
    np.testing.assert_array_equal(np.asarray(back.counts), t.counts.numpy())
    assert_same_answers(tquery(t), jax_index(heads, 4, "fixed")[1])

    j, want = jax_index(heads, 4, "windowed")
    j.save(str(tmp_path / "j.npz"))
    mesh = make_mesh(4, "shard", platform="cpu")
    mine = ShardedIndexer.load(str(tmp_path / "j.npz"), th, CORPUS, mesh)
    assert mine.engine == "windowed"
    np.testing.assert_array_equal(mine.row_ids.numpy(), np.asarray(j.row_ids))
    assert_same_answers(tquery(mine), want)
    with pytest.raises(ValueError, match="sharded 4-way"):
        ShardedIndexer.load(str(tmp_path / "j.npz"), th, CORPUS,
                            make_mesh(1, "shard", platform="cpu"))
    other = CORPUS.copy()
    other[-1] += 1.0
    with pytest.raises(ValueError, match="fingerprint"):
        ShardedIndexer.load(str(tmp_path / "j.npz"), th, other, mesh)
    with pytest.raises(ValueError, match="corpus rows"):
        ShardedIndexer.load(str(tmp_path / "j.npz"), th, CORPUS[:-1], mesh)
    # an archive from before the int8_scale field is global-scale
    with np.load(tmp_path / "j.npz") as z:
        old = {name: z[name] for name in z.files}
    old["meta"] = old["meta"][:9]
    np.savez(tmp_path / "old.npz", **old)
    assert ShardedIndexer.load(str(tmp_path / "old.npz"), th, CORPUS,
                               mesh).int8_scale == "global"


def test_packed_results_sync_bound_and_repeated_devices(heads, monkeypatch):
    """``query_async`` returns ONE packed ``[ids | n_cand]`` array; the
    opt-in exact group bound of a one-entry grouped serve changes
    nothing; a hand-built mesh that repeats one device equals
    ``make_mesh``'s."""
    t = port_index(heads, 1, "grouped")
    packed = t.query_async(QUERIES, k=K, hash_times=PROBES, probe_mode="flip")
    assert packed.shape == (NQ, K + 1) and packed.dtype == torch.int32
    ids, cand = ShardedIndexer.fetch(packed)
    monkeypatch.setenv("NLSH_SHARDED_SYNC_BOUND", "1")
    s_ids, s_cand = tquery(t)
    np.testing.assert_array_equal(s_ids, ids)
    np.testing.assert_array_equal(s_cand, cand)
    by_hand = ShardedIndexer(heads[2], CORPUS, Mesh(["cpu"] * 4, "shard"),
                             engine="windowed")
    r_ids, r_cand = tquery(by_hand)
    m_ids, m_cand = tquery(port_index(heads, 4, "windowed"))
    np.testing.assert_array_equal(r_ids, m_ids)
    np.testing.assert_array_equal(r_cand, m_cand)
    assert_same_answers((r_ids, r_cand), (ids, cand))


def test_make_mesh_raises_past_the_cards_there_are():
    """No fallback: asking for more cards than the machine has raises, as
    the JAX package's ``make_mesh`` does."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"only {n} available"):
        make_mesh(n + 1, "shard")
    mesh = make_mesh(3, "table", platform="cpu")
    assert mesh.size == mesh.global_size() == 3 and mesh.axis == "table"
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="one platform"):
        Mesh(["cpu", "meta"])
