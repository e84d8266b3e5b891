"""Port parity of BASELINE's configurations 1 and 2 at a small size.

``nlsh_tpu_torch.data.configs``' table against what
``benchmarks/configs.py``'s ``config_1`` and ``config_2`` run (their
``_data``, head, ``_train`` and serve arguments, recorded with the work
stubbed out), and its ``config_data`` against ``_data`` (no cache, no
real dataset): the synthetic stand-ins' arrays bitwise, their ground
truth and self-kNN ids equal wherever the two distances of a slot
differ by more than f32 rounding (1e-5 in float64: each package ranks
in f32, so a near-tie may swap).  Then the two
configurations' heads (config 1: ``TwoLayer256Relu(25)`` with 8 bits,
cosine; config 2: SIREN 128->256->256 with 12 bits, euclidean) from
JAX-initialised params: hard codes bitwise, and the port's plain grouped
serve at the configuration's flip probes against the JAX
``Indexer(engine="xla")`` at full f32 matmul precision: candidates equal
per query, ids agree on >= 0.999 (per-query overlap of the top-10 sets;
f32 summation order may swap a near-tie at the 10th place)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.configs as bconfigs
import nlsh_tpu.index
import nlsh_tpu.models as jmodels
import nlsh_tpu.ops.knn
import nlsh_tpu_torch.models as tmodels
from benchmarks.configs import _data
from nlsh_tpu.index.indexer import Indexer as JIndexer
from nlsh_tpu_torch.data import config_data
from nlsh_tpu_torch.data.configs import CONFIGS, config_encoder
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.utils.checkpoint import params_from_jax

N_TRAIN, N_TEST = 4096, 200
_ENV = ("NLSH_PROCESSED_GLOVE_25_PATH", "NLSH_PROCESSED_GLOVE_100_PATH",
        "NLSH_PROCESSED_SIFT_PATH", "NLSH_CONFIG2_BITS", "NLSH_CONFIG2_BL",
        "NLSH_CONFIG2_PROBES")


def _shape(name):
    """(data id, dim, metric) of the configuration."""
    data_id, _, _, dim, metric = CONFIGS[name]["data"]
    return data_id, dim, metric


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_table_is_what_benchmarks_configs_runs(monkeypatch, name):
    """``config_1`` / ``config_2`` with ``_data``, ``self_knn``,
    ``_train``, ``Indexer`` and ``_measure`` stubbed: the arguments they
    pass are the table's, and the table's trunk has their head's params."""
    cfg = CONFIGS[name]
    seen = {}
    data_id, n_train, n_test, dim, metric = cfg["data"]
    n_rows = cfg["subset"] or 64

    class _Data:
        training = np.zeros((n_rows, dim), np.float32)
        testing = np.zeros((8, dim), np.float32)
        ground_truth = np.zeros((8, 20), np.int32)

    _Data.dim, _Data.metric = dim, metric

    def _train(hashing, data, steps, **kw):
        seen.update(hashing=hashing, steps=steps, rows=data.training.shape[0],
                    **kw)
        return types.SimpleNamespace(params={"hashing": None}), 0.0

    class _Indexer:
        def __init__(self, hashing, params, corpus, **kw):
            seen["index"] = kw

        def query_async(self, q, **kw):
            seen["serve"] = kw

    def _measure(idx, fn, queries, gt):
        fn(queries)
        raise _Stop

    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(bconfigs, "_data",
                        lambda *a: seen.update(data=a) or _Data())
    monkeypatch.setattr(bconfigs, "_train", _train)
    monkeypatch.setattr(bconfigs, "_measure", _measure)
    monkeypatch.setattr(nlsh_tpu.index, "Indexer", _Indexer)
    monkeypatch.setattr(nlsh_tpu.ops.knn, "self_knn",
                        lambda x, k, metric: np.zeros((len(x), k), np.int32))
    with pytest.raises(_Stop):
        getattr(bconfigs, f"config_{name}")()

    assert seen["data"] == cfg["data"]
    assert seen["steps"] == cfg["steps"]
    assert seen["rows"] == n_rows
    assert seen.get("batch_size", 1024) == cfg["batch_size"]
    assert seen.get("balance_lambda", 0.0) == cfg["balance_lambda"]
    assert seen.get("hash_times", 10) == cfg["train_hash_times"]
    assert seen["serve"]["hash_times"] == cfg["hash_times"]
    assert seen["serve"].get("probe_mode", "sample") == cfg["probe_mode"]
    assert seen["index"]["metric"] == metric
    hashing = seen["hashing"]
    assert type(hashing) is jmodels.MultivariateBernoulli
    assert hashing.hash_size == cfg["bits"]
    want = jmodels.MultivariateBernoulli(config_encoder(jmodels, cfg, dim),
                                         cfg["bits"])
    key = jax.random.PRNGKey(3)
    a, b = hashing.init(key), want.init(key)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def both_data():
    """Each configuration's data from both packages, uncached."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NLSH_SYNTH_CACHE_DIR", "")
        for name in _ENV:
            mp.delenv(name, raising=False)
        out = {}
        for name in CONFIGS:
            data_id, dim, metric = _shape(name)
            args = (data_id, N_TRAIN, N_TEST, dim, metric)
            out[name] = (_data(*args), config_data(*args, device="cpu"))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_data_matches_jax(both_data, name):
    want, got = both_data[name]
    _, dim, metric = _shape(name)
    assert got.metric == want.metric == metric and got.dim == dim
    for field in ("training", "testing"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert got.training.shape == (N_TRAIN, dim)
    assert got.ground_truth.shape == (N_TEST, 20)
    _equal_off_near_ties(got.testing, got.training, got.ground_truth,
                         np.asarray(want.ground_truth), metric)
    _equal_off_near_ties(got.training, got.training, got.training_self_knn,
                         np.asarray(want.training_self_knn), metric)


def _equal_off_near_ties(queries, corpus, got, want, metric, tol=1e-5):
    """kNN ids equal, but where the float64 distances of the two ids in a
    slot are within ``tol`` (then neither package is wrong)."""
    assert got.shape == want.shape
    diff = np.argwhere(got != want)
    assert len(diff) <= 0.001 * got.size
    q = queries[diff[:, 0]].astype(np.float64)
    a = corpus[got[tuple(diff.T)]].astype(np.float64)
    b = corpus[want[tuple(diff.T)]].astype(np.float64)
    if metric == "cosine":
        da, db = (1 - np.sum(q * x, 1) / np.linalg.norm(q, axis=1)
                  / np.linalg.norm(x, axis=1) for x in (a, b))
    else:
        da, db = (np.linalg.norm(q - x, axis=1) for x in (a, b))
    assert np.all(np.abs(da - db) <= tol)


def _heads(name):
    """The configuration's head in both packages, from JAX's init."""
    cfg, (_, dim, _) = CONFIGS[name], _shape(name)
    jh, th = (m.MultivariateBernoulli(config_encoder(m, cfg, dim), cfg["bits"])
              for m in (jmodels, tmodels))
    params = jh.init(jax.random.PRNGKey(int(name)))
    params_from_jax(th, jax.tree.map(np.asarray, params))
    return jh, params, th


def _set_agreement(a, b) -> float:
    return float(np.mean([len(set(x[x >= 0]) & set(y[y >= 0]))
                          / max((x >= 0).sum(), 1) for x, y in zip(a, b)]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_head_and_serve_match_jax(both_data, name):
    _, data = both_data[name]
    _, _, metric = _shape(name)
    probes = CONFIGS[name]["hash_times"]
    jh, params, th = _heads(name)
    with torch.no_grad():
        codes = th.hash_hard(torch.from_numpy(data.training)).numpy()
    np.testing.assert_array_equal(
        codes, np.asarray(jh.hash_hard(params, jnp.asarray(data.training))))

    ti = Indexer(th, data.training, device="cpu", metric=metric,
                 engine="grouped", serving_dtype=torch.float32)
    t_ids, t_cand = ti.query(data.testing, k=10, hash_times=probes,
                             probe_mode="flip")
    with jax.default_matmul_precision("float32"):
        ji = JIndexer(jh, params, jnp.asarray(data.training), metric=metric,
                      engine="xla")
        j_ids, j_cand = ji.query(jnp.asarray(data.testing), k=10,
                                 hash_times=probes, probe_mode="flip")
    np.testing.assert_array_equal(ti.table.row_ids.numpy(),
                                  np.asarray(ji.table.row_ids))
    np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
    assert t_cand.min() > 0
    assert _set_agreement(t_ids, np.asarray(j_ids)) >= 0.999

