"""Port parity of BASELINE's configurations 1, 2 and 4 and the
product-quantisation one at a small size.

``nlsh_tpu_torch.data.configs``' table against what
``benchmarks/configs.py``'s ``config_1``, ``config_2``, ``config_4`` and
``config_pq`` run (their ``_data``, head, ``_train``, index, calibration,
serve and ``exact_query_size`` arguments, recorded with the work stubbed
out), and its ``config_data`` against ``_data`` (no cache, no real
dataset): the synthetic stand-ins' arrays bitwise, their ground truth and
self-kNN ids equal wherever the two distances of a slot differ by more
than f32 rounding (1e-5 in float64: each package ranks in f32, so a
near-tie may swap).  Then each configuration's head from JAX-initialised
params carried across with ``params_from_jax`` (config 1:
``TwoLayer256Relu(25)`` with 8 bits, cosine; config 2: SIREN
128->256->256 with 12 bits, euclidean; config 4: eight tables of a
10-bit SIREN 100->128->128; pq: 3 bands of 4 bits on SIREN
100->256->256):

* configs 1 and 2: hard codes bitwise, and the port's plain grouped serve
  at the configuration's flip probes against the JAX
  ``Indexer(engine="xla")`` at full f32 matmul precision: candidates
  equal per query, ids agree on >= 0.999 (per-query overlap of the
  top-10 sets; f32 summation order may swap a near-tie at the 10th
  place);
* config 4: the eight tables' hard codes bitwise against ``vmap`` of the
  JAX ``hash_hard``, and the port's plain windowed ensemble serve at one
  probe a table, after ``calibrate`` on the first test-size corpus rows,
  against the JAX ``MultiTableIndexer(engine="xla")``: the exact distinct
  candidates (``exact_query_size``, what the xla engine counts) equal per
  query, ids >= 0.999 as above;
* pq: the hard codes bitwise; the sampled probes from shared uniforms
  equal (``jax.random.categorical`` takes no uniforms, so the JAX side
  applies the port's inverse-CDF draw to the JAX head's band
  probabilities, then the JAX head's own band packing, sort and repeat
  mask); and the port's plain bf16 grouped serve (``Indexer.query`` on a
  generator that draws those uniforms) against the JAX package's grouped
  serve of the same probes on its bf16 ``Indexer``'s layout (Pallas in
  interpret mode): candidates and ids equal, every one."""

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
import nlsh_tpu.parallel
import nlsh_tpu_torch.models as tmodels
from benchmarks.configs import _data
from nlsh_tpu.index.indexer import Indexer as JIndexer
from nlsh_tpu.index.serving import serving_query_grouped
from nlsh_tpu.parallel.multitable import MultiTableIndexer as JMT
from nlsh_tpu.parallel.multitable import init_multi_table
from nlsh_tpu_torch.data import config_data
from nlsh_tpu_torch.data.configs import CONFIGS, config_head
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.parallel import MultiTableIndexer
from nlsh_tpu_torch.utils.checkpoint import (
    params_from_jax,
    stacked_params_from_jax,
)

N_TRAIN, N_TEST = 4096, 200
_ENV = ("NLSH_PROCESSED_GLOVE_25_PATH", "NLSH_PROCESSED_GLOVE_100_PATH",
        "NLSH_PROCESSED_SIFT_PATH", "NLSH_CONFIG2_BITS", "NLSH_CONFIG2_BL",
        "NLSH_CONFIG2_PROBES", "NLSH_CONFIG4_N")
# the engine an accelerator resolves ``engine="auto"`` to: the grouped
# engine for one table, the windowed one for an ensemble
_AUTO = {"Indexer": "grouped", "MultiTableIndexer": "windowed"}
_PORT_ENGINE = {"pallas-grouped": "grouped", "pallas-windowed": "windowed"}


def _shape(name):
    """(data id, dim, metric) of the configuration."""
    data_id, _, _, dim, metric = CONFIGS[name]["data"]
    return data_id, dim, metric


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_table_is_what_benchmarks_configs_runs(monkeypatch, name):
    """``config_<name>`` with ``_data``, ``self_knn``, ``_train``, the
    indexers and ``_measure`` stubbed, run to its end: the arguments it
    passes (the calibration's rows and ``exact_query_size``'s included)
    are the table's, and the table's head has its head's params."""
    cfg = CONFIGS[name]
    seen = {}
    data_id, n_train, n_test, dim, metric = cfg["data"]
    n_rows = cfg["subset"] or max(64, cfg["calibrate_rows"] or 0)

    class _Data:
        training = np.arange(n_rows * dim, dtype=np.float32).reshape(
            n_rows, dim)
        testing = np.ones((8, dim), np.float32)
        ground_truth = np.zeros((8, 20), np.int32)

    _Data.dim, _Data.metric = dim, metric

    def _train(hashing, data, steps, **kw):
        seen.update(hashing=hashing, steps=steps, rows=data.training.shape[0],
                    **kw)
        return types.SimpleNamespace(params={"hashing": None}), 0.0

    def _index(kind):
        class _Index:
            def __init__(self, hashing, params, corpus, **kw):
                seen["index"] = dict(kw, kind=kind)
                engine = kw.get("engine", "auto")
                self.engine = (f"pallas-{_AUTO[kind]}" if engine == "auto"
                               else engine)

            def query_async(self, q, **kw):
                seen["serve"] = kw

            def calibrate(self, q, **kw):
                seen["calibrate"] = (np.asarray(q), kw)
                return 8

            def exact_query_size(self, q, **kw):
                seen["exact_query_size"] = (np.asarray(q), kw)
                return np.zeros(len(q), np.int32)

        return _Index

    def _measure(idx, fn, queries, gt):
        fn(queries)
        return {"recall_at_10": 0.0, "query_size": 0.0, "qps": 1.0}

    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(bconfigs, "_data",
                        lambda *a: seen.update(data=a) or _Data())
    monkeypatch.setattr(bconfigs, "_train", _train)
    monkeypatch.setattr(bconfigs, "_measure", _measure)
    monkeypatch.setattr(nlsh_tpu.index, "Indexer", _index("Indexer"))
    monkeypatch.setattr(nlsh_tpu.parallel, "MultiTableIndexer",
                        _index("MultiTableIndexer"))
    monkeypatch.setattr(nlsh_tpu.ops.knn, "self_knn",
                        lambda x, k, metric: np.zeros((len(x), k), np.int32))
    out = getattr(bconfigs, f"config_{name}")()
    assert out["config"].split("_")[0] == name

    assert seen["data"] == cfg["data"]
    assert seen["steps"] == cfg["steps"]
    assert seen["rows"] == n_rows
    assert seen.get("n_tables") == cfg["n_tables"]
    assert seen.get("batch_size", 1024) == cfg["batch_size"]
    assert seen.get("balance_lambda", 0.0) == cfg["balance_lambda"]
    assert seen.get("hash_times", 10) == cfg["train_hash_times"]
    assert seen["serve"]["hash_times"] == cfg["hash_times"]
    assert seen["serve"].get("probe_mode", "sample") == cfg["probe_mode"]
    index = seen["index"]
    assert index["kind"] == ("MultiTableIndexer" if cfg["n_tables"]
                             else "Indexer")
    assert index["metric"] == metric
    engine = index.get("engine", "auto")
    assert _PORT_ENGINE.get(engine, _AUTO[index["kind"]]) == cfg["engine"]
    assert jnp.dtype(index.get("serving_dtype") or jnp.float32).name == \
        cfg["serving_dtype"]
    if cfg["calibrate_rows"]:
        rows, kw = seen["calibrate"]
        np.testing.assert_array_equal(rows,
                                      _Data.training[:cfg["calibrate_rows"]])
        assert kw == {"hash_times": cfg["hash_times"]}
        q, kw = seen["exact_query_size"]
        np.testing.assert_array_equal(q, _Data.testing)
        assert kw == {"hash_times": cfg["hash_times"]}
    else:
        assert "calibrate" not in seen and "exact_query_size" not in seen
    hashing = seen["hashing"]
    assert type(hashing).__name__ == cfg["head"]
    assert hashing.hash_size == cfg["bits"]
    want = config_head(jmodels, cfg, dim)
    assert type(want) is type(hashing)
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


def _set_agreement(a, b) -> float:
    return float(np.mean([len(set(x[x >= 0]) & set(y[y >= 0]))
                          / max((x >= 0).sum(), 1) for x, y in zip(a, b)]))


def _hard_codes_match(th, jh, params, rows):
    with torch.no_grad():
        codes = th.hash_hard(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(
        codes, np.asarray(jh.hash_hard(params, jnp.asarray(rows))))
    return codes


def _single_table(name, data, metric):
    """Configs 1 and 2: the plain grouped serve at flip probes against
    the JAX ``Indexer(engine="xla")``."""
    cfg, dim = CONFIGS[name], data.dim
    jh, th = (config_head(m, cfg, dim) for m in (jmodels, tmodels))
    params = jh.init(jax.random.PRNGKey(int(name)))
    params_from_jax(th, jax.tree.map(np.asarray, params))
    _hard_codes_match(th, jh, params, data.training)
    probes = cfg["hash_times"]
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


def _ensemble(data, metric):
    """Config 4: eight tables from the JAX package's stacked init, their
    hard codes, and the plain windowed serve after ``calibrate`` against
    the JAX ``MultiTableIndexer(engine="xla")``."""
    cfg, dim = CONFIGS["4"], data.dim
    jh = config_head(jmodels, cfg, dim)
    stacked = init_multi_table(jh, cfg["n_tables"], jax.random.PRNGKey(4))
    heads = stacked_params_from_jax(lambda: config_head(tmodels, cfg, dim),
                                    jax.tree.map(np.asarray, stacked))
    assert len(heads) == cfg["n_tables"] == 8
    want = np.asarray(jax.vmap(lambda p: jh.hash_hard(
        p, jnp.asarray(data.training)))(stacked))
    with torch.no_grad():
        got = np.stack([h.hash_hard(torch.from_numpy(data.training)).numpy()
                        for h in heads])
    np.testing.assert_array_equal(got, want)
    assert want.max() < 2 ** 10 and len(np.unique(want)) > 100

    kw = dict(hash_times=cfg["hash_times"], probe_mode=cfg["probe_mode"])
    tm = MultiTableIndexer(heads, data.training, device="cpu", metric=metric,
                           engine=cfg["engine"],
                           serving_dtype=getattr(torch, cfg["serving_dtype"]))
    assert tm.calibrate(data.training[:N_TEST], **kw) >= 8
    t_ids, t_summed = tm.query(data.testing, k=10, **kw)
    t_size = tm.exact_query_size(data.testing, **kw)
    with jax.default_matmul_precision("float32"):
        jx = JMT(jh, stacked, jnp.asarray(data.training), metric=metric,
                 engine="xla")
        j_ids, j_cand = jx.query(jnp.asarray(data.testing), k=10, **kw)
    np.testing.assert_array_equal(t_size, np.asarray(j_cand))
    assert (t_summed >= t_size).all() and t_size.min() > 0
    assert _set_agreement(t_ids, np.asarray(j_ids)) >= 0.999


def _pq(data, metric):
    """pq: hard codes, sampled probes from shared uniforms, and the plain
    bf16 grouped serve against the JAX package's on its bf16 layout."""
    cfg, dim = CONFIGS["pq"], data.dim
    jh, th = (config_head(m, cfg, dim) for m in (jmodels, tmodels))
    assert (th.n_bands, th.bits_per_band) == (jh.n_bands, jh.bits_per_band) \
        == (3, 4)
    params = jh.init(jax.random.PRNGKey(5))
    params_from_jax(th, jax.tree.map(np.asarray, params))
    _hard_codes_match(th, jh, params, data.training)

    probes, seed = cfg["hash_times"], 1
    q = torch.from_numpy(data.testing)
    u = th.probe_uniforms(q.shape[0], probes,
                          torch.Generator().manual_seed(seed))
    with torch.no_grad():
        t_pid, t_pv = th.hash(q, n_probes=probes, uniforms=u)
    p = jh._band_probs(params, jnp.asarray(data.testing))     # (n, 3, 16)
    cdf = jnp.cumsum(p, axis=-1)
    cdf = cdf / cdf[..., -1:]
    sampled = jnp.minimum(jnp.sum(jnp.asarray(u.numpy())[..., None]
                                  >= cdf[:, None], axis=-1),
                          jh.band_size - 1)
    codes = jnp.concatenate([jnp.argmax(p, axis=-1)[:, None], sampled], 1)
    j_pid = jnp.sort(jh._pack_bands(codes), axis=-1)
    j_pv = jnp.concatenate([jnp.ones_like(j_pid[:, :1], bool),
                            j_pid[:, 1:] != j_pid[:, :-1]], axis=-1)
    np.testing.assert_array_equal(t_pid.numpy(), np.asarray(j_pid))
    np.testing.assert_array_equal(t_pv.numpy(), np.asarray(j_pv))
    assert (t_pv.numpy().sum(1) > 1).mean() > 0.5   # the draws add buckets

    dtype = getattr(torch, cfg["serving_dtype"])
    ti = Indexer(th, data.training, device="cpu", metric=metric,
                 engine=cfg["engine"], serving_dtype=dtype)
    assert ti.layout.data.dtype == torch.bfloat16
    t_ids, t_cand = ti.query(data.testing, k=10, hash_times=probes,
                             generator=torch.Generator().manual_seed(seed),
                             probe_mode=cfg["probe_mode"])
    ji = JIndexer(jh, params, jnp.asarray(data.training), metric=metric,
                  engine="pallas-grouped", serving_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(ti.table.row_ids.numpy(),
                                  np.asarray(ji.table.row_ids))
    j_ids, _, j_cand = serving_query_grouped(
        ji.layout, jnp.asarray(data.testing), j_pid, j_pv, ji.table.counts,
        k=10)
    np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
    np.testing.assert_array_equal(t_ids, np.asarray(j_ids))
    assert t_cand.min() > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_head_and_serve_match_jax(both_data, name):
    _, data = both_data[name]
    _, _, metric = _shape(name)
    if name == "4":
        _ensemble(data, metric)
    elif name == "pq":
        _pq(data, metric)
    else:
        _single_table(name, data, metric)
