"""Port parity of persistence, the host-built layouts and the ensemble's
int8 and fixed-cap serves.

The port against the JAX package on the same numpy inputs (corpora of
small dyadic values wherever arrays are compared bitwise: every float
operation of the layout functions is then exact):

* corpus fingerprints: one digest for a numpy array, a CPU tensor and the
  JAX package;
* the numpy ``*_host`` layout functions: bitwise twins of the port's torch
  ones and of the JAX package's host ones, f32 / bf16 / int8,
  both scale modes, both alignments; the bf16 rounding on bit patterns;
* ``hash_corpus_host`` = ``hash_corpus``;
* ``save`` in one package, ``load`` in the other, both directions, single
  table and ensemble: integers bitwise, served ids equal; a nine-entry
  (eight for the ensemble) legacy ``meta``; refusals with the JAX
  package's messages;
* the ensemble on int8 layouts and on the fixed-cap engine against the
  JAX ensemble: ``n_candidates`` exact, ids on at least 0.98 of slots (f32
  summation order may swap near-tied neighbours); the int8 stacked
  layout's integers bitwise and its bytes within one step on under 0.1%
  of elements (the JAX ensemble compiles its layout build with the scale as a
  constant, which XLA may turn into a multiplication).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.index.bucket_table import build_bucket_table as j_build
from nlsh_tpu.index.indexer import Indexer as JIndexer
from nlsh_tpu.models.encoders import MLPEncoder as JMLP
from nlsh_tpu.models.hashings import MultivariateBernoulli as JMVB
from nlsh_tpu.ops.pallas import query_kernel as jqk
from nlsh_tpu.parallel.multitable import MultiTableIndexer as JMT
from nlsh_tpu.parallel.multitable import init_multi_table
from nlsh_tpu.utils import fingerprint as jfp
from nlsh_tpu_torch.index import Indexer, build_bucket_table, hash_corpus
from nlsh_tpu_torch.index import indexer as indexer_mod
from nlsh_tpu_torch.index.indexer import engine_from_jax, hash_corpus_host
from nlsh_tpu_torch.models import MLPEncoder, MultivariateBernoulli
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.parallel import MultiTableIndexer
from nlsh_tpu_torch.utils import fingerprint as tfp
from nlsh_tpu_torch.utils.checkpoint import (
    params_from_jax,
    stacked_params_from_jax,
)

METRICS = ["cosine", "euclidean"]
T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}
J_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
            "int8": jnp.int8}
ENGINES = [("grouped", "pallas-grouped"), ("windowed", "pallas-windowed"),
           ("fixed", "pallas"), ("gather", "xla"), ("auto", "auto")]


def _dyadic(rng, n, d):
    return (rng.integers(-16, 17, (n, d)) / 8.0).astype(np.float32)


# -- fingerprints -----------------------------------------------------------

@pytest.mark.parametrize("n", [5, 64, 300, 5000])
def test_fingerprint_is_one_digest_for_numpy_tensor_and_jax(n):
    corpus = np.random.default_rng(n).normal(size=(n, 7)).astype(np.float32)
    want = jfp.corpus_fingerprint(jnp.asarray(corpus))
    assert want.startswith("v2:")
    assert tfp.corpus_fingerprint(corpus) == want
    assert tfp.corpus_fingerprint(torch.from_numpy(corpus)) == want
    half = n // 2 + 1
    assert tfp.corpus_fingerprint(torch.from_numpy(corpus), n_real=half) == \
        jfp.corpus_fingerprint(corpus, n_real=half)
    edited = corpus.copy()
    edited[-1, 0] += 1.0                       # one tail row changed
    assert tfp.corpus_fingerprint(edited) != want


def test_check_fingerprint_refuses_like_jax():
    corpus = np.random.default_rng(0).normal(size=(100, 4)).astype(np.float32)
    digest = tfp.corpus_fingerprint(corpus)
    tfp.check_fingerprint(digest, torch.from_numpy(corpus))
    for stored, other in ((digest, corpus + 1.0), ("0123456789abcdef", corpus)):
        with pytest.raises(ValueError) as want:
            jfp.check_fingerprint(stored, other)
        with pytest.raises(ValueError) as got:
            tfp.check_fingerprint(stored, other)
        assert str(got.value) == str(want.value)


# -- the host layouts -------------------------------------------------------

def test_bf16_bits_round_half_to_even_like_torch():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4000).astype(np.float32) * 10.0 ** rng.integers(
            -20, 20, 4000).astype(np.float32),
        # exact halves between two bf16 values (ties), specials, denormals
        np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x3F807FFF, 0x3F808001,
                  0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x00000001, 0x80000000,
                  0x7FC00000, 0xFFC00001, 0x7F800001], np.uint32
                 ).view(np.float32)])
    got = qk._bf16_bits(x)
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan].view(np.int16), want[~nan])
    back = torch.from_numpy(got[nan].view(np.int16)).view(torch.bfloat16)
    assert bool(torch.isnan(back).all())
    j = np.asarray(jnp.asarray(x[~nan]).astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got[~nan], j)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", ["per_row", "global"])
def test_ext_scales_host_bitwise(metric, mode):
    corpus = _dyadic(np.random.default_rng(3), 300, 40)
    got = np.asarray(qk.ext_scales_host(corpus, metric, mode), np.float32)
    np.testing.assert_array_equal(
        got, qk.ext_scales(torch.from_numpy(corpus), metric, mode).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jqk.ext_scales_host(corpus, metric, mode), np.float32))


def _layout_fields(lay, as_numpy):
    out = {name: as_numpy(getattr(lay, name))
           for name in ("row_map", "starts", "counts")}
    out["norms"] = None if lay.norms is None else as_numpy(lay.norms)
    out["scale"] = None if lay.scale is None else as_numpy(lay.scale)
    return out


def _data_bits(a):
    """A layout's rows as integers: bf16 by bit pattern."""
    if torch.is_tensor(a):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype,mode", [("float32", "per_row"),
                                        ("bfloat16", "per_row"),
                                        ("int8", "per_row"),
                                        ("int8", "global")])
@pytest.mark.parametrize("align", [None, 8])
def test_host_layout_is_the_device_layouts_bitwise_twin(metric, dtype, mode,
                                                        align):
    rng = np.random.default_rng(5)
    n, d, nb = 1500, 20, 16
    corpus = _dyadic(rng, n, d)
    ids = rng.integers(0, nb + 1, n).astype(np.int32)  # nb: sentinel rows
    tt = build_bucket_table(torch.from_numpy(ids), nb)
    kw = dict(metric=metric, cap=200, align=align, block_rows=128,
              scale_mode=mode)
    host = qk.serving_layout_host(tt, corpus, dtype=T_DTYPES[dtype],
                                  device="cpu", **kw)
    dev = qk.serving_layout(tt, torch.from_numpy(corpus),
                            dtype=T_DTYPES[dtype], **kw)
    jt = j_build(jnp.asarray(ids), nb)
    jhost = jqk.serving_layout_host(jt, corpus, dtype=J_DTYPES[dtype], **kw)
    for name in ("cap", "d_pad", "align", "metric", "total_blocks",
                 "block_rows"):
        assert getattr(host, name) == getattr(dev, name) == getattr(jhost, name)
    assert host.data.dtype == dev.data.dtype == T_DTYPES[dtype]
    np.testing.assert_array_equal(_data_bits(host.data), _data_bits(dev.data))
    np.testing.assert_array_equal(_data_bits(host.data),
                                  _data_bits(jhost.data))
    want = _layout_fields(dev, lambda t: t.numpy())
    jwant = _layout_fields(jhost, np.asarray)
    for name, got in _layout_fields(host, lambda t: t.numpy()).items():
        if got is None:
            assert want[name] is None and jwant[name] is None, name
            continue
        np.testing.assert_array_equal(got, want[name], err_msg=name)
        np.testing.assert_array_equal(got, jwant[name], err_msg=name)


def _single(metric="cosine", seed=9, n=1200, d=16, bits=5, dyadic=False):
    rng = np.random.default_rng(seed)
    corpus = _dyadic(rng, n, d) if dyadic else \
        rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(40, d)).astype(np.float32)
    jh = JMVB(JMLP(d, (32,)), bits)
    params = jh.init(jax.random.PRNGKey(seed))
    th = MultivariateBernoulli(MLPEncoder(d, (32,)), bits)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    return corpus, queries, jh, params, th


@pytest.mark.parametrize("chunk", [100, 512, 4096])
def test_hash_corpus_host_equals_hash_corpus(chunk):
    corpus, _, jh, params, th = _single(n=1300)
    want = hash_corpus(th, torch.from_numpy(corpus)).numpy()
    got = hash_corpus_host(th, corpus, device="cpu", chunk=chunk)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    from nlsh_tpu.index.indexer import hash_corpus_host as j_host

    np.testing.assert_array_equal(got, j_host(jh, params, corpus, chunk=512))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_indexer_layout_modes_serve_alike(dtype):
    corpus, queries, _, _, th = _single(dyadic=True)
    res = {}
    for mode in ("auto", "device", "host"):
        idx = Indexer(th, corpus, device="cpu", layout_mode=mode,
                      serving_dtype=T_DTYPES[dtype], block_rows=128)
        res[mode] = idx.query(queries, k=10, hash_times=6, probe_mode="flip")
        if mode != "host":
            continue
        dev = Indexer(th, corpus, device="cpu", layout_mode="device",
                      serving_dtype=T_DTYPES[dtype], block_rows=128).layout
        np.testing.assert_array_equal(_data_bits(idx.layout.data),
                                      _data_bits(dev.data))
    for mode in ("device", "host"):
        np.testing.assert_array_equal(res[mode][0], res["auto"][0])
        np.testing.assert_array_equal(res[mode][1], res["auto"][1])
    with pytest.raises(ValueError, match="layout_mode"):
        Indexer(th, corpus, device="cpu", layout_mode="lazy")


# -- save / load: the single table ------------------------------------------

def _kw(q):
    return dict(k=10, hash_times=6, probe_mode="flip")


@pytest.mark.parametrize("engine,j_engine", ENGINES)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_index_saved_by_the_port_loads_in_jax(tmp_path, engine, j_engine,
                                              dtype):
    corpus, queries, jh, params, th = _single()
    ti = Indexer(th, corpus, device="cpu", engine=engine, probe_budget=70,
                 serving_dtype=T_DTYPES[dtype], block_rows=128,
                 int8_scale="global")
    path = str(tmp_path / "idx")        # np.savez appends .npz
    ti.save(path)
    assert (tmp_path / "idx.npz").exists()
    with np.load(path + ".npz") as z:
        assert [str(v) for v in z["meta"]] == [
            "cosine", "70", j_engine, dtype, "128", "auto", "1200", "16",
            tfp.corpus_fingerprint(corpus), "global"]
        assert all(z[n].dtype == np.int32
                   for n in ("row_ids", "starts", "counts"))
    ji = JIndexer.load(path + ".npz", jh, params, jnp.asarray(corpus))
    assert ji.engine == j_engine and ji.probe_budget == 70
    assert ji.block_rows == 128 and ji.int8_scale == "global"
    assert jnp.dtype(ji.serving_dtype).name == dtype
    for name in ("row_ids", "starts", "counts"):
        np.testing.assert_array_equal(np.asarray(getattr(ji.table, name)),
                                      getattr(ti.table, name).numpy())
    if engine == "auto":
        # each package resolves "auto" for itself (here: gather + rerank in
        # the JAX package, the grouped engine in the port); serve both on
        # one engine
        ti.engine, ji.engine = "gather", "xla"
    t_ids, t_cand = ti.query(queries, **_kw(queries))
    j_ids, j_cand = ji.query(jnp.asarray(queries), **_kw(queries))
    np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
    assert (t_ids == np.asarray(j_ids)).mean() >= 0.98


@pytest.mark.parametrize("engine,j_engine", ENGINES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_index_saved_by_jax_loads_in_the_port(tmp_path, monkeypatch, engine,
                                              j_engine, dtype):
    corpus, queries, jh, params, th = _single()
    ji = JIndexer(jh, params, jnp.asarray(corpus), engine=j_engine,
                  probe_budget=70, serving_dtype=J_DTYPES[dtype],
                  block_rows=128)
    path = str(tmp_path / "idx.npz")
    ji.save(path)
    calls = []
    monkeypatch.setattr(indexer_mod, "hash_corpus",
                        lambda *a, **k: calls.append(a) or 1 / 0)
    ti = Indexer.load(path, th, corpus, device="cpu")
    assert calls == []                       # load never re-hashes
    monkeypatch.undo()
    assert ti.engine == engine and ti.probe_budget == 70
    assert ti._budget_user and ti.block_rows == 128
    assert ti.serving_dtype == T_DTYPES[dtype] and ti.int8_scale == "per_row"
    assert ti.layout_mode == "auto" and ti.metric == "cosine"
    for name in ("row_ids", "starts", "counts"):
        got = getattr(ti.table, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ji.table, name)))
    fresh = Indexer(th, corpus, device="cpu", engine=engine, probe_budget=70,
                    serving_dtype=T_DTYPES[dtype], block_rows=128)
    for got, want in zip(ti.query(queries, **_kw(queries)),
                         fresh.query(queries, **_kw(queries))):
        np.testing.assert_array_equal(got, want)


def _resave(path, out, **changes):
    with np.load(path) as z:
        arrays = {name: z[name] for name in z.files}
    for name, fn in changes.items():
        arrays[name] = fn(arrays[name])
    np.savez_compressed(out, **arrays)


def test_legacy_meta_and_retired_engine(tmp_path):
    """Nine ``meta`` entries (archives from before the int8_scale knob)
    mean a global scale; ``pallas-compact`` serves as the grouped
    engine."""
    corpus, _, _, _, th = _single()
    path = str(tmp_path / "idx.npz")
    Indexer(th, corpus, device="cpu", serving_dtype=torch.int8).save(path)

    def legacy(meta):
        meta = [str(v) for v in meta[:9]]
        meta[2] = "pallas-compact"
        return np.array(meta)

    _resave(path, str(tmp_path / "old.npz"), meta=legacy)
    old = Indexer.load(str(tmp_path / "old.npz"), th, corpus, device="cpu")
    assert old.int8_scale == "global" and old.engine == "grouped"
    assert old.block_rows is None and old.serving_dtype == torch.int8
    assert engine_from_jax("pallas-compact") == "grouped"
    with pytest.raises(ValueError, match="unknown engine"):
        engine_from_jax("pallas-dense")


def test_load_refuses_another_corpus_like_jax(tmp_path):
    corpus, _, jh, params, th = _single()
    path = str(tmp_path / "idx.npz")
    Indexer(th, corpus, device="cpu").save(path)
    tail = corpus.copy()
    tail[-1] += 0.5                                  # one tail row changed
    for other in (tail, corpus[:-1], corpus[:, :-1]):
        with pytest.raises(ValueError) as want:
            JIndexer.load(path, jh, params, jnp.asarray(other))
        with pytest.raises(ValueError) as got:
            Indexer.load(path, th, other, device="cpu")
        assert str(got.value) == str(want.value)
    _resave(path, str(tmp_path / "v1.npz"),
            meta=lambda m: np.array([*m[:8], "deadbeefdeadbeef", m[9]]))
    with pytest.raises(ValueError, match="older corpus-fingerprint format"):
        Indexer.load(str(tmp_path / "v1.npz"), th, corpus, device="cpu")


# -- the ensemble: save / load, int8 layouts, the fixed-cap engine ----------

L, DIM, BITS, BR = 3, 16, 6, 128


def _ensemble(seed=0, n=1200, nq=40, dyadic=False):
    from nlsh_tpu.models import get_encoder as j_encoder
    from nlsh_tpu.models import get_hashing as j_hashing
    from nlsh_tpu_torch.models import get_encoder, get_hashing

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, DIM))
    pts = centers[rng.integers(0, 24, n + nq)] + 0.4 * rng.normal(
        size=(n + nq, DIM))
    pts = (np.round(pts * 8) / 8).astype(np.float32)
    if dyadic:  # small dyadic values: the int8 quantisation is exact
        pts = _dyadic(rng, n + nq, DIM)
    jh = j_hashing("MultivariateBernoulli", j_encoder("siren", DIM, [32]),
                   BITS)
    stacked = init_multi_table(jh, L, jax.random.PRNGKey(seed))
    hashings = stacked_params_from_jax(
        lambda: get_hashing("MultivariateBernoulli",
                            get_encoder("siren", DIM, [32]), BITS),
        jax.tree.map(np.asarray, stacked))
    return pts[:n], pts[n:], jh, stacked, hashings


MT_ENGINES = [e for e in ENGINES if e[0] != "auto"]


@pytest.mark.parametrize("engine,j_engine", MT_ENGINES)
def test_ensemble_saved_by_the_port_loads_in_jax(tmp_path, engine, j_engine):
    corpus, queries, jh, stacked, hashings = _ensemble()
    tm = MultiTableIndexer(hashings, corpus, device="cpu", engine=engine,
                           block_rows=BR, serving_dtype=torch.bfloat16)
    path = str(tmp_path / "mt")
    tm.save(path)
    with np.load(path + ".npz") as z:
        assert [str(v) for v in z["meta"]] == [
            "cosine", str(tm.probe_budget), j_engine, "bfloat16", str(BR),
            str(L), "1200", tfp.corpus_fingerprint(corpus), "per_row"]
    jm = JMT.load(path + ".npz", jh, stacked, jnp.asarray(corpus))
    assert jm.engine == j_engine and jm.probe_budget == tm.probe_budget
    for name in ("row_ids", "starts", "counts"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(tm, name).numpy())
    kw = dict(k=10, hash_times=2, probe_mode="flip")
    t_ids, t_cand = tm.query(queries, **kw)
    j_ids, j_cand = jm.query(jnp.asarray(queries), **kw)
    np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
    assert (t_ids == np.asarray(j_ids)).mean() >= 0.98


@pytest.mark.parametrize("engine,j_engine", MT_ENGINES)
def test_ensemble_saved_by_jax_loads_in_the_port(tmp_path, monkeypatch,
                                                 engine, j_engine):
    from nlsh_tpu_torch.parallel import multitable as mt_mod

    corpus, queries, jh, stacked, hashings = _ensemble(seed=1)
    jm = JMT(jh, stacked, jnp.asarray(corpus), engine=j_engine, block_rows=BR,
             probe_budget=90)
    path = str(tmp_path / "mt.npz")
    jm.save(path)
    calls = []
    monkeypatch.setattr(mt_mod, "hash_corpus",
                        lambda *a, **k: calls.append(a) or 1 / 0)
    tm = MultiTableIndexer.load(path, hashings, corpus, device="cpu")
    assert calls == []
    assert tm.engine == engine and tm.probe_budget == 90
    assert tm.block_rows == BR and tm.serving_dtype == torch.float32
    monkeypatch.undo()
    fresh = MultiTableIndexer(hashings, corpus, device="cpu", engine=engine,
                              block_rows=BR, probe_budget=90)
    for name in ("row_ids", "starts", "counts"):
        assert getattr(tm, name).dtype == torch.int32
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      getattr(fresh, name).numpy())
    kw = dict(k=10, hash_times=2, probe_mode="flip")
    for got, want in zip(tm.query(queries, **kw), fresh.query(queries, **kw)):
        np.testing.assert_array_equal(got, want)


def test_ensemble_load_refusals_and_legacy_meta(tmp_path):
    corpus, _, jh, stacked, hashings = _ensemble()
    path = str(tmp_path / "mt.npz")
    MultiTableIndexer(hashings, corpus, device="cpu",
                      serving_dtype=torch.int8).save(path)
    tail = corpus.copy()
    tail[-1] += 0.5
    for other in (tail, corpus[:-1]):
        with pytest.raises(ValueError) as want:
            JMT.load(path, jh, stacked, jnp.asarray(other))
        with pytest.raises(ValueError) as got:
            MultiTableIndexer.load(path, hashings, other, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=f"has {L} tables, params have 2"):
        MultiTableIndexer.load(path, hashings[:2], corpus, device="cpu")
    _resave(path, str(tmp_path / "old.npz"), meta=lambda m: m[:8])
    old = MultiTableIndexer.load(str(tmp_path / "old.npz"), hashings, corpus,
                                 device="cpu")
    assert old.int8_scale == "global" and old.serving_dtype == torch.int8


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", ["per_row", "global"])
@pytest.mark.parametrize("engine,j_engine", [e for e in MT_ENGINES
                                             if e[0] != "gather"])
def test_ensemble_int8_matches_jax(metric, mode, engine, j_engine):
    """int8 stacked layouts (dyadic corpus: integers bitwise, bytes within
    one step on under 0.1% of elements), then the serve: the
    scores leave every engine in dequantised units, so the cross-table
    collapse keeps one copy of each id."""
    corpus, queries, jh, stacked, hashings = _ensemble(seed=2, dyadic=True)
    jm = JMT(jh, stacked, jnp.asarray(corpus), metric=metric, engine=j_engine,
             block_rows=BR, serving_dtype=jnp.int8, int8_scale=mode)
    tm = MultiTableIndexer(hashings, corpus, device="cpu", metric=metric,
                           engine=engine, block_rows=BR,
                           serving_dtype=torch.int8, int8_scale=mode)
    jl, tl = jm._serving_layout(), tm._serving_layout()
    assert tl.data.dtype == torch.int8
    assert tl.scale.ndim == (1 if mode == "per_row" else 0)
    for name in ("data", "row_map", "starts", "counts", "scale", "norms"):
        got, want = getattr(tl, name), getattr(jl, name)
        if want is None:
            assert got is None, name
            continue
        got, want = got.numpy(), np.asarray(want)
        if name == "data":
            # the JAX ensemble compiles its layout build with the scale as a
            # constant, and XLA may then multiply by a reciprocal where
            # the port divides: a quotient next to a rounding boundary
            # can land one step away
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
        elif name == "norms":  # ... and so can the norms of those rows
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert (tl.cap, tl.align, tl.total_blocks) == (jl.cap, jl.align,
                                                   jl.total_blocks)
    kw = dict(k=10, hash_times=2, probe_mode="flip")
    t_ids, t_cand = tm.query(queries, **kw)
    j_ids, j_cand = jm.query(jnp.asarray(queries), **kw)
    np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
    assert (t_ids == np.asarray(j_ids)).mean() >= 0.98
    for row in t_ids:
        real = row[row >= 0]
        assert len(set(real)) == len(real)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ensemble_fixed_cap_engine_matches_jax(metric, dtype):
    corpus, queries, jh, stacked, hashings = _ensemble(seed=3)
    jm = JMT(jh, stacked, jnp.asarray(corpus), metric=metric, engine="pallas",
             block_rows=BR, serving_dtype=J_DTYPES[dtype])
    tm = MultiTableIndexer(hashings, corpus, device="cpu", metric=metric,
                           engine="fixed", block_rows=BR,
                           serving_dtype=T_DTYPES[dtype])
    jl, tl = jm._serving_layout(), tm._serving_layout()
    assert tl.align == tl.cap == jl.cap and tl.n_rows % tl.cap == 0
    np.testing.assert_array_equal(tl.row_map.numpy(), np.asarray(jl.row_map))
    np.testing.assert_array_equal(tl.starts.numpy(), np.asarray(jl.starts))
    kw = dict(k=10, hash_times=3, probe_mode="flip")
    t_ids, t_cand = tm.query(queries, **kw)
    j_ids, j_cand = jm.query(jnp.asarray(queries), **kw)
    np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
    assert (t_ids == np.asarray(j_ids)).mean() >= 0.98
    tm.engine = "windowed"                    # the stacked layout rebuilds
    w_ids, w_cand = tm.query(queries, **kw)
    np.testing.assert_array_equal(w_cand, t_cand)
    assert (w_ids == t_ids).mean() >= 0.98
    p_ids, _ = MultiTableIndexer(
        hashings, corpus, device="cpu", metric=metric, engine="fixed",
        block_rows=BR, serving_dtype=T_DTYPES[dtype]).query(
            queries, plain=True, **kw)
    np.testing.assert_array_equal(p_ids, t_ids)
