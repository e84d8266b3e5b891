"""The windowed engine: bounds, prep, K3/K4 and the serving path.

The port (plain kernels on the CPU) against the JAX package (Pallas in
interpret mode) on the same numpy inputs: bounds and the prep's seven
outputs bitwise; plain K3/K4 scores within 1e-5 (unit-scale f32 dots in
another summation order), lanes equal wherever the score is finite;
served ``n_candidates`` exact and ids on at least 0.98 of slots (the
gate of ``tests/test_serving.py``).  The CUDA kernels are held to the
plain versions on the card by the same tolerance (``cuda`` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.index.bucket_table import build_bucket_table as j_build
from nlsh_tpu.index.serving import serving_query_windowed as j_serve
from nlsh_tpu.ops.pallas import query_kernel as jqk
from nlsh_tpu_torch.index import build_bucket_table
from nlsh_tpu_torch.index.serving import (
    serving_query_grouped,
    serving_query_windowed,
)
from nlsh_tpu_torch.ops.cuda import query_kernel as qk

BR = 128


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _served(metric, seed=7, n=1500, d=24, nb=64, nq=23, P=6, cap=None):
    """A dense (align 8) layout in both packages, and a probe batch.  The
    corpus has small dyadic values, so its row norms are exact in f32 and
    the two layouts compare bitwise (``tests/test_torch_index.py``)."""
    rng = np.random.default_rng(seed)
    corpus = (rng.integers(-16, 17, (n, d)) / 8.0).astype(np.float32)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    ids = rng.integers(0, nb, n).astype(np.int32)
    pid = np.sort(rng.integers(0, nb, (nq, P)).astype(np.int32), axis=1)
    pv = np.concatenate([np.ones((nq, 1), bool), pid[:, 1:] != pid[:, :-1]], 1)
    pv[::5, -1] = False  # some invalid probes
    jt = j_build(jnp.asarray(ids), nb)
    jl = jqk.serving_layout(jt, jnp.asarray(corpus), metric=metric, cap=cap,
                            align=8, block_rows=BR)
    tt = build_bucket_table(torch.from_numpy(ids), nb)
    tl = qk.serving_layout(tt, torch.from_numpy(corpus), metric=metric,
                           cap=cap, align=8, block_rows=BR)
    return queries, pid, pv, (jl, jt), (tl, tt), corpus


def test_layout_and_bounds_match_jax():
    queries, pid, pv, (jl, _), (tl, _), _ = _served("cosine")
    for name in ("data", "row_map", "starts", "counts"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)))
    assert (tl.cap, tl.align, tl.n_rows) == (jl.cap, jl.align, jl.n_rows)
    max_sub = tl.cap // BR + 1
    for G in (32, 4):
        want = jqk.windowed_exact_bound(np.asarray(jl.starts),
                                        np.asarray(jl.counts), pid, pv,
                                        jl.cap, G, block_rows=BR)
        assert want > 0
        n_windows = -(-tl.n_rows // BR) + 1
        dev = int(jqk.windowed_needed_groups(
            jl.starts, jl.counts, jnp.asarray(pid), jnp.asarray(pv),
            jnp.asarray(jl.cap, jnp.int32), max_sub=max_sub, group_q=G,
            n_windows=n_windows, block_rows=BR))
        assert int(qk.windowed_needed_groups(
            tl.starts, tl.counts, torch.from_numpy(pid),
            torch.from_numpy(pv), tl.cap, max_sub=max_sub, group_q=G,
            n_windows=n_windows, block_rows=BR)) == dev == want
        # too few bins: sub-events past them drop, as mode="drop" does
        assert int(qk.windowed_needed_groups(
            tl.starts, tl.counts, torch.from_numpy(pid),
            torch.from_numpy(pv), tl.cap, max_sub=max_sub, group_q=G,
            n_windows=3, block_rows=BR)) == int(jqk.windowed_needed_groups(
                jl.starts, jl.counts, jnp.asarray(pid), jnp.asarray(pv),
                jnp.asarray(jl.cap, jnp.int32), max_sub=max_sub, group_q=G,
                n_windows=3, block_rows=BR))
    for args in ((138, 2, 40, 32), (5, 3, 0, 8), (1000, 2, 12, 32)):
        assert qk.windowed_static_bound(*args) == jqk.windowed_static_bound(*args)


@pytest.mark.parametrize("g_total", [None, 8])  # 8: most groups dropped
@pytest.mark.parametrize("group_q", [32, 4])
def test_windowed_prep_matches_jax_bitwise(g_total, group_q):
    queries, pid, pv, (jl, _), (tl, _), _ = _served("euclidean", seed=3,
                                                     cap=200)
    max_sub = tl.cap // BR + 1
    if g_total is None:
        g_total = qk._round_up(qk.windowed_static_bound(
            pid.size, max_sub, tl.n_rows // BR, group_q), 8)
    jqe = jqk.extend_queries(jl, jnp.asarray(queries))
    want = jqk._windowed_prep(
        jl.starts, jl.counts, jnp.asarray(pid), jnp.asarray(pv), jqe,
        jnp.asarray(jl.cap, jnp.int32), g_total=g_total, max_sub=max_sub,
        group_q=group_q, block_rows=BR)
    tqe = qk.extend_queries(tl, torch.from_numpy(queries))
    got = qk._windowed_prep(tl.starts, tl.counts, torch.from_numpy(pid),
                            torch.from_numpy(pv), tqe, tl.cap,
                            g_total=g_total, max_sub=max_sub,
                            group_q=group_q, block_rows=BR)
    names = ("grp_window", "grp_qvecs", "grp_lo", "grp_hi", "ev_row",
             "ev_window", "ev_valid")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[2].dtype == got[3].dtype == torch.int32
    # empty slots are lo = hi = 0
    hi, lo = got[3].numpy(), got[2].numpy()
    assert (lo[hi == 0] == 0).all() and (hi > lo).sum() > 0


def _kernel_case(seed=0, g_total=16, G=32, br=BR, d_pad=128, n_windows=6,
                 dtype="float32"):
    """Synthetic windowed groups: empty slots, hi - lo below kk, lo > 0.
    For ``dtype="int8"`` the rows are quantised per row, ``scale`` is
    their dequantisation scale and the queries are small dyadic values
    (every dot sums exactly in f32)."""
    rng = np.random.default_rng(seed)
    data = _unit(rng, (n_windows * br, d_pad))
    qvecs = _unit(rng, (g_total, G, d_pad))
    int8_scale = None
    if dtype == "int8":
        int8_scale = np.abs(data).max(axis=1) / np.float32(127.0)
        data = np.clip(np.round(data / int8_scale[:, None]), -127,
                       127).astype(np.int8)
        qvecs = (rng.integers(-16, 17, qvecs.shape) / 64.0).astype(np.float32)
    grp_window = np.sort(rng.integers(0, n_windows, g_total)).astype(np.int32)
    lo = rng.integers(0, br, (g_total, G)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, br, (g_total, G)), br).astype(np.int32)
    lo[::3, ::2] = hi[::3, ::2] = 0                         # empty slots
    hi[1::4, :6] = np.minimum(lo[1::4, :6] + rng.integers(1, 8, 6), br)
    lo[g_total - 1] = hi[g_total - 1] = 0                   # a dead group
    norms = rng.uniform(0.5, 1.5, n_windows * br).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n_windows * br).astype(np.float32)
    if int8_scale is not None:
        scale = int8_scale.astype(np.float32)
    return data, qvecs, grp_window, lo, hi, norms, scale


@pytest.mark.parametrize("kk,dtype,has_norms,has_scale", [
    (10, "float32", False, False), (16, "float32", True, True),
    (10, "bfloat16", True, True), (16, "bfloat16", False, False),
    (10, "int8", True, True), (16, "int8", False, True),
])
def test_plain_k3_matches_pallas(kk, dtype, has_norms, has_scale):
    data, qvecs, win, lo, hi, norms, scale = _kernel_case(dtype=dtype)
    packed = np.asarray(jqk._windowed_scores_topk(
        jnp.asarray(data).astype(jnp.dtype(dtype)), jnp.asarray(norms),
        jnp.asarray(qvecs), jnp.asarray(win), jnp.asarray(lo), jnp.asarray(hi),
        has_norms=has_norms, interpret=True, kk=kk, block_rows=BR,
        scale_rows=jnp.asarray(scale), has_scale=has_scale))
    j_scores, j_lanes = packed[..., :kk], packed[..., kk:2 * kk].astype(np.int32)
    scores, lanes = qk.windowed_scores_topk(
        torch.from_numpy(data).to(getattr(torch, dtype)),
        torch.from_numpy(qvecs), torch.from_numpy(win), torch.from_numpy(lo),
        torch.from_numpy(hi), kk, block_rows=BR,
        norms=torch.from_numpy(norms) if has_norms else None,
        scale_rows=torch.from_numpy(scale) if has_scale else None)
    scores, lanes = scores.numpy(), lanes.numpy()
    assert scores.shape == lanes.shape == (16, 32, kk)
    fin = np.isfinite(j_scores)
    assert 0 < fin.mean() < 1
    np.testing.assert_array_equal(np.isfinite(scores), fin)
    np.testing.assert_allclose(scores[fin], j_scores[fin], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(lanes[fin], j_lanes[fin])
    assert ((lanes >= lo[..., None]) & (lanes < hi[..., None]))[fin].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plain_k4_matches_pallas(dtype):
    data, qvecs, win, *_ = _kernel_case(seed=1, dtype=dtype)
    want = np.asarray(jqk._windowed_scores(
        jnp.asarray(data).astype(jnp.dtype(dtype)), jnp.asarray(qvecs),
        jnp.asarray(win), interpret=True, block_rows=BR))
    before = dict(qk.KERNEL_LAUNCHES)
    got = qk.windowed_scores(torch.from_numpy(data).to(getattr(torch, dtype)),
                             torch.from_numpy(qvecs), torch.from_numpy(win),
                             block_rows=BR)
    assert qk.KERNEL_LAUNCHES == before  # the plain version is no launch
    assert got.shape == (16, 32, BR)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_plain_k3_ties_take_the_lowest_lane_inside_the_range():
    data = np.zeros((BR, 128), np.float32)
    data[[3, 7, 9, 40, 60], 0] = 1.0   # five exact ties at the top
    data[[2, 50], 0] = 0.5
    qvecs = np.zeros((8, 1, 128), np.float32)
    qvecs[..., 0] = 1.0
    lo = np.full((8, 1), 5, np.int32)   # lane 3 lies below the range
    hi = np.full((8, 1), 55, np.int32)  # lane 60 above it
    args = (torch.from_numpy(data), torch.from_numpy(qvecs),
            torch.zeros(8, dtype=torch.int32), torch.from_numpy(lo),
            torch.from_numpy(hi))
    scores, lanes = qk.windowed_scores_topk(*args, 5, block_rows=BR)
    np.testing.assert_array_equal(lanes[0].numpy()[0], [7, 9, 40, 50, 5])
    packed = np.asarray(jqk._windowed_scores_topk(
        jnp.asarray(data), None, jnp.asarray(qvecs), jnp.zeros(8, jnp.int32),
        jnp.asarray(lo), jnp.asarray(hi), has_norms=False, interpret=True,
        kk=5, block_rows=BR))
    np.testing.assert_array_equal(lanes.numpy(), packed[..., 5:10].astype(np.int32))
    np.testing.assert_array_equal(scores.numpy(), packed[..., :5])


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("row_k", [7, 20])   # 20 > ROW_TOPK: the K4 branch
@pytest.mark.parametrize("query_chunk", [16384, 8])  # 8: chunks 8 + 8 + 7
def test_windowed_serving_matches_jax(metric, row_k, query_chunk):
    queries, pid, pv, (jl, jt), (tl, tt), _ = _served(metric)
    k = 7
    j_ids, j_scores, j_cand = j_serve(
        jl, jnp.asarray(queries), jnp.asarray(pid), jnp.asarray(pv),
        jt.counts, k=k, interpret=True, query_chunk=query_chunk,
        group_q=32, row_k=row_k)
    t_ids, t_scores, t_cand = serving_query_windowed(
        tl, torch.from_numpy(queries), torch.from_numpy(pid),
        torch.from_numpy(pv), tt.counts, k=k, query_chunk=query_chunk,
        row_k=row_k)
    np.testing.assert_array_equal(t_cand.numpy(), np.asarray(j_cand))
    assert (t_ids.numpy() == np.asarray(j_ids)).mean() >= 0.98
    j_scores = np.asarray(j_scores)
    fin = np.isfinite(j_scores)
    np.testing.assert_array_equal(np.isfinite(t_scores.numpy()), fin)
    np.testing.assert_allclose(t_scores.numpy()[fin], j_scores[fin],
                               atol=1e-5, rtol=0)
    assert t_ids.dtype == torch.int32 and t_ids.shape == (queries.shape[0], k)


def test_windowed_serving_g_total_override_plain_and_grouped():
    """The exact group bound serves what the static one does, ``plain``
    is the same path on the CPU, and the windowed engine agrees with the
    grouped one (same candidates, same ids)."""
    queries, pid, pv, (jl, jt), (tl, tt), corpus = _served("cosine", seed=8)
    args = (tl, torch.from_numpy(queries), torch.from_numpy(pid),
            torch.from_numpy(pv), tt.counts)
    base = serving_query_windowed(*args, k=5)
    exact = jqk.windowed_exact_bound(np.asarray(jl.starts),
                                     np.asarray(jl.counts), pid, pv, jl.cap,
                                     32, block_rows=BR)
    j_ids, _, j_cand = j_serve(
        jl, jnp.asarray(queries), jnp.asarray(pid), jnp.asarray(pv),
        jt.counts, k=5, interpret=True, group_q=32, g_total_override=exact)
    np.testing.assert_array_equal(base[2].numpy(), np.asarray(j_cand))
    assert (base[0].numpy() == np.asarray(j_ids)).mean() >= 0.98
    for got in (serving_query_windowed(*args, k=5, g_total_override=exact),
                serving_query_windowed(*args, k=5, plain=True)):
        for a, b in zip(got, base):
            assert torch.equal(a, b)
    gl = qk.serving_layout(tt, torch.from_numpy(corpus), block_rows=BR)
    g = serving_query_grouped(gl, *args[1:], k=5)
    assert torch.equal(g[2], base[2])
    assert (g[0] == base[0]).float().mean() >= 0.98


# -- the CUDA kernels against their plain versions, on the card ------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("kk", [10, 16])
@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("G,d_pad", [(32, 128), (8, 256)])
def test_k3_kernel_matches_plain(cuda_device, dtype, kk, extras, G, d_pad):
    data, qvecs, win, lo, hi, norms, scale = _kernel_case(
        seed=3, g_total=64, G=G, br=512, d_pad=d_pad, n_windows=8,
        dtype=str(dtype).split(".")[1])
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (data, qvecs, win, lo, hi, norms, scale)]
    t[0] = t[0].to(dtype)
    kw = dict(block_rows=512, norms=t[5] if extras else None,
              scale_rows=t[6] if extras else None)
    before = qk.KERNEL_LAUNCHES["windowed_scores_topk"]
    s, ln = qk.windowed_scores_topk(*t[:5], kk, **kw)
    assert qk.KERNEL_LAUNCHES["windowed_scores_topk"] == before + 1
    ps, pln = qk.windowed_scores_topk_plain(*t[:5], kk, **kw)
    fin = torch.isfinite(ps)
    assert torch.equal(torch.isfinite(s), fin)
    assert float((s - ps)[fin].abs().max()) <= 1e-5
    assert torch.equal(ln[fin], pln[fin])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_k4_kernel_matches_plain(cuda_device, dtype):
    data, qvecs, win, *_ = _kernel_case(seed=4, g_total=64, br=512,
                                        n_windows=8,
                                        dtype=str(dtype).split(".")[1])
    t = [torch.from_numpy(a).to(cuda_device) for a in (data, qvecs, win)]
    t[0] = t[0].to(dtype)
    before = qk.KERNEL_LAUNCHES["windowed_scores"]
    got = qk.windowed_scores(*t, block_rows=512)
    assert qk.KERNEL_LAUNCHES["windowed_scores"] == before + 1
    want = qk.windowed_scores_plain(*t, block_rows=512)
    assert float((got - want).abs().max()) <= 1e-5
