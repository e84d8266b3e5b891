"""The fixed-cap engine: K5/K6, ``bucket_scores``, ``serving_query`` and
``Indexer(engine="fixed")``.

The port (plain kernels on the CPU) against the JAX package (Pallas in
interpret mode) on the same numpy inputs.  Tolerances: unit-scale f32
dots agree within 1e-5 (another summation order); euclidean scores
(``2q.c - ||c||^2``, tens to hundreds) within 1e-5 plus 1e-6 of their
size; int8 blocks dotted with small dyadic queries sum exactly in f32,
so they compare bitwise.  ``positions`` and ``n_candidates`` are
integers and compare bitwise; ids compare wherever the score has no
neighbour within 1e-5 (elsewhere f32 order may swap equal-looking
rows).  The CUDA kernels are held to the plain versions on the card
(``cuda`` marker)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.index.bucket_table import build_bucket_table as j_build
from nlsh_tpu.index.indexer import Indexer as JIndexer
from nlsh_tpu.index.serving import serving_query as j_serve
from nlsh_tpu.models.encoders import MLPEncoder as JMLP
from nlsh_tpu.models.hashings import MultivariateBernoulli as JMVB
from nlsh_tpu.ops.pallas import query_kernel as jqk
from nlsh_tpu_torch.index import Indexer, build_bucket_table
from nlsh_tpu_torch.index.serving import serving_query, serving_query_grouped
from nlsh_tpu_torch.models import MLPEncoder, MultivariateBernoulli
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.tools.fixed_events import synthetic_events
from nlsh_tpu_torch.utils.checkpoint import params_from_jax

CAP = 128
DTYPES = ["float32", "bfloat16", "int8"]


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _rows(rng, n, d_pad, dtype):
    """``(n, d_pad)`` unit rows in ``dtype``, int8 quantised per row."""
    x = _unit(rng, (n, d_pad))
    if dtype != "int8":
        return x
    scale = np.abs(x).max(axis=1, keepdims=True) / 127.0
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8)


def _queries(rng, nq, d_pad, dtype):
    """Unit queries; small dyadic ones on int8 blocks (exact sums)."""
    if dtype == "int8":
        return (rng.integers(-16, 17, (nq, d_pad)) / 64.0).astype(np.float32)
    return _unit(rng, (nq, d_pad))


def _events(seed=0, nq=12, P=3, n_blocks=7, d_pad=128, dtype="float32"):
    """Synthetic events: counts of 0 (invalid probes), of cap and between,
    and a probe of the layout's last block."""
    rng = np.random.default_rng(seed)
    data = _rows(rng, n_blocks * CAP, d_pad, dtype)
    q = _queries(rng, nq, d_pad, dtype)
    block_idx = rng.integers(0, n_blocks, (nq, P)).astype(np.int32)
    block_idx[0, 0] = n_blocks - 1
    counts = rng.integers(1, CAP, (nq, P)).astype(np.int32)
    counts[1] = CAP
    counts[2, :2] = 0
    counts[3, 1] = 1
    return data, q, block_idx, counts


def _torch(data, dtype):
    return torch.from_numpy(data).to(getattr(torch, dtype))


def _assert_scores(got, want, dtype, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    if dtype == "int8":
        np.testing.assert_array_equal(got[fin], want[fin])
    else:
        np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_k5_matches_pallas(dtype):
    data, q, block_idx, counts = _events(dtype=dtype)
    want = jqk._bucket_scores_auto(
        jnp.asarray(data).astype(jnp.dtype(dtype)), jnp.asarray(q),
        jnp.asarray(block_idx), jnp.asarray(counts), cap=CAP, n_probes=3,
        interpret=True)
    before = dict(qk.KERNEL_LAUNCHES)
    got = qk.bucket_scores_auto(_torch(data, dtype), torch.from_numpy(q),
                                torch.from_numpy(block_idx),
                                torch.from_numpy(counts), CAP)
    assert qk.KERNEL_LAUNCHES == before  # the plain version is no launch
    assert got.shape == (12, 3, CAP) and got.dtype == torch.float32
    _assert_scores(got.numpy(), want, dtype)
    assert not np.isfinite(got.numpy()[2, :2]).any()   # count 0
    assert np.isfinite(got.numpy()[1]).all()           # count = cap


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_k6_matches_pallas(dtype):
    """K6 at starts that are multiples of 8 but not of cap, and equal to
    K5 bitwise at block-exact starts."""
    data, q, block_idx, counts = _events(seed=1, dtype=dtype)
    rng = np.random.default_rng(2)
    starts = (rng.integers(0, (data.shape[0] - CAP) // 8 + 1, block_idx.shape)
              * 8).astype(np.int32)
    starts[0, 0] = data.shape[0] - CAP       # the layout's tail
    starts[0, 1] = 8                          # not a multiple of cap
    want = jqk._bucket_scores_impl(
        jnp.asarray(data).astype(jnp.dtype(dtype)), jnp.asarray(q),
        jnp.asarray(starts), jnp.asarray(counts), cap=CAP, n_probes=3,
        align=8, interpret=True)
    t = (_torch(data, dtype), torch.from_numpy(q))
    got = qk.bucket_scores_impl(*t, torch.from_numpy(starts),
                                torch.from_numpy(counts), CAP)
    _assert_scores(got.numpy(), want, dtype)
    k5 = qk.bucket_scores_auto(*t, torch.from_numpy(block_idx),
                               torch.from_numpy(counts), CAP)
    k6 = qk.bucket_scores_impl(*t, torch.from_numpy(block_idx * CAP),
                               torch.from_numpy(counts), CAP)
    assert torch.equal(k5, k6)


def _layout_case(metric, seed=7, n=1500, d=24, nb=24, nq=23, P=6,
                 dtype="float32", scale_mode="per_row", cap=None):
    """A cap-aligned layout in both packages over a corpus of small dyadic
    values (row norms exact in f32, so the layouts compare bitwise), and
    a probe batch with invalid probes, an out-of-range id and the last
    bucket."""
    rng = np.random.default_rng(seed)
    corpus = (rng.integers(-16, 17, (n, d)) / 8.0).astype(np.float32)
    queries = rng.normal(size=(nq, d)).astype(np.float32)
    ids = rng.integers(0, nb, n).astype(np.int32)
    ids[:200] = nb - 1                       # a bucket above the cap
    pid = np.sort(rng.integers(0, nb, (nq, P)).astype(np.int32), axis=1)
    pv = np.concatenate([np.ones((nq, 1), bool), pid[:, 1:] != pid[:, :-1]], 1)
    pv[::5, -1] = False
    pid[1, -1] = nb + 3                       # out of range: clipped
    pid[2, 0] = nb - 1
    jt = j_build(jnp.asarray(ids), nb)
    jl = jqk.serving_layout(jt, jnp.asarray(corpus), metric=metric, cap=cap,
                            dtype=jnp.dtype(dtype), block_rows=CAP,
                            scale_mode=scale_mode)
    tt = build_bucket_table(torch.from_numpy(ids), nb)
    tl = qk.serving_layout(tt, torch.from_numpy(corpus), metric=metric,
                           cap=cap, dtype=getattr(torch, dtype),
                           block_rows=CAP, scale_mode=scale_mode)
    return queries, pid, pv, (jl, jt), (tl, tt)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_bucket_scores_matches_jax(metric):
    queries, pid, pv, (jl, _), (tl, _) = _layout_case(metric, cap=256)
    jqe = jqk.extend_queries(jl, jnp.asarray(queries))
    j_scores, j_pos = jqk.bucket_scores(jl, jqe, jnp.asarray(pid),
                                        jnp.asarray(pv), interpret=True)
    tqe = qk.extend_queries(tl, torch.from_numpy(queries))
    scores, pos = qk.bucket_scores(tl, tqe, torch.from_numpy(pid),
                                   torch.from_numpy(pv))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    assert pos.dtype == torch.int32 and scores.shape == (23, 6, tl.cap)
    _assert_scores(scores.numpy(), j_scores, "float32")
    p_scores, p_pos = qk.bucket_scores(tl, tqe, torch.from_numpy(pid),
                                       torch.from_numpy(pv), plain=True)
    assert torch.equal(p_scores, scores) and torch.equal(p_pos, pos)


def _untied(scores: np.ndarray, tol: float = 1e-5) -> np.ndarray:
    """Slots of descending rows whose score has no neighbour within
    ``tol``."""
    gap_prev = np.full(scores.shape, np.inf, np.float32)
    gap_next = np.full(scores.shape, np.inf, np.float32)
    with np.errstate(invalid="ignore"):
        gap_prev[:, 1:] = scores[:, :-1] - scores[:, 1:]
        gap_next[:, :-1] = scores[:, :-1] - scores[:, 1:]
    return np.isfinite(scores) & (gap_prev > tol) & (gap_next > tol)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("dtype,scale_mode", [
    ("float32", "per_row"), ("int8", "per_row"), ("int8", "global"),
])
def test_serving_query_matches_jax(metric, dtype, scale_mode):
    queries, pid, pv, (jl, jt), (tl, tt) = _layout_case(
        metric, seed=11, dtype=dtype, scale_mode=scale_mode)
    k = 7
    j_ids, j_scores, j_cand = j_serve(
        jl, jnp.asarray(queries), jnp.asarray(pid), jnp.asarray(pv),
        jt.counts, k=k, interpret=True)
    t_ids, t_scores, t_cand = serving_query(
        tl, torch.from_numpy(queries), torch.from_numpy(pid),
        torch.from_numpy(pv), tt.counts, k=k)
    np.testing.assert_array_equal(t_cand.numpy(), np.asarray(j_cand))
    j_scores, j_ids = np.asarray(j_scores), np.asarray(j_ids)
    fin = np.isfinite(j_scores)
    np.testing.assert_array_equal(np.isfinite(t_scores.numpy()), fin)
    np.testing.assert_allclose(t_scores.numpy()[fin], j_scores[fin],
                               atol=1e-5, rtol=1e-6)
    untied = _untied(j_scores)
    assert untied.mean() > 0.5
    np.testing.assert_array_equal(t_ids.numpy()[untied], j_ids[untied])
    assert (t_ids.numpy()[~fin] == -1).all()
    assert t_ids.dtype == torch.int32 and t_ids.shape == (queries.shape[0], k)
    p = serving_query(tl, torch.from_numpy(queries), torch.from_numpy(pid),
                      torch.from_numpy(pv), tt.counts, k=k, plain=True)
    for a, b in zip(p, (t_ids, t_scores, t_cand)):
        assert torch.equal(a, b)


def test_fixed_cap_engine_rejects_block_aligned_layout():
    rng = np.random.default_rng(12)
    n, d, nb = 300, 16, 8
    corpus = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    table = build_bucket_table(
        torch.from_numpy(rng.integers(0, nb, n).astype(np.int32)), nb)
    layout = qk.serving_layout(table, corpus, metric="cosine",
                               cap=4 * qk.BLOCK_ROWS, align=qk.BLOCK_ROWS)
    queries = torch.from_numpy(rng.normal(size=(4, d)).astype(np.float32))
    pid = torch.zeros((4, 2), dtype=torch.int32)
    pv = torch.ones((4, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="fixed-cap"):
        serving_query(layout, queries, pid, pv, table.counts, k=3)


def _indexers(metric, seed=9, **kw):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(1200, 16)).astype(np.float32)
    queries = rng.normal(size=(40, 16)).astype(np.float32)
    jh = JMVB(JMLP(16, (32,)), 5)
    params = jh.init(jax.random.PRNGKey(seed))
    th = MultivariateBernoulli(MLPEncoder(16, (32,)), 5)
    params_from_jax(th, jax.tree.map(np.asarray, params))
    ji = JIndexer(jh, params, jnp.asarray(corpus), metric=metric,
                  engine="pallas")
    ti = Indexer(th, corpus, device="cpu", metric=metric, engine="fixed")
    return queries, ji, ti


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_indexer_fixed_matches_jax_pallas_engine(metric):
    """``Indexer(engine="fixed")`` against the JAX ``Indexer(engine=
    "pallas")``, and against the port's grouped engine on the same
    cap-aligned layout."""
    queries, ji, ti = _indexers(metric)
    assert ti.layout.align == ti.layout.cap
    j_ids, j_cand = ji.query(jnp.asarray(queries), k=10, hash_times=6,
                             probe_mode="flip")
    t_ids, t_cand = ti.query(queries, k=10, hash_times=6, probe_mode="flip")
    np.testing.assert_array_equal(t_cand, np.asarray(j_cand))
    assert (t_ids == np.asarray(j_ids)).mean() >= 0.98
    layout = ti.layout
    ti.engine = "grouped"
    assert ti.layout is layout  # the same cap-aligned layout
    g_ids, g_cand = ti.query(queries, k=10, hash_times=6, probe_mode="flip")
    np.testing.assert_array_equal(g_cand, t_cand)
    assert (g_ids == t_ids).mean() >= 0.98


# -- the kernel's schedule: events sorted by the rows they read -------------

SCHED_CAP, SCHED_BLOCKS = 40, 7
SCHED_CASES = ["mixed", "duplicates", "long_run", "all_dead", "one_event",
               "ragged", "out_of_range", "overlap", "block_exact"]


def _sched_case(name, cap=SCHED_CAP, n_blocks=SCHED_BLOCKS):
    cases = {c["name"]: c for c in synthetic_events(5, n_blocks, cap)}
    assert sorted(cases) == sorted(SCHED_CASES)
    c = cases[name]
    return (torch.from_numpy(c["index"]), torch.from_numpy(c["counts"]),
            c["stride"] if c["stride"] == 1 else cap)


@pytest.mark.parametrize("name", SCHED_CASES)
def test_event_order_groups_events_by_clamped_first_row(name):
    """``_bucket_event_order``: a permutation of the events, live ones
    first and sorted by the first row the plain version reads (so equal
    rows are neighbours, whatever the raw index), events that score
    nothing after every live one; the launch's static work-item count
    covers the order; no host read is needed for either."""
    index, counts, stride = _sched_case(name)
    n_rows = SCHED_BLOCKS * SCHED_CAP
    order, keys, s_counts = qk._bucket_event_order(index, counts, SCHED_CAP,
                                                   stride, n_rows)
    n_ev = index.numel()
    assert order.dtype == keys.dtype == s_counts.dtype == torch.int32
    assert order.shape == keys.shape == s_counts.shape == (n_ev,)
    assert sorted(order.tolist()) == list(range(n_ev))
    so = order.long()
    assert torch.equal(s_counts, counts.reshape(-1)[so])
    first = torch.empty_like(keys)
    first[so] = keys                          # each event's own key
    live = counts.reshape(-1) > 0
    want = torch.clamp(index.reshape(-1).long() * stride, 0,
                       n_rows - SCHED_CAP)
    assert torch.equal(first[live].long(), want[live])
    assert (first[~live] == n_rows).all()
    n_live = int(live.sum())
    assert live[so[:n_live]].all() and not live[so[n_live:]].any()
    assert (keys[1:] >= keys[:-1]).all()
    # stable: equal keys keep the events' own order
    same = keys[1:] == keys[:-1]
    assert (so[1:] > so[:-1])[same].all()
    # work items: chunks of the order; the scoring runs of every chunk hold
    # live events only, and together all of them, each once
    n_items = qk.bucket_work_items(n_ev)
    assert n_items == -(-n_ev // qk._BUCKET_G)
    scored = []
    for item in range(n_items):
        evs = so[item * qk._BUCKET_G:(item + 1) * qk._BUCKET_G]
        scored += evs[live[evs]].tolist()
    assert sorted(scored) == torch.nonzero(live).reshape(-1).tolist()
    if name == "out_of_range":  # raw indices differ, the rows do not
        assert index.min() < 0 and index.max() >= SCHED_BLOCKS
        assert len(set(first[:4].tolist())) == 2
    if name == "all_dead":
        assert n_live == 0


def _emulate_schedule(data, q, index, counts, cap, stride):
    """The kernel's schedule in torch: per chunk of the sorted order, the
    lanes from each event's count to ``cap`` get -inf; each run of equal
    first rows reads its rows once, below the run's largest count, times
    the run's queries; every slot keeps the lanes below its own count and
    the result is scattered through the order.  Every element must be
    written exactly once."""
    nq, n_probes = index.shape
    n_ev = nq * n_probes
    order, keys, _ = qk._bucket_event_order(index, counts, cap, stride,
                                            data.shape[0])
    first = torch.empty_like(keys)
    first[order.long()] = keys
    cnt = counts.reshape(-1).clamp(0, cap).long()
    out = torch.zeros((n_ev, cap))
    writes = torch.zeros((n_ev, cap), dtype=torch.int32)
    lane = torch.arange(cap)
    for item in range(qk.bucket_work_items(n_ev)):
        evs = order[item * qk._BUCKET_G:(item + 1) * qk._BUCKET_G].long()
        fill = lane >= cnt[evs, None]
        out[evs] = torch.where(fill, -torch.inf, out[evs])
        writes[evs] += fill
        live = evs[cnt[evs] > 0]
        s = 0
        while s < len(live):
            f = int(first[live[s]])
            e = s
            while e < len(live) and int(first[live[e]]) == f:
                e += 1
            run = live[s:e]
            rows = int(cnt[run].max())
            block = data[f:f + rows].to(torch.float32)   # one read
            sc = q[run // n_probes] @ block.T
            keep = lane[:rows] < cnt[run, None]
            out[run, :rows] = torch.where(keep, sc, out[run, :rows])
            writes[run, :rows] += keep
            s = e
    assert (writes == 1).all()
    return out.reshape(nq, n_probes, cap)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", SCHED_CASES)
def test_schedule_emulation_matches_plain(name, dtype):
    """Sorted order -> per-run rows x the run's queries -> scatter ->
    per-slot mask gives the plain version's scores: bitwise on int8 rows
    with dyadic queries (exact sums), within 1e-5 otherwise (another
    summation order)."""
    index, counts, stride = _sched_case(name)
    rng = np.random.default_rng(6)
    data = _torch(_rows(rng, SCHED_BLOCKS * SCHED_CAP, 128, dtype), dtype)
    q = torch.from_numpy(_queries(rng, index.shape[0], 128, dtype))
    got = _emulate_schedule(data, q, index, counts, SCHED_CAP, stride)
    want = qk._bucket_scores_plain(data, q, index, counts, SCHED_CAP, stride)
    _assert_scores(got.numpy(), want.numpy(), dtype)
    fin = np.isfinite(want.numpy())
    np.testing.assert_array_equal(
        fin, np.arange(SCHED_CAP) < np.clip(counts.numpy(), 0, SCHED_CAP)[..., None])


def test_fixed_wrappers_take_the_plain_version_only_on_the_cpu():
    data, q, block_idx, counts = _events(seed=3, nq=4)
    args = [torch.from_numpy(a) for a in (data, q, block_idx, counts)]
    meta = [a.to("meta") for a in args]
    for fn in (qk.bucket_scores_auto, qk.bucket_scores_impl):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*meta, CAP)


# -- the CUDA kernels against their plain versions, on the card ------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cap", [8, 200, 512, 1024])
@pytest.mark.parametrize("d_pad", [128, 384, 1280, 12288])
def test_k5_k6_kernels_match_plain(cuda_device, dtype, d_pad, cap):
    n_blocks = 9 if d_pad <= 1280 else 5
    rng = np.random.default_rng(4)
    data = torch.from_numpy(_rows(rng, n_blocks * cap, d_pad, dtype)).to(
        cuda_device).to(getattr(torch, dtype))
    before = dict(qk.KERNEL_LAUNCHES)
    launched = {"bucket_scores_auto": 0, "bucket_scores_impl": 0}
    for case in synthetic_events(4, n_blocks, cap):
        index, counts = (torch.from_numpy(case[n]).to(cuda_device)
                         for n in ("index", "counts"))
        q = torch.from_numpy(_queries(rng, index.shape[0], d_pad, dtype)).to(
            cuda_device)
        if case["stride"] == 1:
            kernel, plain = qk.bucket_scores_impl, qk.bucket_scores_impl_plain
        else:
            kernel, plain = qk.bucket_scores_auto, qk.bucket_scores_auto_plain
        got = kernel(data, q, index, counts, cap)
        torch.cuda.synchronize()
        launched[kernel.__name__] += 1
        _assert_scores(got.cpu().numpy(),
                       plain(data, q, index, counts, cap).cpu().numpy(), dtype)
        again = kernel(data, q, index, counts, cap)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
            f"{case['name']}: two launches differ"
        launched[kernel.__name__] += 1
        if case["name"] == "block_exact":   # K6 = K5 bitwise on the same rows
            k5 = qk.bucket_scores_auto(data, q, index // cap, counts, cap)
            launched["bucket_scores_auto"] += 1
            assert torch.equal(k5, got)
    for name, n in launched.items():
        assert qk.KERNEL_LAUNCHES[name] == before[name] + n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("br,d_pad", [(128, 128), (512, 128), (512, 384)])
def test_k5_scores_are_k2_panel_rows_bitwise(cuda_device, dtype, br, d_pad):
    """One fmaf chain per (query, row) over the features in order in both
    kernels: K5's live lanes equal K2's panel rows bit for bit where
    ``cap == block_rows``, however the events are grouped."""
    rng = np.random.default_rng(10)
    G, g_total, n_blocks = 13, 40, 11
    data = torch.from_numpy(_rows(rng, n_blocks * br, d_pad, dtype)).to(
        cuda_device).to(getattr(torch, dtype))
    qvecs = torch.from_numpy(_unit(rng, (g_total, G, d_pad))).to(cuda_device)
    grp_block = torch.from_numpy(
        rng.integers(0, n_blocks, g_total).astype(np.int32)).to(cuda_device)
    counts = torch.from_numpy(
        rng.integers(0, br + 1, (g_total * G, 1)).astype(np.int32)).to(
            cuda_device)
    panel = qk.grouped_scores(data, qvecs, grp_block, block_rows=br)
    k5 = qk.bucket_scores_auto(
        data, qvecs.reshape(g_total * G, d_pad),
        grp_block.repeat_interleave(G).reshape(-1, 1), counts, br)
    keep = torch.arange(br, device=cuda_device) < counts
    assert keep.any()
    assert torch.equal(k5[:, 0][keep], panel.reshape(-1, br)[keep])
    assert torch.isinf(k5[:, 0][~keep]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_indexer_fixed_engine_on_the_card(cuda_device, metric, dtype):
    """The Indexer serves through K5 on the card, agrees with its plain
    scorer and with the grouped engine."""
    rng = np.random.default_rng(8)
    corpus = rng.normal(size=(20000, 32)).astype(np.float32)
    queries = rng.normal(size=(300, 32)).astype(np.float32)
    torch.manual_seed(2)
    hashing = MultivariateBernoulli(MLPEncoder(32, (64,)), 6)
    idx = Indexer(hashing, corpus, device=cuda_device, metric=metric,
                  engine="fixed", serving_dtype=getattr(torch, dtype))
    before = qk.KERNEL_LAUNCHES["bucket_scores_auto"]
    ids, cand = idx.query(queries, k=10, hash_times=8, probe_mode="flip")
    assert qk.KERNEL_LAUNCHES["bucket_scores_auto"] > before
    p_ids, p_cand = idx.query(queries, k=10, hash_times=8, probe_mode="flip",
                              plain=True)
    np.testing.assert_array_equal(cand, p_cand)
    assert (ids == p_ids).mean() >= 0.99
    idx.engine = "grouped"
    g_ids, g_cand = idx.query(queries, k=10, hash_times=8, probe_mode="flip")
    np.testing.assert_array_equal(cand, g_cand)
    assert (ids == g_ids).mean() >= 0.98
