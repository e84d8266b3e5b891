"""The kernels' bounds, launch shapes and cross-tile ties, on the CPU.

* The bound counting of ``nlsh_tpu_torch.ops.cuda.bounds`` against bytes
  and operations counted by hand on small group tables (dead slots,
  overlapping lane ranges, rows probed by several slots counted once).
* The fused top-k kernel's launch shapes: a pure function of its shared
  memory footprint, which takes every ``(block_rows, d_pad)`` the
  previous kernel (a ``(G, block_rows)`` score panel in shared memory)
  took; likewise the raw-panel kernel's (its ring does not grow with
  either), and K7's wrapper on the CPU with its one query panel.
* Plain K1 and K3 against the JAX package's Pallas kernels (interpret
  mode) on exact ties that lie in different 128-row tiles of a 512-row
  block: the lowest lane comes first, as within one tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.ops.pallas import query_kernel as jqk
from nlsh_tpu_torch.ops.cuda import bounds
from nlsh_tpu_torch.ops.cuda import query_kernel as qk


def test_k1_counts_by_hand():
    """Four groups of G = 3 over 256-row blocks of f32 rows with norms,
    100 real features padded to 128: the padding is not counted."""
    br, d, d_pad = 256, 100, 128
    data = torch.zeros(4 * br, d_pad)
    grp_qvecs = torch.zeros(4, 3, d_pad)
    grp_block = torch.tensor([0, 0, 2, 3], dtype=torch.int32)
    grp_cnt = torch.tensor([[10, 0, 300], [5, 20, 0], [0, 0, 0], [1, 0, 0]],
                           dtype=torch.int32)
    got = bounds.topk_counts(data, grp_qvecs, grp_block, None, grp_cnt, 10,
                             br, d, norms=torch.zeros(4 * br))
    # rows: block 0 keeps [0, 256) (300 clamps to 256; 10, 5, 20 inside
    # it), block 3 keeps row 768; block 2's group is dead: 257 rows of
    # 400 bytes and a 4-byte norm
    rows = 257 * (100 * 4 + 4)
    queries = 5 * 100 * 4          # five live slots
    tables = 4 * 4 + 4 * 4 * 3     # grp_block, grp_cnt
    out = 4 * 3 * 10 * 8           # scores and lanes, (4, 3, 10)
    assert got.bytes == rows + queries + tables + out == 106852
    assert got.flops == 2 * 100 * (10 + 256 + 5 + 20 + 1) == 58400


def test_k3_counts_by_hand():
    """Three groups of G = 2 over 128-row windows of bf16 rows with
    per-row scales: overlapping ranges in one window, an empty slot
    (lo = hi), an inverted one (hi < lo) and a range past the window."""
    br, d, d_pad = 128, 100, 128
    data = torch.zeros(6 * br, d_pad, dtype=torch.bfloat16)
    grp_qvecs = torch.zeros(3, 2, d_pad)
    grp_window = torch.tensor([1, 1, 5], dtype=torch.int32)
    lo = torch.tensor([[10, 40], [100, 0], [7, 120]], dtype=torch.int32)
    hi = torch.tensor([[50, 90], [100, 5], [3, 200]], dtype=torch.int32)
    got = bounds.topk_counts(data, grp_qvecs, grp_window, lo, hi, 5, br, d,
                             scale_rows=torch.ones(6 * br))
    # window 1: [10, 50) u [40, 90) u [0, 5) = 85 rows; window 5:
    # [120, 128) = 8 rows; each 200 bytes and a 4-byte scale
    rows = 93 * (100 * 2 + 4)
    queries = 4 * 100 * 4          # four live slots
    tables = 3 * 4 + 2 * 3 * 2 * 4  # grp_window, grp_lo, grp_hi
    out = 3 * 2 * 5 * 8
    assert got.bytes == rows + queries + tables + out == 20872
    assert got.flops == 2 * 100 * (40 + 50 + 5 + 8) == 20600


def test_k3_counts_kk_is_clamped():
    data = torch.zeros(128, 128)
    args = (data, torch.zeros(1, 1, 128), torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, 1, dtype=torch.int32),
            torch.ones(1, 1, dtype=torch.int32))
    wide = bounds.topk_counts(*args, 40, 128, 128)
    assert wide == bounds.topk_counts(*args, qk.ROW_TOPK, 128, 128)
    assert wide.bytes - bounds.topk_counts(*args, 0, 128, 128).bytes == \
        (qk.ROW_TOPK - 1) * 8


def test_panel_counts_by_hand():
    """K2 / K4: each distinct block once, every pair scored, over the
    100 real features of rows padded to 128."""
    br, d, d_pad, G = 128, 100, 128, 4
    data = torch.zeros(3 * br, d_pad)
    grp_qvecs = torch.zeros(4, G, d_pad)
    grp_block = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    got = bounds.panel_counts(data, grp_qvecs, grp_block, G, br, d)
    blocks = 3 * 128 * 100 * 4
    assert got.bytes == blocks + 4 * G * 100 * 4 + 4 * 4 \
        + 4 * G * 128 * 4 == 168208
    assert got.flops == 2 * 100 * 4 * G * 128 == 409600


def test_panel_counts_of_the_int8_probe():
    """K7: the one query panel once, int8 blocks, any block order."""
    data = torch.zeros(64 * 128, 128, dtype=torch.int8)
    queries = torch.zeros(8, 128)
    order = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    got = bounds.panel_counts(data, queries, order.to(torch.int32), 8, 128,
                              128)
    assert got.bytes == 64 * 128 * 128 + 8 * 128 * 4 + 64 * 4 \
        + 64 * 8 * 128 * 4
    assert got.flops == 2 * 128 * 64 * 8 * 128


def test_panel_topk_counts_by_hand():
    """K8 after K2: each live lane once (a count past the block clamps to
    it, a negative one is dead), the slot table, the (g, G, kk) scores and
    lanes; no row arrays, no operations."""
    scores = torch.zeros(3, 2, 128)
    grp_block = torch.tensor([0, 1, 2], dtype=torch.int32)
    grp_hi = torch.tensor([[10, 0], [128, 300], [-1, 5]], dtype=torch.int32)
    got = bounds.panel_topk_counts(scores, grp_block, None, grp_hi, 20)
    lanes = 4 * (10 + 128 + 128 + 5)
    assert got.bytes == lanes + 4 * 6 + 6 * 20 * 8 == 2068
    assert got.flops == 0
    # kk clamps to the block's 128 lanes
    wide = bounds.panel_topk_counts(scores, grp_block, None, grp_hi, 500)
    assert wide.bytes == lanes + 4 * 6 + 6 * 128 * 8


def test_panel_topk_counts_of_windows_with_row_arrays():
    """K8 after K4 on a euclidean per-row int8 layout: lanes [lo, hi),
    each distinct row's scale and norm once (two slots share window 1's
    rows), the two slot tables and the window table."""
    br = 128
    scores = torch.zeros(2, 2, br)
    grp_window = torch.tensor([1, 3], dtype=torch.int32)
    lo = torch.tensor([[10, 40], [7, 120]], dtype=torch.int32)
    hi = torch.tensor([[50, 90], [3, 200]], dtype=torch.int32)
    got = bounds.panel_topk_counts(scores, grp_window, lo, hi, 17,
                                   norms=torch.zeros(4 * br),
                                   scale_rows=torch.ones(4 * br))
    lanes = 40 + 50 + 8
    rows = 80 + 8                  # [10, 90) of window 1, [120, 128) of 3
    assert got.bytes == 4 * lanes + 4 * 4 * 2 + 2 * 2 * 17 * 8 \
        + 2 * 4 * rows + 4 * 2 == 1680
    assert got.flops == 2 * lanes


def test_bucket_counts_by_hand():
    """K5 / K6: the union of the events' live rows, once, over their 100
    real features."""
    data = torch.zeros(64, 128)
    queries = torch.zeros(2, 128)
    starts = torch.tensor([[0, 8], [8, 40]], dtype=torch.int32)
    counts = torch.tensor([[3, 8], [5, 0]], dtype=torch.int32)
    got = bounds.bucket_counts(data, queries, starts, counts, cap=8, d=100)
    # [0, 3) u [8, 16) u [8, 13): 11 rows; [40, 40) is empty
    assert got.bytes == 11 * 400 + 2 * 100 * 4 + 2 * 4 * 4 + 2 * 2 * 8 * 4
    assert got.flops == 2 * 100 * (3 + 8 + 5)
    # a count above the cap is served as the cap
    big = bounds.bucket_counts(data, queries, starts, counts * 4, cap=8,
                               d=100)
    assert big.flops == 2 * 100 * (8 + 8 + 8)


@pytest.mark.parametrize("kind", ["topk", "panel", "bucket"])
def test_counts_do_not_grow_with_the_padding(kind):
    """The same 100 real features on layouts padded to 128 and to 256
    give the same bytes and operations."""
    def counts(d_pad):
        data = torch.zeros(4 * 128, d_pad)
        qvecs = torch.zeros(2, 3, d_pad)
        blk = torch.tensor([0, 3], dtype=torch.int32)
        cnt = torch.tensor([[5, 0, 128], [17, 2, 0]], dtype=torch.int32)
        if kind == "topk":
            return bounds.topk_counts(data, qvecs, blk, None, cnt, 10, 128, 100)
        if kind == "panel":
            return bounds.panel_counts(data, qvecs, blk, 3, 128, 100)
        return bounds.bucket_counts(data, qvecs[0], cnt * 3, cnt, cap=64, d=100)
    assert counts(128) == counts(256)


@pytest.mark.parametrize("counts,by,ms", [
    (bounds.Counts(3_350_000_000, 0), "bytes", 1.0),
    (bounds.Counts(0, 67_000_000_000), "operations", 1.0),
    (bounds.Counts(6_700_000_000, 67_000_000_000), "bytes", 2.0),
    (bounds.Counts(335_000_000, 670_000_000_000), "operations", 10.0),
])
def test_bound_takes_the_larger_time(counts, by, ms):
    got = bounds.bound(counts)
    assert got["bound_by"] == by
    assert got["bound_ms"] == pytest.approx(ms, rel=1e-12)
    assert (got["bytes"], got["flops"]) == counts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_covered_matches_a_marked_mask(seed):
    rng = np.random.default_rng(seed)
    n = 1000
    first = rng.integers(0, n, 200)
    last = np.minimum(first + rng.integers(-20, 60, 200), n)
    mask = np.zeros(n, bool)
    for a, b in zip(first, last):
        mask[a:max(a, b)] = True
    assert bounds.rows_covered(n, torch.from_numpy(first),
                               torch.from_numpy(last)) == int(mask.sum())


# -- launch shapes -----------------------------------------------------------

def _old_fused_smem(d_pad, br):
    """The previous fused kernel's footprint: the query rows, one f32
    tile of 128 x 132 and the (32, br) score panel."""
    return 4 * (32 * d_pad + 128 * 132 + 32 * br)


@pytest.mark.parametrize("d_pad", [128, 256, 512, 1024, 1152, 1280])
def test_fused_kernel_takes_every_shape_it_took(d_pad):
    took = [br for br in range(128, 8192 + 1, 128)
            if _old_fused_smem(d_pad, br) <= 227 * 1024]
    for br in took:
        assert qk.launch_shape_error(d_pad, br, topk=True) is None
    # the footprint no longer grows with the block rows
    assert qk.kernel_smem_bytes(d_pad, True) == \
        4 * 32 * d_pad + 2 * 128 * 144 + 8 * 32 * 64
    if d_pad <= 1152:
        assert qk.launch_shape_error(d_pad, 2048, topk=True) is None
        assert _old_fused_smem(d_pad, 2048) > 227 * 1024


def test_launch_shape_errors():
    assert qk.launch_shape_error(128, 512, topk=True) is None
    assert qk.launch_shape_error(128, 512, topk=False) is None
    assert "multiples" in qk.launch_shape_error(100, 512, topk=True)
    assert "multiples" in qk.launch_shape_error(128, 64, topk=False)
    assert "shared memory" in qk.launch_shape_error(1408, 512, topk=True)
    assert "block_rows" in qk.launch_shape_error(128, 8192 + 128, topk=True)
    # the raw-panel kernel's ring: two stages of 256 rows x 144 bytes and
    # 32 query rows of the same 128 bytes' features (32 f32 ones)
    assert qk.kernel_smem_bytes(128, False) == 2 * (256 * 144 + 32 * 32 * 4)
    assert qk.launch_shape_error(128, 8192 + 128, topk=False) is None


def _old_panel_smem(d_pad):
    """The previous raw-panel kernel's footprint: the 32 query rows and
    one f32 tile of 128 x 132."""
    return 4 * (32 * d_pad + 128 * 132)


@pytest.mark.parametrize("d_pad", range(128, 1280 + 1, 128))
def test_panel_kernel_takes_every_shape_it_took(d_pad):
    """Every block_rows multiple of 128 up to 8,192 at each d_pad the old
    kernel took, for every corpus dtype; the footprint grows with neither."""
    assert _old_panel_smem(d_pad) <= 227 * 1024
    for dtype, feats in ((torch.float32, 32), (torch.bfloat16, 64),
                         (torch.int8, 128)):
        assert qk.kernel_smem_bytes(d_pad, False, dtype) == \
            2 * (256 * 144 + 32 * feats * 4)
        for br in range(128, 8192 + 1, 128):
            assert qk.launch_shape_error(d_pad, br, topk=False,
                                         dtype=dtype) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_panel_shape_error_names_shared_memory_above_its_limit(monkeypatch,
                                                               dtype):
    need = qk.kernel_smem_bytes(512, False, dtype)
    monkeypatch.setattr(qk, "_SMEM_LIMIT", need - 1)
    why = qk.launch_shape_error(512, 512, topk=False, dtype=dtype)
    assert "shared memory" in why and str(need) in why
    monkeypatch.setattr(qk, "_SMEM_LIMIT", need)
    assert qk.launch_shape_error(512, 512, topk=False, dtype=dtype) is None


@pytest.mark.parametrize("d_pad", range(128, 12288 + 1, 128))
def test_bucket_kernel_takes_every_shape_it_took(d_pad):
    """The fixed-cap kernel (K5, K6) took every ``d_pad`` multiple of 128
    up to 12,288 (one f32 query row in 48 KB) at any ``1 <= cap <=
    n_rows``, for every corpus dtype, and still does: its footprint, the
    raw-panel kernel's ring and two work items' tables, grows with
    neither and two blocks of it fit one SM's 227 KB."""
    for dtype, feats in ((torch.float32, 32), (torch.bfloat16, 64),
                         (torch.int8, 128)):
        smem = qk.bucket_smem_bytes(dtype)
        assert smem == 2 * (256 * 144 + 32 * feats * 4) + 2 * 4 * (7 * 32 + 1)
        assert 2 * smem <= 227 * 1024
        for cap, n_rows in ((1, 1), (8, 4096), (200, 1800), (512, 512),
                            (1000, 2 ** 31 - 1)):
            assert qk.bucket_shape_error(d_pad, cap, n_rows, dtype) is None


def test_bucket_shape_errors(monkeypatch):
    assert "multiple" in qk.bucket_shape_error(100, 8, 64)
    assert "multiple" in qk.bucket_shape_error(0, 8, 64)
    assert "12288" in qk.bucket_shape_error(12288 + 128, 8, 64)
    assert "cap=0" in qk.bucket_shape_error(128, 0, 64)
    assert "cap=65" in qk.bucket_shape_error(128, 65, 64)
    assert "32 bits" in qk.bucket_shape_error(128, 8, 2 ** 31)
    need = qk.bucket_smem_bytes(torch.int8)
    monkeypatch.setattr(qk, "_SMEM_LIMIT", need - 1)
    why = qk.bucket_shape_error(128, 8, 64, torch.int8)
    assert "shared memory" in why and str(need) in why
    assert qk.bucket_shape_error(128, 8, 64, torch.float32) is None


@pytest.mark.parametrize("n_events,items", [(0, 0), (1, 1), (32, 1), (33, 2),
                                            (111, 4), (160000, 5000)])
def test_bucket_work_items_cover_the_events(n_events, items):
    assert qk.bucket_work_items(n_events) == items


def test_k7_wrapper_on_the_cpu_takes_one_query_panel():
    """K7's wrapper on CPU tensors: one ``(nq, d_pad)`` query panel for
    every block (the kernel reads it with a query stride of 0) gives the
    plain version's result, the panel dotted with each named block, and
    launches nothing."""
    rng = np.random.default_rng(3)
    br, d_pad, nq = 128, 256, 5
    data = rng.integers(-127, 128, (6 * br, d_pad)).astype(np.int8)
    queries = rng.integers(-16, 17, (nq, d_pad)).astype(np.float32)
    block_ids = np.array([4, 0, 4, 5, 2], np.int32)
    before = dict(qk.KERNEL_LAUNCHES)
    got = qk.int8_block_scores(torch.from_numpy(data),
                               torch.from_numpy(queries),
                               torch.from_numpy(block_ids), br)
    assert qk.KERNEL_LAUNCHES == before
    assert torch.equal(got, qk.int8_block_scores_plain(
        torch.from_numpy(data), torch.from_numpy(queries),
        torch.from_numpy(block_ids), br))
    blocks = data.reshape(-1, br, d_pad)[block_ids].astype(np.float32)
    np.testing.assert_array_equal(got.numpy(),
                                  np.einsum("qd,bkd->bqk", queries, blocks))


# -- plain K1 / K3 vs Pallas on ties across 128-row tiles --------------------

BR = 512


def _tie_block(rng):
    """One 512-row block: four exact ties at the top in four different
    tiles, two more in two tiles, the rest small noise."""
    data = (rng.normal(size=(BR, 128)) * 1e-3).astype(np.float32)
    data[:, 0] = 0.0
    data[[5, 130, 300, 450], 0] = 1.0
    data[[7, 200], 0] = 0.5
    data[[5, 130, 300, 450, 7, 200], 1:] = 0.0
    return data


@pytest.mark.parametrize("kk", [1, 6, 16])
def test_plain_k1_ties_across_tiles_take_the_lowest_lane(kk):
    data = _tie_block(np.random.default_rng(0))
    qvecs = np.zeros((8, 2, 128), np.float32)
    qvecs[..., 0] = 1.0
    cnt = np.full((8, 2), BR, np.int32)
    cnt[:, 1] = 301  # lane 450 lies past the count
    scores, lanes = qk.grouped_scores_topk(
        torch.from_numpy(data), torch.from_numpy(qvecs),
        torch.zeros(8, dtype=torch.int32), torch.from_numpy(cnt), kk,
        block_rows=BR)
    want = [5, 130, 300, 450, 7, 200][:kk]
    np.testing.assert_array_equal(lanes[0, 0].numpy()[:len(want)], want)
    want1 = [5, 130, 300, 7, 200][:kk]
    np.testing.assert_array_equal(lanes[0, 1].numpy()[:len(want1)], want1)
    packed = np.asarray(jqk._grouped_scores_topk(
        jnp.asarray(data), None, jnp.asarray(qvecs), jnp.zeros(8, jnp.int32),
        jnp.asarray(cnt), has_norms=False, interpret=True, kk=kk,
        block_rows=BR))
    np.testing.assert_array_equal(scores.numpy(), packed[..., :kk])
    np.testing.assert_array_equal(lanes.numpy(),
                                  packed[..., kk:2 * kk].astype(np.int32))


@pytest.mark.parametrize("kk", [1, 5, 16])
def test_plain_k3_ties_across_tiles_take_the_lowest_lane(kk):
    data = _tie_block(np.random.default_rng(1))
    qvecs = np.zeros((8, 2, 128), np.float32)
    qvecs[..., 0] = 1.0
    lo = np.array([[100, 0]] * 8, np.int32)   # lanes 5 and 7 below slot 0's
    hi = np.array([[460, 200]] * 8, np.int32)  # lane 200 past slot 1's
    scores, lanes = qk.windowed_scores_topk(
        torch.from_numpy(data), torch.from_numpy(qvecs),
        torch.zeros(8, dtype=torch.int32), torch.from_numpy(lo),
        torch.from_numpy(hi), kk, block_rows=BR)
    want0 = [130, 300, 450, 200][:kk]
    np.testing.assert_array_equal(lanes[0, 0].numpy()[:len(want0)], want0)
    want1 = [5, 130, 7][:kk]
    np.testing.assert_array_equal(lanes[0, 1].numpy()[:len(want1)], want1)
    packed = np.asarray(jqk._windowed_scores_topk(
        jnp.asarray(data), None, jnp.asarray(qvecs), jnp.zeros(8, jnp.int32),
        jnp.asarray(lo), jnp.asarray(hi), has_norms=False, interpret=True,
        kk=kk, block_rows=BR))
    np.testing.assert_array_equal(scores.numpy(), packed[..., :kk])
    fin = np.isfinite(packed[..., :kk])
    np.testing.assert_array_equal(
        lanes.numpy()[fin], packed[..., kk:2 * kk].astype(np.int32)[fin])
