"""K1 and K2, the grouped scoring kernels.

The plain PyTorch versions are held to the JAX package's Pallas kernels
(``_grouped_scores_topk`` / ``_grouped_scores_v3``, interpret mode):
scores within 1e-5 (unit-scale f32 dots in another summation order),
lanes equal wherever the score is finite.  The CUDA kernels are held to
the plain versions on the card by the same tolerance; those tests carry
the ``cuda`` marker and skip where ``torch.cuda.is_available()`` is
false (on the card: ``python -m pytest -m cuda tests/test_torch_*.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.ops.pallas import query_kernel as jqk
from nlsh_tpu_torch.ops.cuda import query_kernel as qk

def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _case(seed=0, g_total=16, G=32, br=128, d_pad=128, n_blocks=6,
          dtype="float32"):
    """Synthetic groups with empty groups and counts below kk.  For
    ``dtype="int8"`` the rows are quantised per row, ``scale`` is their
    dequantisation scale and the queries are small dyadic values, so
    every dot sums exactly in f32."""
    rng = np.random.default_rng(seed)
    data = _unit(rng, (n_blocks * br, d_pad))
    qvecs = _unit(rng, (g_total, G, d_pad))
    int8_scale = None
    if dtype == "int8":
        int8_scale = np.abs(data).max(axis=1) / np.float32(127.0)
        data = np.clip(np.round(data / int8_scale[:, None]), -127,
                       127).astype(np.int8)
        qvecs = (rng.integers(-16, 17, qvecs.shape) / 64.0).astype(np.float32)
    grp_block = rng.integers(0, n_blocks, g_total).astype(np.int32)
    grp_cnt = rng.integers(0, br + 1, (g_total, G)).astype(np.int32)
    grp_cnt[3] = 0
    grp_cnt[5, :6] = rng.integers(0, 10, min(G, 6))
    norms = rng.uniform(0.5, 1.5, n_blocks * br).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, n_blocks * br).astype(np.float32)
    if int8_scale is not None:
        scale = int8_scale.astype(np.float32)
    return data, qvecs, grp_block, grp_cnt, norms, scale


@pytest.mark.parametrize("kk", [10, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("has_norms,has_scale", [(False, False), (True, True)])
def test_plain_k1_matches_pallas(kk, dtype, has_norms, has_scale):
    data, qvecs, grp_block, grp_cnt, norms, scale = _case(dtype=dtype)
    br = 128
    j_data = jnp.asarray(data).astype(jnp.dtype(dtype))
    packed = np.asarray(jqk._grouped_scores_topk(
        j_data, jnp.asarray(norms), jnp.asarray(qvecs), jnp.asarray(grp_block),
        jnp.asarray(grp_cnt), has_norms=has_norms, interpret=True, kk=kk,
        block_rows=br, scale_rows=jnp.asarray(scale), has_scale=has_scale))
    j_scores, j_lanes = packed[..., :kk], packed[..., kk:2 * kk].astype(np.int32)
    t_data = torch.from_numpy(data).to(getattr(torch, dtype))
    scores, lanes = qk.grouped_scores_topk(
        t_data, torch.from_numpy(qvecs), torch.from_numpy(grp_block),
        torch.from_numpy(grp_cnt), kk, block_rows=br,
        norms=torch.from_numpy(norms) if has_norms else None,
        scale_rows=torch.from_numpy(scale) if has_scale else None)
    scores, lanes = scores.numpy(), lanes.numpy()
    assert scores.shape == lanes.shape == (16, 32, kk)
    fin = np.isfinite(j_scores)
    np.testing.assert_array_equal(np.isfinite(scores), fin)
    np.testing.assert_allclose(scores[fin], j_scores[fin], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(lanes[fin], j_lanes[fin])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plain_k2_matches_pallas(dtype):
    data, qvecs, grp_block, _, _, _ = _case(seed=1, dtype=dtype)
    j_data = jnp.asarray(data).astype(jnp.dtype(dtype))
    want = np.asarray(jqk._grouped_scores_v3(
        j_data, jnp.asarray(qvecs), jnp.asarray(grp_block), interpret=True,
        block_rows=128))
    got = qk.grouped_scores(torch.from_numpy(data).to(getattr(torch, dtype)),
                            torch.from_numpy(qvecs), torch.from_numpy(grp_block),
                            block_rows=128)
    assert got.shape == (16, 32, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_plain_k1_ties_take_the_lowest_lane():
    """The Pallas kernel's rule: among equal scores the lowest lane is
    taken first."""
    br = 128
    data = np.zeros((br, 128), np.float32)
    data[[3, 7, 9, 40], 0] = 1.0   # four exact ties at the top
    data[[2, 50], 0] = 0.5
    qvecs = np.zeros((8, 1, 128), np.float32)
    qvecs[..., 0] = 1.0
    cnt = np.full((8, 1), br, np.int32)
    scores, lanes = qk.grouped_scores_topk(
        torch.from_numpy(data), torch.from_numpy(qvecs),
        torch.zeros(8, dtype=torch.int32), torch.from_numpy(cnt), 6,
        block_rows=br)
    np.testing.assert_array_equal(lanes[0].numpy()[0], [3, 7, 9, 40, 2, 50])
    packed = np.asarray(jqk._grouped_scores_topk(
        jnp.asarray(data), None, jnp.asarray(qvecs), jnp.zeros(8, jnp.int32),
        jnp.asarray(cnt), has_norms=False, interpret=True, kk=6, block_rows=br))
    np.testing.assert_array_equal(lanes.numpy(), packed[..., 6:12].astype(np.int32))
    np.testing.assert_array_equal(scores.numpy(), packed[..., :6])


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    data, qvecs, grp_block, grp_cnt, _, _ = _case(seed=2, g_total=8)
    before = dict(qk.KERNEL_LAUNCHES)
    args = [torch.from_numpy(a) for a in (data, qvecs, grp_block)]
    s, ln = qk.grouped_scores_topk(*args, torch.from_numpy(grp_cnt), 10,
                                   block_rows=128)
    ps, pl_ = qk.grouped_scores_topk_plain(*args, torch.from_numpy(grp_cnt),
                                           10, block_rows=128)
    assert torch.equal(s, ps) and torch.equal(ln, pl_)
    assert qk.KERNEL_LAUNCHES == before  # the plain version is no launch
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        qk.grouped_scores(*meta, block_rows=128)


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
def test_k1_kernel_matches_plain(cuda_device, dtype, kk, extras, G, d_pad):
    data, qvecs, grp_block, grp_cnt, norms, scale = _case(
        seed=3, g_total=64, G=G, br=512, d_pad=d_pad, n_blocks=8,
        dtype=str(dtype).split(".")[1])
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (data, qvecs, grp_block, grp_cnt, norms, scale)]
    t[0] = t[0].to(dtype)
    kw = dict(block_rows=512, norms=t[4] if extras else None,
              scale_rows=t[5] if extras else None)
    before = qk.KERNEL_LAUNCHES["grouped_scores_topk"]
    s, ln = qk.grouped_scores_topk(*t[:4], kk, **kw)
    assert qk.KERNEL_LAUNCHES["grouped_scores_topk"] == before + 1
    ps, pln = qk.grouped_scores_topk_plain(*t[:4], kk, **kw)
    fin = torch.isfinite(ps)
    assert torch.equal(torch.isfinite(s), fin)
    assert float((s - ps)[fin].abs().max()) <= 1e-5
    assert torch.equal(ln[fin], pln[fin])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("G,d_pad", [(32, 128), (8, 256)])
def test_k2_kernel_matches_plain(cuda_device, dtype, G, d_pad):
    data, qvecs, grp_block, _, _, _ = _case(seed=4, g_total=64, G=G, br=512,
                                            d_pad=d_pad, n_blocks=8,
                                            dtype=str(dtype).split(".")[1])
    t = [torch.from_numpy(a).to(cuda_device) for a in (data, qvecs, grp_block)]
    t[0] = t[0].to(dtype)
    got = qk.grouped_scores(*t, block_rows=512)
    want = qk.grouped_scores_plain(*t, block_rows=512)
    assert float((got - want).abs().max()) <= 1e-5


# -- the raw-panel kernel's edge cases, on the card --------------------------

def _k2_on_card(dev, data, qvecs, grp_block, br):
    """K2 and its plain version on the card; the kernel must launch once
    and keep the plain version's panel within 1e-5.  Returns the
    kernel's panel."""
    t = [torch.as_tensor(a).to(dev) for a in (data, qvecs, grp_block)]
    before = qk.KERNEL_LAUNCHES["grouped_scores"]
    got = qk.grouped_scores(*t, block_rows=br)
    assert qk.KERNEL_LAUNCHES["grouped_scores"] == before + 1
    want = qk.grouped_scores_plain(*t, block_rows=br)
    assert got.shape == want.shape == (t[1].shape[0], t[1].shape[1], br)
    assert float((got - want).abs().max()) <= 1e-5
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("G", [1, 8, 13, 32])
@pytest.mark.parametrize("br,d_pad", [(128, 128), (512, 128), (8192, 128),
                                     (512, 1280)])
def test_k2_kernel_shapes(cuda_device, dtype, G, br, d_pad):
    """Group widths below one 16-slot warp (1, 8), inside the second (13)
    and full; one 128-row tile (half of the kernel's 256), the serving
    512, the most rows (8,192) and the most features (1,280)."""
    data, qvecs, grp_block, _, _, _ = _case(
        seed=12, g_total=24, G=G, br=br, d_pad=d_pad, n_blocks=3,
        dtype=str(dtype).split(".")[1])
    _k2_on_card(cuda_device, torch.from_numpy(data).to(dtype), qvecs,
                grp_block, br)


@pytest.mark.cuda
def test_k2_kernel_more_groups_than_its_grid(cuda_device):
    """A group table several times the persistent grid (resident blocks
    per SM x SMs), so each block walks many groups."""
    per_sm = qk.panel_blocks_per_sm(torch.float32, 128)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert per_sm >= 1
    g_total = 3 * per_sm * sms + 37
    data, qvecs, grp_block, _, _, _ = _case(seed=13, g_total=g_total,
                                            br=256, n_blocks=32)
    _k2_on_card(cuda_device, data, qvecs, grp_block, 256)


@pytest.mark.cuda
def test_k2_kernel_writes_every_entry_of_a_dead_table(cuda_device):
    """A table of only dead groups (block 0, zero queries, as the prep
    leaves the groups past the live ones): every entry is written, here
    into memory the caching allocator last held filled with NaN."""
    g_total, G, br = 64, 32, 512
    data = _unit(np.random.default_rng(14), (8 * br, 128))
    poison = torch.full((g_total, G, br), torch.nan, device=cuda_device)
    del poison
    got = _k2_on_card(cuda_device, data, np.zeros((g_total, G, 128), np.float32),
                      np.zeros(g_total, np.int32), br)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
def test_k2_kernel_scores_a_block_the_same_in_every_group(cuda_device):
    """One block named by many groups that are not neighbours (every
    third group of a table longer than the grid), with the same queries:
    the same panel, bit for bit, in each."""
    per_sm = qk.panel_blocks_per_sm(torch.float32, 128)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    g_total = per_sm * sms + 95
    rng = np.random.default_rng(15)
    data = _unit(rng, (6 * 512, 128))
    qvecs = np.repeat(_unit(rng, (1, 32, 128)), g_total, axis=0)
    grp_block = (np.arange(g_total) % 5 + 1).astype(np.int32)
    grp_block[::3] = 0
    got = _k2_on_card(cuda_device, data, qvecs, grp_block, 512)
    same = got[::3]
    assert torch.equal(same, same[:1].expand_as(same))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_k2_panel_is_k1s_scores_bitwise(cuda_device, dtype):
    """K2's panel at K1's lanes is K1's kept scores, bit for bit (no
    norms or scale): both run one FMA chain per (slot, row) over the
    features in order."""
    data, qvecs, grp_block, grp_cnt, _, _ = _case(
        seed=16, g_total=64, br=512, n_blocks=8,
        dtype=str(dtype).split(".")[1])
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (data, qvecs, grp_block, grp_cnt)]
    t[0] = t[0].to(dtype)
    panel = qk.grouped_scores(*t[:3], block_rows=512)
    s, ln = qk.grouped_scores_topk(*t, qk.ROW_TOPK, block_rows=512)
    fin = torch.isfinite(s)
    assert fin.any()
    assert torch.equal(panel.gather(2, ln.long())[fin], s[fin])


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device):
    data, qvecs, grp_block, grp_cnt, _, _ = _case(seed=5, g_total=8)
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (data, qvecs, grp_block, grp_cnt)]
    with pytest.raises(ValueError, match="dtype"):
        qk.grouped_scores(t[0].to(torch.float16), *t[1:3], block_rows=128)
    with pytest.raises(ValueError, match="multiples"):
        qk.grouped_scores(*t[:3], block_rows=64)
    with pytest.raises(ValueError, match="contiguous"):
        qk.grouped_scores_topk(*t[:3], t[3].T.contiguous().T, 10,
                               block_rows=128)


# -- the fused kernel's edge cases, on the card ------------------------------

def _k1_on_card(dev, data, qvecs, grp_block, grp_cnt, kk, br, **extra):
    """K1 and its plain version on the card; the kernel must launch once,
    keep the plain version's -inf pattern and scores (1e-5) and its lanes
    wherever the score is finite.  Returns the kernel's output."""
    t = [torch.as_tensor(a).to(dev) for a in (data, qvecs, grp_block, grp_cnt)]
    kw = dict(block_rows=br, **{k: torch.as_tensor(v).to(dev)
                                for k, v in extra.items()})
    before = qk.KERNEL_LAUNCHES["grouped_scores_topk"]
    s, ln = qk.grouped_scores_topk(*t, kk, **kw)
    assert qk.KERNEL_LAUNCHES["grouped_scores_topk"] == before + 1
    ps, pln = qk.grouped_scores_topk_plain(*t, kk, **kw)
    fin = torch.isfinite(ps)
    assert torch.equal(torch.isfinite(s), fin)
    if fin.any():
        assert float((s - ps)[fin].abs().max()) <= 1e-5
    assert torch.equal(ln[fin], pln[fin])
    assert bool(((ln >= 0) & (ln < br)).all())
    return s, ln


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("kk", [1, 16])
@pytest.mark.parametrize("G", [13, 32])
@pytest.mark.parametrize("br,d_pad", [(1024, 256), (2048, 128), (8192, 128),
                                     (512, 1280), (1024, 1280)])
def test_k1_kernel_shapes(cuda_device, dtype, kk, G, br, d_pad):
    """kk at both ends, a partial group width, 1024-row blocks of 256
    features, and the shapes the new footprint admits past what a (G, br)
    score panel in shared memory allowed: 2048 and 8192 (the most) rows
    of 128 features, and 1280 features (the most) at 512 and 1024 rows."""
    data, qvecs, grp_block, grp_cnt, norms, scale = _case(
        seed=6, g_total=40, G=G, br=br, d_pad=d_pad, n_blocks=4,
        dtype=str(dtype).split(".")[1])
    _k1_on_card(cuda_device, torch.from_numpy(data).to(dtype), qvecs,
                grp_block, grp_cnt, kk, br, norms=norms, scale_rows=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [1, 16])
def test_k1_kernel_ties_across_tiles(cuda_device, kk):
    """Exact ties in different 128-row tiles of a 512-row block (and the
    many exact zeros after them): the lower lane first, across tiles."""
    br = 512
    rng = np.random.default_rng(7)
    data = np.zeros((2 * br, 128), np.float32)
    data[:, 1:] = rng.normal(size=(2 * br, 127)) * 1e-3
    for blk in range(2):
        data[blk * br + np.array([5, 130, 300, 450]), 0] = 1.0
        data[blk * br + np.array([7, 200, 511]), 0] = 0.5
    qvecs = np.zeros((16, 32, 128), np.float32)
    qvecs[..., 0] = 1.0
    grp_block = np.arange(16, dtype=np.int32) % 2
    grp_cnt = np.full((16, 32), br, np.int32)
    grp_cnt[:, 1] = 301
    s, ln = _k1_on_card(cuda_device, data, qvecs, grp_block, grp_cnt, kk, br)
    want = np.array([5, 130, 300, 450, 7, 200, 511])[:kk]
    assert (ln[:, 0, :len(want)].cpu().numpy() == want).all()
    want1 = np.array([5, 130, 300, 7, 200])[:kk]
    assert (ln[:, 1, :len(want1)].cpu().numpy() == want1).all()


@pytest.mark.cuda
def test_k1_kernel_scores_a_row_the_same_wherever_it_sits(cuda_device):
    """One corpus row at lane 3 of block 0, 129 of block 1 and 400 of
    block 2 scores bit-identically in each (f32, with norms)."""
    br = 512
    rng = np.random.default_rng(8)
    data = _unit(rng, (3 * br, 128)) * 0.5
    row = _unit(rng, (128,))
    data[[3, br + 129, 2 * br + 400]] = row
    qvecs = np.repeat(_unit(rng, (1, 32, 128)), 3, axis=0)
    qvecs[:, 0] = row
    norms = np.full(3 * br, 0.25, np.float32)
    s, ln = _k1_on_card(cuda_device, data, qvecs,
                        np.arange(3, dtype=np.int32),
                        np.full((3, 32), br, np.int32), 4, br, norms=norms)
    assert ln[:, 0, 0].tolist() == [3, 129, 400]
    assert s[0, 0, 0] == s[1, 0, 0] == s[2, 0, 0]


@pytest.mark.cuda
def test_k1_kernel_more_groups_than_its_grid(cuda_device):
    """A group table several times the persistent grid (resident blocks
    per SM x SMs), with dead groups among the live ones."""
    per_sm = qk.topk_blocks_per_sm(torch.float32, 128, windowed=False)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert per_sm >= 2
    g_total = 3 * per_sm * sms + 37
    data, qvecs, grp_block, grp_cnt, norms, _ = _case(
        seed=9, g_total=g_total, br=256, n_blocks=32)
    grp_cnt[::11] = 0
    _k1_on_card(cuda_device, data, qvecs, grp_block, grp_cnt, 10, 256,
                norms=norms)


@pytest.mark.cuda
def test_k1_kernel_all_dead_groups(cuda_device):
    data, qvecs, grp_block, grp_cnt, _, _ = _case(seed=10, g_total=64,
                                                  br=512, n_blocks=8)
    s, _ = _k1_on_card(cuda_device, data, qvecs, grp_block,
                       np.zeros_like(grp_cnt), 10, 512)
    assert bool(torch.isneginf(s).all())


@pytest.mark.cuda
def test_phase_build_gives_the_kernels_output(cuda_device):
    """The fused kernel built with its phase counters
    (``nlsh_tpu_torch.tools.topk_phases``) gives K1's and K3's output
    bitwise, counts cycles in phases that sum to no more than all the
    warps' cycles, and runs with the per-tile selection skipped."""
    from nlsh_tpu_torch.tools import topk_phases

    lib = topk_phases.build_library()
    data, qvecs, grp_block, grp_cnt, norms, _ = _case(
        seed=11, g_total=64, br=512, n_blocks=8)
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (data, qvecs, grp_block, grp_cnt, norms)]
    lo = (t[3] // 3).contiguous()
    topk_phases.read_phases(lib)
    for kk in (1, 10):
        want = qk.grouped_scores_topk(*t[:4], kk, block_rows=512, norms=t[4])
        got = topk_phases.launch(lib, *t[:3], None, t[3], kk, 512, norms=t[4])
        want3 = qk.windowed_scores_topk(*t[:3], lo, t[3], kk, block_rows=512)
        got3 = topk_phases.launch(lib, *t[:3], lo, t[3], kk, 512)
        for (s, ln), (ws, wln) in ((got, want), (got3, want3)):
            fin = torch.isfinite(ws)
            assert torch.equal(s, ws)
            assert torch.equal(ln[fin], wln[fin])
    cycles = topk_phases.read_phases(lib, skip_select=True)
    assert cycles["all"] > 0 and cycles["compute"] > 0 and cycles["select"] > 0
    assert sum(cycles[k] for k in topk_phases.PHASES) <= cycles["all"]
    topk_phases.launch(lib, *t[:3], None, t[3], 10, 512)
    skipped = topk_phases.read_phases(lib)
    assert 0 < skipped["all"]
    assert 0 <= topk_phases.shares(skipped)["other"] < 1
