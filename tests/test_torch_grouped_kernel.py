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
    grp_cnt[5, :6] = rng.integers(0, 10, 6)
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
