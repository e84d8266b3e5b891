"""K8, the per-slot top-k of the raw score panels (``qk.panel_topk``).

On the CPU: the plain version is the wide-k branch as it was composed
before K8 (scale, norms, the lane mask, ``torch.where`` and a stable
sort), bit for bit and lane for lane, on panels full of ties, signed
zeros and -inf; ``serving._panel_topk`` on CPU tensors takes the plain
version and launches nothing.

On the card (``cuda`` marker, skipped without one) K8 is held to the
plain version bit for bit on crafted panels: rows of one repeated value,
runs of ties, +0.0 beside -0.0, -inf scores, fully masked rows, dead
slots, fewer live lanes than ``kk``; ``kk`` 17, 50, 100, 200 and ``br``
(every width of the kernel's sort) at ``br`` 128, 512 and 1,024; a
per-row scale, euclidean norms and a windowed ``[lo, hi)`` mask with
``lo > 0``; then one launch captured into a CUDA graph and replayed.  The module imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_panel_topk.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nlsh_tpu_torch.index import serving
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.utils import graphs


def _panel(seed, g_total, G, br, windowed, rows):
    """A ``(g_total, G, br)`` panel whose slots cycle through crafted
    rows, with the slot bounds and, for ``rows``, a per-row scale and
    norms of ``n_blocks = 3`` blocks.  Slot kinds: normal scores,
    quarters (runs of ties), one repeated value, zeros of both signs,
    scores with -inf and +inf among them, tiny values; bounds full,
    short (< 17 live lanes), empty (hi = 0), inverted and past the
    block."""
    rng = np.random.default_rng(seed)
    n = g_total * G
    kind = np.arange(n) % 6
    x = rng.normal(size=(n, br)).astype(np.float32)
    x[kind == 1] = rng.integers(-2, 3, size=(int((kind == 1).sum()), br)) / 4
    x[kind == 2] = 0.375
    zeros = kind == 3
    x[zeros] = np.where(rng.random((int(zeros.sum()), br)) < 0.5, -0.0, 0.0)
    inf = (kind == 4)[:, None] & (rng.random((n, br)) < 0.2)
    x[inf] = -np.inf
    x[(kind == 4)[:, None] & (rng.random((n, br)) < 0.02)] = np.inf
    x[kind == 5] *= np.float32(1e-30)
    span = np.arange(n) % 5
    hi = np.select([span == 0, span == 1, span == 2, span == 3],
                   [rng.integers(br // 2, br + 1, n), rng.integers(1, 17, n),
                    np.zeros(n, np.int64), rng.integers(0, br, n)],
                   br + rng.integers(0, 40, n))
    lo = None
    if windowed:
        lo = np.where(span == 3, hi + rng.integers(0, 5, n),
                      rng.integers(0, br // 3, n))
        lo = torch.from_numpy(lo.reshape(g_total, G).astype(np.int32))
    hi = torch.from_numpy(hi.reshape(g_total, G).astype(np.int32))
    grp_block = torch.from_numpy(
        rng.integers(0, 3, g_total).astype(np.int32))
    norms = scale = None
    if rows:
        norms = torch.from_numpy(
            rng.uniform(0, 2, 3 * br).astype(np.float32))
        scale = torch.from_numpy(
            rng.uniform(0.5, 2, 3 * br).astype(np.float32))
        scale[::7] = 1.0
    scores = torch.from_numpy(x.reshape(g_total, G, br))
    return scores, grp_block, lo, hi, norms, scale


def _composed(scores, grp_block, grp_lo, grp_hi, kk, norms, scale_rows):
    """The wide-k branch as it was composed before K8."""
    br = scores.shape[2]
    blk = grp_block.long()
    if scale_rows is not None:
        scores = scores * scale_rows.view(-1, br)[blk][:, None, :]
    if norms is not None:
        scores = scores - norms.view(-1, br)[blk][:, None, :]
    lane = torch.arange(br)
    keep = lane < grp_hi[:, :, None]
    if grp_lo is not None:
        keep &= lane >= grp_lo[:, :, None]
    scores = torch.where(keep, scores, -torch.inf)
    return serving._largest_k(scores.reshape(-1, br), min(kk, br))


def _assert_bitwise(got, want):
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[0].shape == want[0].shape == got[1].shape
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].cpu().view(torch.int32))
    assert torch.equal(got[1].cpu().long(), want[1].cpu().long())


@pytest.mark.parametrize("br,kk", [(128, 17), (128, 128), (256, 100)])
@pytest.mark.parametrize("windowed,rows", [(False, False), (True, True)])
def test_plain_is_the_old_composition(br, kk, windowed, rows):
    scores, blk, lo, hi, norms, scale = _panel(br + kk, 6, 8, br, windowed,
                                               rows)
    _assert_bitwise(
        qk.panel_topk_plain(scores, blk, lo, hi, kk, norms=norms,
                            scale_rows=scale),
        _composed(scores, blk, lo, hi, kk, norms, scale))


def test_panel_topk_on_the_cpu_takes_the_plain_version():
    """``_panel_topk`` of a per-row int8 euclidean layout on CPU tensors:
    the plain version's outputs, and no kernel launch."""
    scores, blk, lo, hi, norms, scale = _panel(5, 4, 8, 128, True, True)
    layout = SimpleNamespace(br=128, norms=norms, scale=scale)
    before = dict(qk.KERNEL_LAUNCHES)
    got = serving._panel_topk(layout, scores, blk, lo, hi, 300, plain=False)
    assert qk.KERNEL_LAUNCHES == before
    _assert_bitwise(got, qk.panel_topk_plain(scores, blk, lo, hi, 128,
                                             norms=norms, scale_rows=scale))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("br", [128, 512, 1024])
@pytest.mark.parametrize("kk", [17, 50, 100, 200, None])   # None: br
@pytest.mark.parametrize("windowed,rows", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_kernel_is_the_plain_version_bitwise(cuda_device, br, kk, windowed,
                                             rows):
    kk = br if kk is None else kk
    args = [None if t is None else t.to(cuda_device)
            for t in _panel(br * 7 + kk, 12, 32, br, windowed, rows)]
    scores, blk, lo, hi, norms, scale = args
    before = qk.KERNEL_LAUNCHES["panel_topk"]
    got = qk.panel_topk(scores, blk, lo, hi, kk, norms=norms,
                        scale_rows=scale)
    assert qk.KERNEL_LAUNCHES["panel_topk"] == before + 1
    want = qk.panel_topk_plain(scores, blk, lo, hi, kk, norms=norms,
                               scale_rows=scale)
    torch.cuda.synchronize()
    _assert_bitwise(got, want)


@pytest.mark.cuda
def test_kernel_replays_in_a_captured_graph(cuda_device):
    """K8 captured (``utils.graphs.capture``) and replayed on a new
    panel: the replay gives the plain version's answer of that panel and
    counts one launch."""
    first = [None if t is None else t.to(cuda_device)
             for t in _panel(11, 16, 32, 512, False, False)]
    second = _panel(12, 16, 32, 512, False, False)
    static = (first[0], first[1], first[3])
    graph = graphs.capture(
        lambda s, b, h: qk.panel_topk(s, b, None, h, 100), static,
        cuda_device)
    assert graph.launches == {"panel_topk": 1}
    for dst, src in zip(static, (second[0], second[1], second[3])):
        dst.copy_(src)
    before = qk.KERNEL_LAUNCHES["panel_topk"]
    graph.replay()
    torch.cuda.synchronize()
    assert qk.KERNEL_LAUNCHES["panel_topk"] == before + 1
    _assert_bitwise(graph.outputs, qk.panel_topk_plain(
        second[0], second[1], None, second[3], 100))
