"""Every kernel wrapper launches under its tensors' device.

The CUDA sources ask the runtime for the current device (its SM count
and shared-memory attributes set the persistent grid), and the wrappers
pass the stream of the tensors' device; so each wrapper makes that
device current for its checks, allocations and launch.  On the CPU:
every launching wrapper (K1-K8, and the fixed-cap launch proper) enters
``torch.cuda.device`` of its tensors' device before anything else of
its launch path runs (``torch.cuda.device`` is replaced by a recorder;
tensors on the ``meta`` device stand for a card's, let past the
CUDA-only check), and a tensor on no card is refused with the kernels'
message.  On a machine with two cards: the wrappers give their plain
versions' answers on ``cuda:1`` while ``cuda:0`` is current."""

import numpy as np
import pytest
import torch

from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.ops.cuda import build
from nlsh_tpu_torch.ops.cuda import query_kernel as qk


class _Entered(Exception):
    pass


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


G, D_PAD, BR, NQ, P, CAP = 4, 128, 128, 3, 2, 128
_I32 = torch.int32
LAUNCHES = {
    "grouped_scores_topk": lambda: qk.grouped_scores_topk(
        _meta(BR, D_PAD), _meta(2, G, D_PAD), _meta(2, dtype=_I32),
        _meta(2, G, dtype=_I32), kk=5, block_rows=BR),
    "grouped_scores": lambda: qk.grouped_scores(
        _meta(BR, D_PAD), _meta(2, G, D_PAD), _meta(2, dtype=_I32),
        block_rows=BR),
    "windowed_scores_topk": lambda: qk.windowed_scores_topk(
        _meta(BR, D_PAD), _meta(2, G, D_PAD), _meta(2, dtype=_I32),
        _meta(2, G, dtype=_I32), _meta(2, G, dtype=_I32), kk=5,
        block_rows=BR),
    "windowed_scores": lambda: qk.windowed_scores(
        _meta(BR, D_PAD), _meta(2, G, D_PAD), _meta(2, dtype=_I32),
        block_rows=BR),
    "int8_block_scores": lambda: qk.int8_block_scores(
        _meta(BR, D_PAD, dtype=torch.int8), _meta(G, D_PAD),
        _meta(2, dtype=_I32), BR),
    "panel_topk": lambda: qk.panel_topk(
        _meta(2, G, BR), _meta(2, dtype=_I32), None, _meta(2, G, dtype=_I32),
        kk=20),
    "bucket_scores_auto": lambda: qk.bucket_scores_auto(
        _meta(CAP, D_PAD), _meta(NQ, D_PAD), _meta(NQ, P, dtype=_I32),
        _meta(NQ, P, dtype=_I32), CAP),
    "bucket_scores_impl": lambda: qk.bucket_scores_impl(
        _meta(CAP, D_PAD), _meta(NQ, D_PAD), _meta(NQ, P, dtype=_I32),
        _meta(NQ, P, dtype=_I32), CAP),
    "_launch_bucket_sorted": lambda: qk._launch_bucket_sorted(
        _meta(CAP, D_PAD), _meta(NQ, D_PAD), _meta(NQ * P, dtype=_I32),
        _meta(NQ * P, dtype=_I32), _meta(NQ * P, dtype=_I32), CAP,
        "bucket_scores_auto"),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_every_launching_wrapper_enters_its_tensors_device(name,
                                                           monkeypatch):
    entered = []

    class Recorder:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            entered.append(self.device)
            raise _Entered

        def __exit__(self, *exc):
            return False

    def no_launch():
        raise AssertionError("the library was reached outside the device")

    monkeypatch.setattr(torch.cuda, "device", Recorder)
    monkeypatch.setattr(build, "load_library", no_launch)
    # let the meta tensors through the CUDA-only check
    monkeypatch.setattr(qk, "_launch_device", lambda t: t.device)
    before = dict(qk.KERNEL_LAUNCHES)
    with pytest.raises(_Entered):
        LAUNCHES[name]()
    assert entered == [torch.device("meta")]
    assert qk.KERNEL_LAUNCHES == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="run on CUDA tensors, got meta"):
        LAUNCHES[name]()


@pytest.mark.cuda
def test_wrappers_launch_on_a_device_that_is_not_current():
    """``cuda:1`` tensors served while ``cuda:0`` is current: every kernel
    engine (K1, K3, K5; K2, K4 and K8 at k = 20) answers as its plain version,
    and K6 and K7 score as theirs; the current device is left as it
    was."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(6000, 32)).astype(np.float32)
    queries = rng.normal(size=(200, 32)).astype(np.float32)
    head = get_hashing("MultivariateBernoulli", get_encoder("mlp", 32, [64]),
                       6).init(torch.Generator().manual_seed(0))
    before = dict(qk.KERNEL_LAUNCHES)
    for engine in ("grouped", "windowed", "fixed"):
        idx = Indexer(head, corpus, device=dev, engine=engine,
                      block_rows=128)
        for k in (10, 20):
            kw = dict(k=k, hash_times=4, probe_mode="flip")
            ids, cand = idx.query(queries, **kw)
            p_ids, p_cand = idx.query(queries, plain=True, **kw)
            np.testing.assert_array_equal(cand, p_cand)
            assert (ids == p_ids).mean() >= 0.999, (engine, k)
    lay = Indexer(head, corpus, device=dev, block_rows=128,
                  serving_dtype=torch.int8).layout
    qe = qk.extend_queries(lay, torch.as_tensor(queries, device=dev))
    starts = torch.arange(0, 200 * 3, 3, dtype=torch.int32,
                          device=dev).view(200, 1).repeat(1, 2)
    counts = torch.full_like(starts, lay.cap)
    torch.testing.assert_close(
        qk.bucket_scores_impl(lay.data, qe, starts, counts, lay.cap),
        qk.bucket_scores_impl_plain(lay.data, qe, starts, counts, lay.cap),
        rtol=1e-5, atol=1e-5)
    blocks = torch.arange(4, dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        qk.int8_block_scores(lay.data, qe[:32], blocks, 128),
        qk.int8_block_scores_plain(lay.data, qe[:32], blocks, 128),
        rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    assert all(qk.KERNEL_LAUNCHES[n] > before[n] for n in before)
