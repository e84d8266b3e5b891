"""The serving process on the card: updates, persistence, the ensemble's
fixed-cap and int8 serves, the heads and the kNN with the CUDA kernels,
each held to the kernels' plain PyTorch versions or to the same code on
the CPU.  Every test needs a CUDA GPU (``cuda`` marker) and skips
without one.  Imports no JAX, so the file also runs where JAX is not
installed:

    python -m pytest -m cuda tests/test_torch_card_serving_process.py

Tolerances: ``n_candidates``, CSR arrays and fingerprints exact; ids on
at least 0.999 of slots against the plain serve of the same engine and
0.98 against the gather engine (f32 summation order may swap near-tied
neighbours).
"""

import numpy as np
import pytest
import torch

from nlsh_tpu_torch.index import Indexer, hash_corpus
from nlsh_tpu_torch.index.indexer import hash_corpus_host
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.ops.knn import knn
from nlsh_tpu_torch.parallel import MultiTableIndexer
from nlsh_tpu_torch.utils.fingerprint import corpus_fingerprint

KW = dict(k=10, hash_times=8, probe_mode="flip")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _head(kind="MultivariateBernoulli", hash_size=7, seed=0, d=32):
    head = get_hashing(kind, get_encoder("siren", d, [64, 64]), hash_size)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * 0.15)
    return head.eval()


def _data(seed=0, n=30000, nq=400, d=32):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, d))
    pts = centers[rng.integers(0, 64, n + nq)] + 0.4 * rng.normal(
        size=(n + nq, d))
    return pts[:n].astype(np.float32), pts[n:].astype(np.float32)


def _launched(before, *names):
    return all(qk.KERNEL_LAUNCHES[n] > before[n] for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,kernel", [
    ("grouped", "grouped_scores"), ("windowed", "windowed_scores"),
    ("fixed", "bucket_scores_auto")])
def test_updates_on_the_card(cuda_device, engine, kernel):
    """A buffer and 600 tombstones (k_eff = 10 + 1,024, far above the
    fused kernels' 16 per block, and above most buckets' live rows): the
    raw-panel kernels serve it as their plain versions do."""
    corpus, queries = _data()
    n0 = 28000
    idx = Indexer(_head(), corpus[:n0], device=cuda_device, engine=engine,
                  probe_budget=512)
    idx.add(corpus[n0:])
    first, cand0 = idx.query(queries, **KW)
    dead = np.unique(np.concatenate([
        first[:, :2].ravel(),
        np.random.default_rng(1).choice(corpus.shape[0], 600)]))[:600]
    idx.remove(dead.astype(np.int32))
    before = dict(qk.KERNEL_LAUNCHES)
    ids, cand = idx.query(queries, **KW)
    assert _launched(before, kernel)
    p_ids, p_cand = idx.query(queries, plain=True, **KW)
    np.testing.assert_array_equal(cand, p_cand)
    np.testing.assert_array_equal(cand, cand0)
    assert not np.isin(ids, dead).any()
    assert (ids == p_ids).mean() >= 0.999
    idx.engine = "gather"
    g_ids, _ = idx.query(queries, **KW)
    assert (ids == g_ids).mean() >= 0.98
    idx.engine = engine
    idx.compact()
    c_ids, _ = idx.query(queries, **KW)
    assert not np.isin(c_ids, dead).any() and idx.n_fresh == 0
    cpu = Indexer(_head(), corpus[:n0], device="cpu", engine=engine,
                  probe_budget=512)
    cpu.add(corpus[n0:])
    cpu.remove(dead.astype(np.int32))
    cpu.compact()
    for name in ("row_ids", "starts", "counts"):
        assert torch.equal(getattr(idx.table, name).cpu(),
                           getattr(cpu.table, name))
    assert (c_ids == cpu.query(queries, **KW)[0]).mean() >= 0.999


@pytest.mark.cuda
def test_save_load_and_fingerprint_on_the_card(cuda_device, tmp_path):
    corpus, queries = _data(seed=2, n=20000)
    on_card = torch.as_tensor(corpus, device=cuda_device)
    assert corpus_fingerprint(on_card) == corpus_fingerprint(corpus) == \
        corpus_fingerprint(torch.from_numpy(corpus))
    head = _head(seed=2).to(cuda_device)
    np.testing.assert_array_equal(
        hash_corpus_host(head, corpus, device=cuda_device, chunk=4096),
        hash_corpus(head, on_card).cpu().numpy())
    idx = Indexer(head, on_card, device=cuda_device, probe_budget=256)
    idx.save(str(tmp_path / "idx"))
    # saved from a CUDA corpus, restored with a numpy one and on the CPU
    for device in (cuda_device, "cpu"):
        back = Indexer.load(str(tmp_path / "idx.npz"), _head(seed=2), corpus,
                            device=device)
        for name in ("row_ids", "starts", "counts"):
            assert torch.equal(getattr(back.table, name).cpu(),
                               getattr(idx.table, name).cpu())
        ids, cand = back.query(queries, **KW)
        want_ids, want_cand = idx.query(queries, **KW)
        np.testing.assert_array_equal(cand, want_cand)
        assert (ids == want_ids).mean() >= 0.999
    edited = corpus.copy()
    edited[-1] += 0.5
    with pytest.raises(ValueError, match="different corpus"):
        Indexer.load(str(tmp_path / "idx.npz"), head,
                     torch.as_tensor(edited, device=cuda_device),
                     device=cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_host_layout_on_the_card(cuda_device, dtype):
    """Dyadic corpus: the host-built layout is the card's, bit for bit."""
    rng = np.random.default_rng(3)
    corpus = (rng.integers(-16, 17, (20000, 32)) / 8.0).astype(np.float32)
    queries = rng.normal(size=(200, 32)).astype(np.float32)
    head = _head(seed=3)
    dev = Indexer(head, corpus, device=cuda_device, serving_dtype=dtype,
                  metric="euclidean", probe_budget=256)
    host = Indexer(head, corpus, device=cuda_device, serving_dtype=dtype,
                   metric="euclidean", probe_budget=256, layout_mode="host",
                   table=dev.table)
    a, b = host.layout, dev.layout
    assert a.data.device.type == "cuda" and a.data.dtype == dtype
    view = torch.int16 if dtype == torch.bfloat16 else dtype
    assert torch.equal(a.data.view(view), b.data.view(view))
    for name in ("row_map", "starts", "counts", "norms"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    if dtype == torch.int8:
        assert torch.equal(a.scale, b.scale)
    for got, want in zip(host.query(queries, **KW), dev.query(queries, **KW)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,dtype,kernel", [
    ("fixed", torch.float32, "bucket_scores_auto"),
    ("fixed", torch.int8, "bucket_scores_auto"),
    ("windowed", torch.int8, "windowed_scores_topk"),
    ("grouped", torch.int8, "grouped_scores_topk")])
def test_ensemble_engines_on_the_card(cuda_device, tmp_path, engine, dtype,
                                      kernel):
    corpus, queries = _data(seed=4, n=20000)
    heads = [_head(seed=10 + t) for t in range(3)]
    kw = dict(k=10, hash_times=3, probe_mode="flip")
    midx = MultiTableIndexer(heads, corpus, device=cuda_device, engine=engine,
                             serving_dtype=dtype)
    before = dict(qk.KERNEL_LAUNCHES)
    ids, cand = midx.query(queries, **kw)
    assert _launched(before, kernel)
    p_ids, p_cand = midx.query(queries, plain=True, **kw)
    np.testing.assert_array_equal(cand, p_cand)
    assert (ids == p_ids).mean() >= 0.999
    for row in ids:
        real = row[row >= 0]
        assert len(set(real)) == len(real)
    if dtype == torch.float32:
        midx.engine = "gather"
        assert (ids == midx.query(queries, **kw)[0]).mean() >= 0.98
        midx.engine = engine
    midx.save(str(tmp_path / "mt"))
    back = MultiTableIndexer.load(str(tmp_path / "mt.npz"), heads, corpus,
                                  device=cuda_device)
    assert back.engine == engine and back.serving_dtype == dtype
    b_ids, b_cand = back.query(queries, **kw)
    np.testing.assert_array_equal(b_cand, cand)
    np.testing.assert_array_equal(b_ids, ids)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,hash_size", [("Categorical", 128),
                                            ("ProductQuantization", 8)])
def test_heads_on_the_card(cuda_device, kind, hash_size):
    corpus, queries = _data(seed=5, n=20000)
    head = _head(kind, hash_size, seed=5)
    x = torch.from_numpy(queries)
    with torch.no_grad():
        want = head.hash(x, n_probes=16, probe_mode="flip")
        got = head.to(cuda_device).hash(x.to(cuda_device), n_probes=16,
                                        probe_mode="flip")
    # the same probes off near-ties of the probabilities
    assert (got[0].cpu() == want[0]).float().mean() >= 0.99
    assert torch.equal(got[1].cpu(), want[1])
    idx = Indexer(head, corpus, device=cuda_device, probe_budget=512)
    before = dict(qk.KERNEL_LAUNCHES)
    ids, cand = idx.query(queries, **KW)
    assert _launched(before, "grouped_scores_topk")
    idx.engine = "gather"
    g_ids, g_cand = idx.query(queries, **KW)
    np.testing.assert_array_equal(cand, g_cand)
    assert (ids == g_ids).mean() >= 0.98


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_knn_on_the_card(cuda_device, metric):
    corpus, queries = _data(seed=6, n=9000)
    d_card, i_card = knn(queries, corpus, 10, metric=metric,
                         device=cuda_device, corpus_chunk=2048)
    d_cpu, i_cpu = knn(queries, corpus, 10, metric=metric, device="cpu",
                       corpus_chunk=2048)
    assert i_card.device.type == "cuda" and i_card.dtype == torch.int32
    np.testing.assert_allclose(d_card.cpu().numpy(), d_cpu.numpy(), atol=1e-5)
    assert (i_card.cpu() == i_cpu).float().mean() >= 0.99
