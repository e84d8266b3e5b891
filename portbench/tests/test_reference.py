"""The plain reference against the program at small sizes on the CPU:
the corpus's buckets, the flip probes, the candidates, the ids and the
scores of the single table and of an ensemble, at k = 10 and 100."""

import numpy as np
import pytest
import torch

from portbench import workload as wl
from portbench.reference.lsh import Reference, flip_probes, pack_bits
from portbench.tests import toy

from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.index.bucket_table import build_bucket_table
from nlsh_tpu_torch.index.indexer import hash_corpus
from nlsh_tpu_torch.index.serving import serving_query_grouped
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.parallel import MultiTableIndexer
from nlsh_tpu_torch.utils.checkpoint import (
    params_from_jax,
    stacked_params_from_jax,
    write_msgpack,
)

DEP = dict(toy.DEPLOYMENT, n_corpus=4000, n_test=96)


def _heads(tree, n_tables, bits):
    def head():
        return get_hashing("MultivariateBernoulli",
                           get_encoder("siren", 100, [32, 32]), bits)

    if n_tables == 1:
        return [params_from_jax(head(), tree)]
    return stacked_params_from_jax(head, tree)


def _setup(tmp_path, n_tables, bits, seed=3):
    tree = toy.siren_tree(np.random.default_rng(seed), 100, [32, 32], bits,
                          n_tables)
    path = tmp_path / "p.msgpack"
    write_msgpack(path, tree if n_tables == 1 else {"hashing": tree})
    dep = wl.draw_deployment(DEP)
    return str(path), _heads(tree, n_tables, bits), dep


@pytest.mark.parametrize("n_tables", [1, 3])
def test_buckets_and_probes_bitwise(tmp_path, n_tables):
    path, heads, dep = _setup(tmp_path, n_tables, 6)
    ref = Reference(path, dep.corpus, n_tables=n_tables, budget=None,
                    n_probes=8)
    x = torch.from_numpy(dep.corpus)
    q = torch.from_numpy(dep.queries)
    pid, pv = ref.probes(q)
    for t, h in enumerate(heads):
        with torch.no_grad():
            table = build_bucket_table(hash_corpus(h, x), h.n_buckets)
            ids, valid = h.hash(q, n_probes=8, probe_mode="flip")
        assert torch.equal(table.row_ids.long(),
                           ref.order[t * ref.n:(t + 1) * ref.n])
        assert torch.equal(table.counts.long(), ref.counts[t])
        assert torch.equal(table.starts.long(), ref.starts[t])
        assert torch.equal(ids.long(), pid[t])
        assert torch.equal(valid, pv[t])


def test_flip_probes_by_hand():
    # bits 0.9, 0.45, 0.7: hard code 0b101; least confident bit 1, then 2
    p = torch.tensor([[0.9, 0.45, 0.7]])
    ids, valid = flip_probes(p, 4)
    assert ids.tolist() == [[4, 5, 6, 7]] and valid.all()
    assert pack_bits(p > 0.5).tolist() == [5]


def _judge_clean(res):
    assert res["count_ok"].all()
    assert not res["foreign"].any()
    assert res["gap"].max() <= 1e-6


@pytest.mark.parametrize("k", [10, 100])
def test_single_table_answers(tmp_path, k):
    path, (head,), dep = _setup(tmp_path, 1, 6)
    ref = Reference(path, dep.corpus, n_tables=1, budget=None, n_probes=4)
    idx = Indexer(head, dep.corpus, device="cpu", metric="cosine",
                  engine="grouped")
    ids, n_cand = idx.query(dep.queries, k=k, hash_times=4,
                            probe_mode="flip")
    want_ids, want_cand = ref.answer(dep.queries, k)
    assert np.array_equal(n_cand, want_cand)
    assert all(set(a) == set(b) for a, b in zip(ids, want_ids))
    _judge_clean(ref.judge(dep.queries, ids, n_cand))
    # the scores the grouped serve ranks by are the reference's
    q = torch.from_numpy(dep.queries)
    with torch.no_grad():
        pid, pv = head.hash(q, n_probes=4, probe_mode="flip")
        got, scores, _ = serving_query_grouped(
            idx.layout, q, pid, pv, idx.table.counts, k=k)
    dense, _, _ = ref.candidates(q)
    want = torch.topk(ref._scores(ref._qn(q), dense), k, dim=1).values
    assert torch.allclose(scores, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("k", [10, 100])
def test_ensemble_answers(tmp_path, k):
    path, heads, dep = _setup(tmp_path, 3, 6)
    ref = Reference(path, dep.corpus, n_tables=3, budget=None, n_probes=2)
    midx = MultiTableIndexer(heads, dep.corpus, device="cpu",
                             metric="cosine", engine="windowed")
    midx.calibrate(dep.queries, hash_times=2, probe_mode="flip")
    ids, n_cand = midx.query(dep.queries, k=k, hash_times=2,
                             probe_mode="flip")
    want_ids, want_cand = ref.answer(dep.queries, k)
    assert np.array_equal(n_cand, want_cand)
    assert all(set(a) == set(b) for a, b in zip(ids, want_ids))
    _judge_clean(ref.judge(dep.queries, ids, n_cand))
    # distinct candidates: the ensemble's own exact count
    _, n_distinct, _ = ref.candidates(torch.from_numpy(dep.queries))
    assert np.array_equal(
        midx.exact_query_size(dep.queries, hash_times=2, probe_mode="flip"),
        n_distinct.numpy())


def test_budget_truncates_like_the_program(tmp_path):
    # 2 bits: four buckets of about 1,000 rows, served 512 at most
    path, (head,), dep = _setup(tmp_path, 1, 2, seed=5)
    ref = Reference(path, dep.corpus, n_tables=1, budget=512, n_probes=2)
    assert ref.counts.max() > 512
    idx = Indexer(head, dep.corpus, device="cpu", metric="cosine",
                  probe_budget=512, engine="grouped")
    ids, n_cand = idx.query(dep.queries, k=10, hash_times=2,
                            probe_mode="flip")
    _judge_clean(ref.judge(dep.queries, ids, n_cand))
    unbounded = Reference(path, dep.corpus, n_tables=1, budget=None,
                          n_probes=2)
    assert unbounded.judge(dep.queries, ids, n_cand)["foreign"].sum() == 0
    assert ref.work(dep.queries)[0] < unbounded.work(dep.queries)[0]


def test_judge_reads_a_wrong_answer(tmp_path):
    path, (head,), dep = _setup(tmp_path, 1, 6)
    ref = Reference(path, dep.corpus, n_tables=1, budget=None, n_probes=4)
    ids, n_cand = ref.answer(dep.queries, 10)
    _judge_clean(ref.judge(dep.queries, ids, n_cand))
    bad = ids.copy()
    bad[0, 1] = bad[0, 0]            # a repeat
    far = np.argmin(dep.corpus @ dep.queries[1])
    bad[1, 0] = far                  # a foreign, far row
    res = ref.judge(dep.queries, bad, n_cand + np.eye(1, len(n_cand), 2,
                                                      dtype=n_cand.dtype)[0])
    assert res["foreign"][:2].tolist() == [1, 1]
    assert res["gap"][0] > 1e-3 and res["gap"][1] > 1e-3
    assert not res["count_ok"][2] and res["count_ok"][[0, 1, 3]].all()


def test_tf32_control_moves_buckets(tmp_path):
    path, _, dep = _setup(tmp_path, 1, 6)
    f32 = Reference(path, dep.corpus, n_tables=1, budget=None, n_probes=4)
    tf32 = Reference(path, dep.corpus, n_tables=1, budget=None, n_probes=4,
                     precision="tf32")
    assert (f32.order != tf32.order).any()
    ids, n_cand = tf32.answer(dep.queries, 10)
    assert not f32.judge(dep.queries, ids, n_cand)["count_ok"].all()
