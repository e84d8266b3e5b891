"""``correct`` decided as in the benchmark's runs: a sound run of the
toy cells reads true; the control (the reference in TF32 in the
program's place) and each fault a serving cell on one card can have,
planted under the timed path, read false.  The faults: a system that
answers every batch as it answered the first (its state unchanged), one
that answers the first half of each batch and leaves out the rest, and
one whose answer is altered where it is produced.  (A cell on one card
has no exchange between cards to leave out.)"""

import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import control, run
from portbench.systems.nlsh_index import System
from portbench.tests import toy

CONFIGS = {"single": toy.config(), "ensemble": toy.config(3, 2)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def root(request, tmp_path_factory):
    return toy.make_root(str(tmp_path_factory.mktemp(request.param)),
                         CONFIGS[request.param])


def _run(root, factory=None, seed=11):
    return run.run_cell(root, toy.CELL, seed, 0.3, False, device="cpu",
                        cache_dir=None, system_factory=factory)


def test_sound_run_is_correct(root):
    res = _run(root)
    assert res["correct"] and res["attempted"] > 4
    assert list(res)[-1] == "checks"
    assert res["checks"]["cand_mismatch_share"]["value"] == 0.0


def test_control_is_not_correct(root):
    res = control.control_run(root, toy.CELL, 11, 0.3, device="cpu",
                              cache_dir=None)
    assert not res["correct"]
    assert res["checks"]["cand_mismatch_share"]["value"] > 0.1


class Stale(System):
    """Answers every batch as it answered the first."""

    def fetch(self, pending):
        if not hasattr(self, "first"):
            self.first = super().fetch(pending)
        return self.first


class Half(System):
    """Serves the first half of each batch, leaves the rest out."""

    def submit(self, queries, k):
        half = queries.shape[0] // 2
        return super().submit(queries[:half], k), queries.shape[0] - half, k

    def fetch(self, pending):
        pending, pad, k = pending
        ids, n_cand = super().fetch(pending)
        return (np.concatenate([ids, np.full((pad, k), -1, ids.dtype)]),
                np.concatenate([n_cand, np.zeros(pad, n_cand.dtype)]))


class Altered(System):
    """Every batch's first answer takes the corpus row farthest from its
    query in place of its best id."""

    def __init__(self, cfg, params, corpus, queries, device):
        super().__init__(cfg, params, corpus, queries, device)
        self.corpus = corpus

    def submit(self, queries, k):
        self.first = queries[0]
        return super().submit(queries, k)

    def fetch(self, pending):
        ids, n_cand = super().fetch(pending)
        ids = ids.copy()
        ids[0, 0] = np.argmin(self.corpus @ self.first)
        return ids, n_cand


class TailHash(System):
    """Hashes the last query of each batch from a wrong input (its
    negation): its probes, candidates and count are another query's, as
    a hash kernel that mishandles a batch's last partial tile would
    make them."""

    def submit(self, queries, k):
        queries = queries.copy()
        queries[-1] = -queries[-1]
        return super().submit(queries, k)


class ForeignBest(System):
    """Puts in each answer's last slot the best-scoring corpus row that
    the answer does not hold: a row from outside the query's probed
    buckets that scores above the answer's ``k``-th, as a scoring window
    that reads into a neighbouring bucket would return it.  Counts stay
    as served, and every score gap reads 0 or below."""

    def __init__(self, cfg, params, corpus, queries, device):
        super().__init__(cfg, params, corpus, queries, device)
        self.corpus = corpus

    def submit(self, queries, k):
        self.queries = queries
        return super().submit(queries, k)

    def fetch(self, pending):
        ids, n_cand = super().fetch(pending)
        ids = ids.copy()
        best = np.argsort(-(self.queries @ self.corpus.T), axis=1)
        for q in range(ids.shape[0]):
            ids[q, -1] = next(r for r in best[q] if r not in ids[q])
        return ids, n_cand


@pytest.mark.parametrize("fault", [Stale, Half, Altered],
                         ids=lambda f: f.__name__)
def test_faults_are_not_correct(root, fault):
    res = _run(root, fault)
    assert not res["correct"], res["checks"]


def test_a_wrong_hash_of_one_query_a_batch_is_caught(root):
    """One query in 64 (1.6%) with a wrong hash: the count check fails
    it, as it fails more than 10 such queries in each of the cells'
    10,000-query batches."""
    checks = _run(root, TailHash)["checks"]
    mismatch = checks["cand_mismatch_share"]
    assert mismatch["value"] > mismatch["limit"], checks


def test_a_foreign_id_that_scores_high_is_caught(root):
    """The score gap cannot see a foreign id that beats the reference's
    ``k``-th; the foreign-id count on the queries whose count agrees
    does."""
    checks = _run(root, ForeignBest)["checks"]
    assert checks["cand_mismatch_share"]["value"] == 0.0
    foreign = checks["foreign_id_share"]
    assert foreign["value"] > foreign["limit"], checks


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "glove100-mvb12.b10k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=toy.REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


@pytest.mark.cuda
def test_toy_cell_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = toy.make_root(str(tmp_path))
    res = run.run_cell(root, toy.CELL, 11, 1.0, True, cache_dir=None)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
