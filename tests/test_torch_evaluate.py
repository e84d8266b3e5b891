"""The port's multi-probe sweep (``nlsh_tpu_torch.cli.evaluate``) against
``nlsh_tpu.cli.evaluate`` in flip mode on the gather and grouped engines,
on the CPU, and the sweep's probes.

One seeded JAX head, carried into the port by ``params_from_jax``, over
a small synthetic corpus (the JAX package's Pallas engines run in
interpret mode).  Each row's ``avg_n_candidates`` must be equal and
``recall`` within 1e-6; the flip enumeration is the JAX package's and
the head's own, bit for bit; ``sample_probe_codes`` is ``uniform < p``
on injected uniforms; per-query recall is the JAX package's bit for
bit; asking for the card without one raises.  The fixed-cap and
windowed engines are in ``test_torch_evaluate_flip.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.cli import evaluate as jeval
from nlsh_tpu.utils.metrics import recall_matrix as j_recall_matrix
from nlsh_tpu_torch.cli import evaluate as teval
from nlsh_tpu_torch.ops import packing
from nlsh_tpu_torch.utils.metrics import recall_matrix
from torch_eval_common import ENGINES, MAX_PROBES, assert_rows_match, small_case


@pytest.fixture(scope="module")
def case():
    return small_case()


@pytest.mark.parametrize("jax_engine", ["xla", "pallas-grouped"])
def test_flip_sweep_matches_the_jax_package(case, jax_engine):
    data, jh, params, th = case
    want = jeval.run_sweep(
        jh, params, jnp.asarray(data.training), jnp.asarray(data.testing),
        np.asarray(data.ground_truth), k=10, max_probes=MAX_PROBES,
        engine=jax_engine, probe_mode="flip")
    got = teval.run_sweep(th, data.training, data.testing, data.ground_truth,
                          10, max_probes=MAX_PROBES,
                          engine=ENGINES[jax_engine], probe_mode="flip",
                          device="cpu")
    assert_rows_match(got, want)
    cands = [r["avg_n_candidates"] for r in got]
    assert cands == sorted(cands) and cands[-1] > cands[0]


def test_flip_probes_are_the_jax_package_s_and_the_head_s(case):
    data, jh, params, th = case
    q = torch.from_numpy(np.asarray(data.testing))
    for n in (1, 2, 5, 8, 64, 300):   # n_flip 1..7; 300 > 2**7 flips all
        got = teval.sample_probe_codes(th, q, n, probe_mode="flip")
        want = jeval.sample_probe_codes(jh, params, jnp.asarray(q.numpy()),
                                        n, None, probe_mode="flip")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the head's _hash_flip is the same enumeration, deduped
        with torch.no_grad():
            ids, valid = th.hash(q, n_probes=n, probe_mode="flip")
        s_ids, s_valid = packing.dedupe_codes(got)
        assert torch.equal(ids, s_ids) and torch.equal(valid, s_valid)


class _Probs:
    """A head whose probabilities are its input."""
    hash_size = 5

    def probs(self, *args):
        return args[-1]


def test_flip_keeps_the_lowest_bit_among_equal_confidences():
    """Bits whose sigmoid saturates at exactly 0 or 1 tie at confidence
    0.5; like ``lax.top_k`` the lowest bit index is flipped first."""
    p = torch.tensor([[1.0, 0.0, 1.0, 0.0, 0.9],
                      [0.5, 1.0, 0.0, 0.5, 0.0]])
    got = teval.sample_probe_codes(_Probs(), p, 4, probe_mode="flip")
    want = jeval.sample_probe_codes(_Probs(), None, jnp.asarray(p.numpy()),
                                    4, None, probe_mode="flip")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # row 0: hard code 10101 = 21; the least confident bit is bit 4
    # (0.4 from 0.5), then bit 0, the lowest of the saturated ones
    assert got[0].tolist() == [21, 20, 5, 4]


def test_sampled_probes_are_uniforms_below_p(case):
    data, _, _, th = case
    q = torch.from_numpy(np.asarray(data.testing))
    u = torch.rand((q.shape[0], 9, 7), generator=torch.Generator().manual_seed(3))
    got = teval.sample_probe_codes(th, q, 10, uniforms=u)
    with torch.no_grad():
        p = th.probs(q)
    assert torch.equal(got[:, 0], packing.pack_bits((p > 0.5).to(torch.int32)))
    assert torch.equal(got[:, 1:], packing.pack_bits(
        (u < p[:, None, :]).to(torch.int32)))
    # from a generator in the same state: the same uniforms, the same probes
    drawn = teval.sample_probe_codes(th, q, 10,
                                     torch.Generator().manual_seed(3))
    assert torch.equal(drawn, got)
    with pytest.raises(ValueError, match="probe_mode"):
        teval.sample_probe_codes(th, q, 10, probe_mode="best")


@pytest.mark.parametrize("k", [1, 3, 7, 10, 20, 100])
def test_per_query_recall_is_the_jax_package_s_bit_for_bit(k):
    """XLA divides the hit count by multiplying with the f32 reciprocal
    of k; 9 / 10 would round one ulp lower than 9 * 0.1."""
    truth = np.tile(np.arange(k), (k + 1, 1))
    pred = truth.copy()
    for i in range(k + 1):
        pred[i, :i] = -1
    want = np.asarray(j_recall_matrix(jnp.asarray(truth), jnp.asarray(pred)))
    got = recall_matrix(torch.from_numpy(truth), torch.from_numpy(pred))
    np.testing.assert_array_equal(got.numpy(), want)


def test_auto_engine_and_the_card():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert teval.resolve_engine("auto", cpu, "cosine") == "gather"
    assert teval.resolve_engine("auto", cuda, "cosine") == "fixed"
    assert teval.resolve_engine("auto", cuda, "euclidean") == "fixed"
    assert teval.resolve_engine("auto", cuda, "dot") == "gather"
    for theirs, ours in ENGINES.items():
        assert teval.resolve_engine(theirs, cuda, "dot") == ours
        assert teval.resolve_engine(ours, cpu, "cosine") == ours
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            teval.run_sweep(None, np.zeros((4, 2)), np.zeros((1, 2)),
                            np.zeros((1, 1)), 1, device="cuda")
