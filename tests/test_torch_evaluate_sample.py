"""The port's sampled sweep against ``nlsh_tpu.cli.evaluate.run_sweep`` on
the CPU, given the JAX package's raw probe codes (``jax.random`` keys
cannot be replayed in torch): on every engine each row's
``avg_n_candidates`` equal and ``recall`` within 1e-6.  At one probe the
sampled and the flip sweeps both serve the hard code alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsh_tpu.cli import evaluate as jeval
from nlsh_tpu_torch.cli import evaluate as teval
from torch_eval_common import ENGINES, MAX_PROBES, assert_rows_match, small_case


@pytest.fixture(scope="module")
def case():
    data, jh, params, th = small_case()
    raw = np.asarray(jeval.sample_probe_codes(
        jh, params, jnp.asarray(data.testing), MAX_PROBES,
        jax.random.PRNGKey(0)))   # run_sweep's own draw at seed 0
    return data, jh, params, th, raw


@pytest.mark.parametrize("jax_engine", list(ENGINES))
def test_sampled_sweep_matches_the_jax_package(case, jax_engine):
    data, jh, params, th, raw = case
    want = jeval.run_sweep(
        jh, params, jnp.asarray(data.training), jnp.asarray(data.testing),
        np.asarray(data.ground_truth), k=10, max_probes=MAX_PROBES,
        engine=jax_engine, seed=0)
    got = teval.run_sweep(th, data.training, data.testing, data.ground_truth,
                          10, max_probes=MAX_PROBES,
                          engine=ENGINES[jax_engine], device="cpu",
                          raw_codes=raw)
    assert_rows_match(got, want)
    assert len({r["avg_n_candidates"] for r in got}) > 1


def test_sample_and_flip_agree_at_one_probe(case):
    data, _, _, th, _ = case
    args = (th, data.training, data.testing, data.ground_truth, 10)
    sample = teval.run_sweep(*args, max_probes=MAX_PROBES, engine="grouped",
                             device="cpu")
    flip = teval.run_sweep(*args, max_probes=MAX_PROBES, engine="grouped",
                           probe_mode="flip", device="cpu")
    assert sample[0] == flip[0]
    cands = [r["avg_n_candidates"] for r in sample]
    assert cands == sorted(cands)
    assert sample[-1]["recall"] >= sample[0]["recall"]
