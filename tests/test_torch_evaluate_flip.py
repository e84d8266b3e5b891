"""The port's flip-mode sweep on the fixed-cap (K5's plain version) and
windowed (K3's) engines against ``nlsh_tpu.cli.evaluate.run_sweep`` on
its ``pallas`` and ``pallas-windowed`` engines (Pallas in interpret
mode), and the ensemble sweep against ``run_sweep_multitable`` on a
2-table ensemble, on the CPU: each row's ``avg_n_candidates`` equal,
``recall`` within 1e-6.  The gather and grouped engines are in
``test_torch_evaluate.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlsh_tpu.cli import evaluate as jeval
from nlsh_tpu.parallel.multitable import init_multi_table
from nlsh_tpu_torch.cli import evaluate as teval
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.utils.checkpoint import stacked_params_from_jax
from torch_eval_common import ENGINES, MAX_PROBES, assert_rows_match, small_case


@pytest.fixture(scope="module")
def case():
    return small_case()


@pytest.mark.parametrize("jax_engine", ["pallas", "pallas-windowed"])
def test_flip_sweep_matches_the_jax_package(case, jax_engine):
    data, jh, params, th = case
    want = jeval.run_sweep(
        jh, params, jnp.asarray(data.training), jnp.asarray(data.testing),
        np.asarray(data.ground_truth), k=10, max_probes=MAX_PROBES,
        engine=jax_engine, probe_mode="flip")
    got = teval.run_sweep(th, data.training, data.testing, data.ground_truth,
                          10, max_probes=MAX_PROBES, engine=jax_engine,
                          probe_mode="flip", device="cpu")
    assert_rows_match(got, want)
    # the port's name of the engine serves the same sweep
    assert teval.run_sweep(th, data.training, data.testing,
                           data.ground_truth, 10, max_probes=MAX_PROBES,
                           engine=ENGINES[jax_engine], probe_mode="flip",
                           device="cpu") == got


def test_a_smaller_probe_budget_cuts_buckets_as_the_jax_package_does(case):
    """A probe budget below the largest bucket serves each bucket's first
    rows only, on both packages' gather engines."""
    data, jh, params, th = case
    want = jeval.run_sweep(
        jh, params, jnp.asarray(data.training), jnp.asarray(data.testing),
        np.asarray(data.ground_truth), k=10, max_probes=4, engine="xla",
        probe_mode="flip", probe_budget=40)
    got = teval.run_sweep(th, data.training, data.testing, data.ground_truth,
                          10, max_probes=4, engine="gather",
                          probe_mode="flip", probe_budget=40, device="cpu")
    assert_rows_match(got, want)


def test_ensemble_sweep_matches_the_jax_package(case):
    """Both packages draw each ``ht``'s probes and count its exact union
    on the same probes; the port's windowed engine (K3's plain version)
    against the JAX package's ``xla``."""
    data, jh, _, _ = case
    stacked = init_multi_table(jh, 2, jax.random.PRNGKey(5))
    th = stacked_params_from_jax(
        lambda: get_hashing("MultivariateBernoulli",
                            get_encoder("siren", 16, [32]), 7),
        jax.tree.map(np.asarray, stacked))
    want = jeval.run_sweep_multitable(
        jh, stacked, jnp.asarray(data.training), jnp.asarray(data.testing),
        np.asarray(data.ground_truth), 10, 2, max_probes=8, engine="xla",
        probe_mode="flip")
    got = teval.run_sweep_multitable(
        th, data.training, data.testing, data.ground_truth, 10, 2,
        max_probes=8, engine="windowed", probe_mode="flip", device="cpu")
    assert [r["hash_times"] for r in got] == [1, 2, 3, 4]
    assert_rows_match(got, want)
