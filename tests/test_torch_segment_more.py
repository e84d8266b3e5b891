"""Port parity of the training steps, part 2 (see
``test_torch_segment.py``): 20 steps of ``run_segment`` against the JAX
package's segment runner for the autoencoder (its decoder among the
params), the VQ-VAE (its codebook), the proposed learner (its
regulariser rows JAX's ``randint`` from each step's key) and a 2-table
ensemble: losses within rtol 1e-4, params within max-abs 1e-4."""

import jax
import numpy as np
import torch

from nlsh_tpu import train as J
from nlsh_tpu_torch import train as T
from torch_train_common import (
    BS,
    N_STEPS,
    batch_arrays,
    check_segment,
    head_pair,
    make_data,
    port_params,
    stacked_pair,
)

DATA = make_data()
EUCLID = make_data(metric="euclidean")


def test_ae_segment_matches_jax():
    jh, params, th = head_pair()
    jtr = J.AETrainer(jh, EUCLID, decoder_hidden=24)
    extra = jtr.init_extra(jax.random.PRNGKey(5))
    arrays = batch_arrays(EUCLID, N_STEPS * BS, names=("anchor",))
    tstate, _ = check_segment(
        jtr, T.AETrainer(th, EUCLID, decoder_hidden=24),
        {"hashing": params, "extra": extra}, port_params(th, extra), arrays,
        data=EUCLID, schedule="linear")
    assert tstate.params["extra"]["fc1"]["w"].shape == (6, 24)


def test_vqvae_segment_matches_jax():
    jh, params, th = head_pair()
    jtr = J.VQVAETrainer(jh, DATA)
    extra = jtr.init_extra(jax.random.PRNGKey(5))
    arrays = batch_arrays(DATA, N_STEPS * BS, names=("anchor",))
    check_segment(jtr, T.VQVAETrainer(th, DATA),
                  {"hashing": params, "extra": extra}, port_params(th, extra),
                  arrays)


def test_proposed_segment_with_jax_step_keys():
    jh, params, th = head_pair()
    kw = {"train_k": 5, "lambda1": 0.5, "n_reg_samples": 256}
    ttr = T.ProposedTrainer(th, DATA, **kw)
    key = jax.random.PRNGKey(11)
    n = DATA.training.shape[0]
    # the JAX runner's per-step key: fold_in(key, epoch step)
    rows = iter([np.array(jax.random.randint(jax.random.fold_in(key, s),
                                             (256,), 0, n))
                 for s in range(N_STEPS)])
    ttr._reg_samples = lambda n, generator: torch.from_numpy(next(rows))
    arrays = batch_arrays(DATA, N_STEPS * BS, names=("anchor",))
    check_segment(J.ProposedTrainer(jh, DATA, **kw), ttr,
                  {"hashing": params, "extra": {}}, port_params(th), arrays,
                  key=key)


def test_two_table_ensemble_segment_matches_jax():
    jh, stacked, ths = stacked_pair(2)
    kw = {"positive_k": 5, "balance_lambda": 1.5, "margin": 0.5}
    arrays = batch_arrays(DATA, N_STEPS * BS, k=5, n_tables=2)
    tstate, _ = check_segment(
        J.MultiTableTrainer(J.TripletTrainer(jh, DATA, **kw), 2),
        T.MultiTableTrainer(T.TripletTrainer(ths[0], DATA, **kw), 2),
        {"hashing": stacked, "extra": {}}, port_params(ths), arrays)
    assert len(tstate.params["hashing"]) == 2
