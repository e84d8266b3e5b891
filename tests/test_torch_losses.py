"""Port parity of every learner's loss at a fixed batch: the loss value
and its gradient with respect to every param (hashing and extra) of
``nlsh_tpu_torch.train`` against ``nlsh_tpu.train`` (``jax.value_and_grad``
against autograd), same params (``params_from_jax``), same numpy batch,
rtol 1e-5 (atol 1e-5 of each tensor's largest magnitude).

The triplet learner's heads, distances and samplers are in
``test_torch_losses_triplet.py``.  The proposed learner's regulariser
rows are JAX's ``randint`` from the step key, injected through
``ProposedTrainer._reg_samples``.  Also the straight-through codebook
lookup's forward and backward, and the nearest negative mining (the
lowest id on ties in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu import train as J
from nlsh_tpu.train.triplet import nearest_exclude_positive as j_nearest
from nlsh_tpu.train.vqvae import st_codebook_lookup as j_lookup
from nlsh_tpu_torch import train as T
from nlsh_tpu_torch.train.triplet import nearest_exclude_positive
from nlsh_tpu_torch.train.vqvae import st_codebook_lookup
from torch_train_common import (
    BS,
    batch_arrays,
    check_loss,
    head_pair,
    jax_inputs,
    make_data,
    port_inputs,
    port_loss_grad,
    port_params,
    stacked_pair,
)

DATA = make_data()
EUCLID = make_data(metric="euclidean")


def test_nearest_negatives_and_their_loss_match_jax():
    jh, params, th = head_pair()
    corpus, knn = jax_inputs(DATA)
    want = np.asarray(j_nearest(jh, params, corpus, knn, k=5, chunk=128))
    got = nearest_exclude_positive(th, torch.from_numpy(DATA.training),
                                   torch.from_numpy(DATA.training_self_knn),
                                   k=5, chunk=100).numpy()
    assert (got == want).mean() >= 0.99   # only near-ties may differ
    for i in np.flatnonzero(got != want):
        assert got[i] != i and got[i] not in DATA.training_self_knn[i, :5]
    batch = batch_arrays(DATA, BS, k=5, names=("anchor", "col"))
    batch["neg"] = want[batch["anchor"]].astype(np.int32)
    kw = {"positive_k": 5, "negative_sampling_method": "nearest"}
    check_loss(J.TripletTrainer(jh, DATA, **kw), T.TripletTrainer(th, DATA, **kw),
           {"hashing": params, "extra": {}}, port_params(th), batch)


@pytest.mark.parametrize("locally", [False, True])
def test_siamese_loss_and_grads_match_jax(locally):
    jh, params, th = head_pair()
    kw = {"positive_rate": 0.3, "locally": locally}
    if locally:
        kw.update(inner_k=4, outer_k=10)
        names = ("anchor", "label", "pos_col", "neg_col")
    else:
        names = ("anchor", "label", "pos_col", "neg")
    batch = batch_arrays(DATA, BS, k=4 if locally else None, names=names)
    check_loss(J.SiameseTrainer(jh, DATA, **kw), T.SiameseTrainer(th, DATA, **kw),
           {"hashing": params, "extra": {}}, port_params(th), batch)


@pytest.mark.parametrize("kind,bits", [("MultivariateBernoulli", 6),
                                       ("ProductQuantization", 4)])
def test_proposed_loss_with_jax_regulariser_rows(kind, bits, monkeypatch):
    jh, params, th = head_pair(kind, bits=bits)
    kw = {"train_k": 5, "lambda1": 0.5, "n_reg_samples": 256}
    ttr = T.ProposedTrainer(th, DATA, **kw)
    key = jax.random.PRNGKey(3)
    rows = np.array(jax.random.randint(key, (256,), 0, DATA.training.shape[0]))
    monkeypatch.setattr(ttr, "_reg_samples",
                        lambda n, generator: torch.from_numpy(rows))
    batch = batch_arrays(DATA, BS, names=("anchor",))
    check_loss(J.ProposedTrainer(jh, DATA, **kw), ttr,
           {"hashing": params, "extra": {}}, port_params(th), batch, key=key)


def test_ae_loss_and_grads_match_jax():
    jh, params, th = head_pair()
    jtr = J.AETrainer(jh, EUCLID, decoder_hidden=24)
    extra = jtr.init_extra(jax.random.PRNGKey(5))
    batch = batch_arrays(EUCLID, BS, names=("anchor",))
    check_loss(jtr, T.AETrainer(th, EUCLID, decoder_hidden=24),
           {"hashing": params, "extra": extra}, port_params(th, extra), batch,
           data=EUCLID)


def test_vqvae_loss_and_grads_match_jax():
    jh, params, th = head_pair()
    jtr = J.VQVAETrainer(jh, DATA)
    extra = jtr.init_extra(jax.random.PRNGKey(5))
    batch = batch_arrays(DATA, BS, names=("anchor",))
    check_loss(jtr, T.VQVAETrainer(th, DATA), {"hashing": params, "extra": extra},
           port_params(th, extra), batch)


def test_multitable_loss_and_grads_match_jax():
    jh, stacked, ths = stacked_pair(2)
    kw = {"positive_k": 5, "balance_lambda": 1.5}
    jtr = J.MultiTableTrainer(J.TripletTrainer(jh, DATA, **kw), 2)
    ttr = T.MultiTableTrainer(T.TripletTrainer(ths[0], DATA, **kw), 2)
    batch = batch_arrays(DATA, BS, k=5, n_tables=2)
    loss = check_loss(jtr, ttr, {"hashing": stacked, "extra": {}},
                  port_params(ths), batch)
    # the sum of each table's own loss
    one = T.TripletTrainer(ths[0], DATA, **kw)
    parts = [port_loss_grad(one, port_params(h), *port_inputs(DATA),
                            {k: torch.as_tensor(v[:, t]).long()
                             for k, v in batch.items()})[0]
             for t, h in enumerate(ths)]
    np.testing.assert_allclose(loss, sum(parts), rtol=1e-6)


def test_multitable_refuses_learners_with_extra_params():
    _, _, th = head_pair()
    with pytest.raises(ValueError, match="extra-model-free"):
        T.MultiTableTrainer(T.AETrainer(th, DATA), 2)


def test_st_codebook_lookup_forward_and_backward():
    """The reference's straight-through backward: the incoming gradient's
    norm in each row's argmax slot, and the gradient added at the chosen
    codebook rows (twice for a row chosen twice)."""
    probs = np.array([[0.1, 0.7, 0.2], [0.6, 0.3, 0.1], [0.2, 0.5, 0.3]],
                     np.float32)
    codebook = np.array([[1.0, 0.0], [0.0, 2.0], [3.0, 3.0]], np.float32)
    g = np.array([[3.0, 4.0], [1.0, 0.0], [0.5, 0.5]], np.float32)
    out, vjp = jax.vjp(j_lookup, jnp.asarray(probs), jnp.asarray(codebook))
    jp, jc = vjp(jnp.asarray(g))
    tp = torch.tensor(probs, requires_grad=True)
    tc = torch.tensor(codebook, requires_grad=True)
    got = st_codebook_lookup(tp, tc)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp), rtol=1e-6)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(tc.grad.numpy()[1], [3.5, 4.5])


def test_triplet_and_contrastive_golden_values():
    """The JAX package's golden values (``tests/test_trainers.py``)."""
    from nlsh_tpu_torch.ops.code_distances import MVBernoulliL2

    rowwise = MVBernoulliL2().rowwise
    a, p = torch.zeros(1, 2), torch.zeros(1, 2)
    n = torch.tensor([[3.0, 4.0]])
    assert float(T.triplet_loss(a, p, n, rowwise, margin=0.1)) == 0.0
    np.testing.assert_allclose(float(T.triplet_loss(a, n, p, rowwise, 0.1)),
                               5.1, rtol=1e-5)
    a2, o2 = torch.zeros(2, 2), torch.tensor([[3.0, 4.0], [3.0, 4.0]])
    np.testing.assert_allclose(float(T.contrastive_loss(
        a2, o2, torch.tensor([1.0, 0.0]), rowwise, 0.1, 0.0)), 6.25, rtol=1e-5)
    np.testing.assert_allclose(float(T.contrastive_loss(
        a2, o2, torch.zeros(2), rowwise, negative_margin=10.0)), 12.5,
        rtol=1e-5)
