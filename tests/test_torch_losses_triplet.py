"""Port parity of the triplet learner's loss at a fixed batch, over its
heads, code distances, balance terms and batch-mined negatives: the loss
and its gradient with respect to every param of
``nlsh_tpu_torch.train.TripletTrainer`` against
``nlsh_tpu.train.TripletTrainer`` (``jax.value_and_grad`` against
autograd), same params, same numpy batch, rtol 1e-5 (atol 1e-5 of each
tensor's largest magnitude).  The other learners are in
``test_torch_losses.py``."""

import pytest

from nlsh_tpu import train as J
from nlsh_tpu_torch import train as T
from torch_train_common import (
    BS,
    batch_arrays,
    check_loss,
    head_pair,
    make_data,
    port_params,
)

DATA = make_data()


TRIPLET = [
    # (id, head kind, bits, distance, trainer kwargs)
    ("random", "MultivariateBernoulli", 6, None, {}),
    ("random-balance", "MultivariateBernoulli", 6, None,
     {"balance_lambda": 1.5, "margin": 0.5}),
    ("pq-band-balance", "ProductQuantization", 8, None, {"balance_lambda": 1.5}),
    ("categorical-js", "Categorical", 16, "JS", {}),
    ("tanh-cosine", "MultivariateBernoulliTanh", 6, None, {"margin": 0.5}),
    ("kl", "MultivariateBernoulli", 6, "KL", {}),
    ("meankl", "MultivariateBernoulli", 6, "MeanKL", {}),
    ("crossentropy", "MultivariateBernoulli", 6, "CrossEntropy", {}),
    ("hard", "MultivariateBernoulli", 6, None,
     {"negative_sampling_method": "hard", "positive_k": 5}),
    ("semi-hard", "MultivariateBernoulli", 6, None,
     {"negative_sampling_method": "semi-hard", "positive_k": 5}),
    ("semi-hard-balance", "MultivariateBernoulli", 6, None,
     {"negative_sampling_method": "semi-hard", "balance_lambda": 0.5}),
]


@pytest.mark.parametrize("case", TRIPLET, ids=[c[0] for c in TRIPLET])
def test_triplet_loss_and_grads_match_jax(case):
    _, kind, bits, dist, kw = case
    jh, params, th = head_pair(kind, bits=bits, dist=dist)
    kw = {"positive_k": 5, **kw}
    jtr = J.TripletTrainer(jh, DATA, **kw)
    ttr = T.TripletTrainer(th, DATA, **kw)
    batch = batch_arrays(DATA, BS, k=kw["positive_k"])
    check_loss(jtr, ttr, {"hashing": params, "extra": {}},
           port_params(th), batch)
