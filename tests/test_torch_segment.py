"""Port parity of the training steps, part 1: the port's
``Trainer.run_segment`` against the JAX package's compiled segment
runner (``_build_segment_runner(optax.amsgrad(lr), batch_size)``) over
20 steps on the same injected index arrays, from the same params:
losses within rtol 1e-4, params within max-abs 1e-4.  Triplet (random
with the balance term and a cosine schedule, hard, semi-hard) and
siamese here; the other learners in ``test_torch_segment_more.py``."""

import pytest

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
)

DATA = make_data()


CASES = [
    ("random-balance-cosine", {"balance_lambda": 1.5, "margin": 0.5},
     "cosine"),
    ("hard", {"negative_sampling_method": "hard"}, None),
    ("semi-hard", {"negative_sampling_method": "semi-hard", "margin": 0.5},
     None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_triplet_segment_matches_jax(case):
    _, kw, schedule = case
    kw = {"positive_k": 5, **kw}
    jh, params, th = head_pair()
    arrays = batch_arrays(DATA, N_STEPS * BS, k=5)
    check_segment(J.TripletTrainer(jh, DATA, **kw),
                  T.TripletTrainer(th, DATA, **kw),
                  {"hashing": params, "extra": {}}, port_params(th), arrays,
                  schedule=schedule)


def test_siamese_segment_matches_jax():
    jh, params, th = head_pair()
    arrays = batch_arrays(DATA, N_STEPS * BS,
                          names=("anchor", "label", "pos_col", "neg"))
    check_segment(J.SiameseTrainer(jh, DATA, positive_rate=0.3),
                  T.SiameseTrainer(th, DATA, positive_rate=0.3),
                  {"hashing": params, "extra": {}}, port_params(th), arrays)
