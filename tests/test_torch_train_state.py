"""A trainer's ``.state`` file across the two packages: a state written by
the JAX package (``nlsh_tpu.utils.checkpoint.save_train_state`` of its
``TrainState``) resumes in the port, and one written by the port resumes
in the JAX package; five more steps on both sides then agree (losses
rtol 1e-4, params max-abs 1e-4).  A state loaded and written again is
the other package's file byte for byte: params, amsgrad moments and
counts, the schedule's count (``{}`` for a constant rate), step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import serialization

from nlsh_tpu import train as J
from nlsh_tpu.train.base import TrainState as JTrainState
from nlsh_tpu.train.base import _make_lr as j_make_lr
from nlsh_tpu.utils import checkpoint as jckpt
from nlsh_tpu_torch import train as T
from nlsh_tpu_torch.train.base import _make_lr
from nlsh_tpu_torch.utils import checkpoint as tckpt
from torch_train_common import (
    BS,
    batch_arrays,
    head_pair,
    jax_segment,
    make_data,
    max_abs_diff,
    port_params,
    port_segment,
    port_tree,
    stacked_pair,
)

DATA = make_data()
EUCLID = make_data(metric="euclidean")
LR = 3e-3


def _learner(name):
    """(JAX trainer, port trainer, JAX params, port params, arrays, data)
    of one learner, from the same params."""
    if name == "ensemble":
        jh, stacked, ths = stacked_pair(2)
        kw = {"positive_k": 5, "balance_lambda": 1.5}
        return (J.MultiTableTrainer(J.TripletTrainer(jh, DATA, **kw), 2),
                T.MultiTableTrainer(T.TripletTrainer(ths[0], DATA, **kw), 2),
                {"hashing": stacked, "extra": {}}, port_params(ths),
                batch_arrays(DATA, 10 * BS, k=5, n_tables=2), DATA)
    jh, params, th = head_pair()
    if name == "ae":
        jtr = J.AETrainer(jh, EUCLID, decoder_hidden=24)
        extra = jtr.init_extra(jax.random.PRNGKey(5))
        return (jtr, T.AETrainer(th, EUCLID, decoder_hidden=24),
                {"hashing": params, "extra": extra}, port_params(th, extra),
                batch_arrays(EUCLID, 10 * BS, names=("anchor",)), EUCLID)
    return (J.TripletTrainer(jh, DATA, positive_k=5),
            T.TripletTrainer(th, DATA, positive_k=5),
            {"hashing": params, "extra": {}}, port_params(th),
            batch_arrays(DATA, 10 * BS, k=5), DATA)


CASES = [("triplet", None), ("ae", "cosine"), ("ensemble", "linear")]


def _tx(schedule):
    return optax.amsgrad(j_make_lr(schedule, LR, 100, 10) if schedule else LR)


def _fresh_port_state(ttr, tparams, schedule):
    return ttr.make_state(tparams, _make_lr(schedule, LR, 100, 10)
                          if schedule else LR)


@pytest.mark.parametrize("name,schedule", CASES)
def test_jax_state_resumes_in_the_port(tmp_path, name, schedule):
    jtr, ttr, jparams, tparams, arrays, data = _learner(name)
    jstate, _ = jax_segment(jtr, jparams, data, arrays, 5, LR, schedule)
    path = str(tmp_path / "jax.state")
    jckpt.save_train_state(path, jstate)

    tstate = tckpt.load_train_state(path, _fresh_port_state(ttr, tparams,
                                                            schedule))
    assert tstate.step == 5 and tstate.opt_state.count == 5
    # loaded and written again: the JAX package's bytes
    tckpt.save_train_state(str(tmp_path / "port.state"), tstate)
    assert (tmp_path / "port.state").read_bytes() == \
        (tmp_path / "jax.state").read_bytes()

    jstate, jl = jax_segment(jtr, None, data, arrays, 5, LR, schedule,
                             seg_start=5, state=jstate)
    tstate, tl = port_segment(ttr, None, data, arrays, 5, LR, schedule,
                              seg_start=5, state=tstate)
    assert tstate.step == int(jstate.step) == 10
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert max_abs_diff(port_tree(tstate.params),
                        jax.tree.map(np.asarray, jstate.params)) <= 1e-4


@pytest.mark.parametrize("name,schedule", CASES)
def test_port_state_resumes_in_jax(tmp_path, name, schedule):
    jtr, ttr, jparams, tparams, arrays, data = _learner(name)
    tstate, _ = port_segment(ttr, tparams, data, arrays, 5, LR, schedule)
    path = str(tmp_path / "port.state")
    tckpt.save_train_state(path, tstate)

    tx = _tx(schedule)
    like = JTrainState(jparams, tx.init(jparams), jnp.asarray(0, jnp.int32))
    jstate = jckpt.load_train_state(path, like)
    assert int(jstate.step) == 5
    assert serialization.to_bytes(jax.tree.map(np.asarray, jstate)) == \
        (tmp_path / "port.state").read_bytes()

    jstate, jl = jax_segment(jtr, None, data, arrays, 5, LR, schedule,
                             seg_start=5, state=jstate)
    tstate, tl = port_segment(ttr, None, data, arrays, 5, LR, schedule,
                              seg_start=5, state=tstate)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert max_abs_diff(port_tree(tstate.params),
                        jax.tree.map(np.asarray, jstate.params)) <= 1e-4


def test_a_state_that_does_not_fit_is_refused(tmp_path):
    jtr, ttr, jparams, tparams, arrays, data = _learner("triplet")
    jstate, _ = jax_segment(jtr, jparams, data, arrays, 2, LR, "cosine")
    jckpt.save_train_state(str(tmp_path / "sched.state"), jstate)
    with pytest.raises(ValueError, match="learning rate"):
        tckpt.load_train_state(str(tmp_path / "sched.state"),
                               _fresh_port_state(ttr, tparams, None))
    _, _, _, other, _, _ = _learner("ensemble")
    with pytest.raises(ValueError):
        tckpt.load_train_state(str(tmp_path / "sched.state"),
                               _fresh_port_state(ttr, other, "cosine"))
