"""Port parity of data-parallel training: the port's
``build_dp_segment_runner`` over a CPU mesh of D entries against the JAX
package's ``nlsh_tpu.parallel.dp.build_dp_segment_runner`` over D of the
conftest's virtual CPU devices, 20 steps from the same params on the
same injected index arrays: losses within rtol 1e-4, params within
max-abs 1e-4 (the gradients' mean is summed in another order).  Then
``fit(mesh=)`` end to end: the loss falls, the replicas stay equal, and
a batch that does not divide over the mesh is refused."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nlsh_tpu import train as J
from nlsh_tpu.parallel import make_mesh as j_make_mesh
from nlsh_tpu.parallel.dp import build_dp_segment_runner as j_build_dp
from nlsh_tpu.train.base import TrainState as JTrainState
from nlsh_tpu_torch import train as T
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.parallel import Mesh, make_mesh
from nlsh_tpu_torch.parallel.dp import build_dp_segment_runner, entry_seed
from nlsh_tpu_torch.train.base import device_arrays
from nlsh_tpu_torch.utils.loggers import JSONLLogger
from torch_train_common import (
    BS,
    N_STEPS,
    batch_arrays,
    head_pair,
    jax_inputs,
    make_data,
    max_abs_diff,
    port_inputs,
    port_params,
    port_tree,
)

DATA = make_data()
LR = 3e-3

CASES = {
    "triplet-random-balance": (
        lambda h: J.TripletTrainer(h, DATA, positive_k=5, margin=0.5,
                                   balance_lambda=1.5),
        lambda h: T.TripletTrainer(h, DATA, positive_k=5, margin=0.5,
                                   balance_lambda=1.5),
        dict(k=5)),
    "siamese": (
        lambda h: J.SiameseTrainer(h, DATA, positive_rate=0.3),
        lambda h: T.SiameseTrainer(h, DATA, positive_rate=0.3),
        dict(names=("anchor", "label", "pos_col", "neg"))),
}


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_runner_matches_jax(case, n_dev):
    j_trainer, t_trainer, arr_kw = CASES[case]
    jh, params, th = head_pair()
    arrays = batch_arrays(DATA, N_STEPS * BS, **arr_kw)

    tx = optax.amsgrad(LR)
    jparams = {"hashing": params, "extra": {}}
    jstate = JTrainState(jparams, tx.init(jparams), jnp.asarray(0, jnp.int32))
    jrun = j_build_dp(j_trainer(jh).loss_fn, tx, BS,
                      j_make_mesh(n_dev, axis="data"))
    jstate, jl = jrun(jstate, *jax_inputs(DATA),
                      {k: jnp.asarray(v) for k, v in arrays.items()},
                      jnp.asarray(0, jnp.int32), jax.random.PRNGKey(0),
                      N_STEPS)

    ttr = t_trainer(th)
    tstate = ttr.make_state(port_params(th), LR)
    run = build_dp_segment_runner(ttr, BS, make_mesh(n_dev, "data",
                                                     platform="cpu"))
    tstate, tl = run(tstate, *port_inputs(DATA), device_arrays(arrays, "cpu"),
                     0, N_STEPS)
    assert tstate.step == int(jstate.step) == N_STEPS
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    assert max_abs_diff(port_tree(tstate.params),
                        jax.tree.map(np.asarray, jstate.params)) <= 1e-4
    # the params moved
    assert max_abs_diff(port_tree(tstate.params),
                        jax.tree.map(np.asarray, jparams)) > 1e-3


def test_dp_segments_continue_and_entry_seeds_are_distinct():
    """Two segments of 10 steps give the 20-step run; the entries' step
    generators never repeat a seed within an epoch."""
    _, _, th = head_pair()
    ttr = T.TripletTrainer(th, DATA, positive_k=5)
    arrays = device_arrays(batch_arrays(DATA, N_STEPS * BS, k=5), "cpu")
    mesh = make_mesh(4, "data", platform="cpu")
    run = build_dp_segment_runner(ttr, BS, mesh)
    a = ttr.make_state(port_params(th), LR)
    a, la = run(a, *port_inputs(DATA), arrays, 0, N_STEPS, step_seed=7)
    _, _, th2 = head_pair()
    b = ttr.make_state(port_params(th2), LR)
    b, lb1 = run(b, *port_inputs(DATA), arrays, 0, 10, step_seed=7)
    b, lb2 = run(b, *port_inputs(DATA), arrays, 10, 10, step_seed=7)
    torch.testing.assert_close(torch.cat([lb1, lb2]), la, rtol=0, atol=0)
    assert max_abs_diff(port_tree(a.params), port_tree(b.params)) == 0
    seeds = {entry_seed(s, g, 4) for s in range(100, 150) for g in range(4)}
    assert len(seeds) == 200
    with pytest.raises(ValueError, match="not divisible"):
        build_dp_segment_runner(ttr, 66, mesh)


def test_fit_on_a_mesh_loss_falls_and_replicas_stay_equal(tmp_path):
    """``fit(mesh=)`` on a 2-entry CPU mesh (the JAX package's
    ``test_dp_loss_decreases``, on its own 1,024 x 8 data)."""
    data = make_data(n=1024, nq=64, d=8, k=10, seed=3)
    log = tmp_path / "dp.jsonl"
    h = get_hashing("MultivariateBernoulli", get_encoder("mlp", 8, [16]), 5)
    tr = T.TripletTrainer(h, data, str(tmp_path), JSONLLogger(str(log)),
                          positive_k=5, margin=0.5)
    state = tr.fit(K=5, batch_size=128, learning_rate=3e-3, epochs=20,
                   test_every_updates=64, max_steps=120, hash_times=3,
                   mesh=make_mesh(2, "data", platform="cpu"))
    losses = [r["value"] for r in map(json.loads, log.read_text().splitlines())
              if r.get("name") == "training/loss"]
    assert state.step == 120 and len(losses) == 120
    assert np.mean(losses[:15]) > np.mean(losses[-15:])


def test_replicas_on_two_devices_stay_equal():
    """A mesh whose entries name two devices keeps a replica on the
    second; after every step it equals the state's parameters (two CPU
    device objects stand for two cards here: ``cpu`` and ``cpu:0``)."""
    _, _, th = head_pair()
    ttr = T.TripletTrainer(th, DATA, positive_k=5)
    arrays = device_arrays(batch_arrays(DATA, N_STEPS * BS, k=5), "cpu")
    shared = build_dp_segment_runner(ttr, BS, Mesh(["cpu"] * 2, "data"))
    split = build_dp_segment_runner(ttr, BS, Mesh(["cpu", "cpu:0"], "data"))
    a = ttr.make_state(port_params(th), LR)
    a, la = shared(a, *port_inputs(DATA), arrays, 0, 5)
    _, _, th2 = head_pair()
    b = ttr.make_state(port_params(th2), LR)
    b, lb = split(b, *port_inputs(DATA), arrays, 0, 5)
    torch.testing.assert_close(lb, la, rtol=0, atol=0)
    assert max_abs_diff(port_tree(a.params), port_tree(b.params)) == 0
