"""The one-dispatch training segment: the step as one body over device
inputs (``StepProgram``), captured on the card as a CUDA graph and
replayed once per step.

On the CPU (the body run eagerly, as ``run_segment`` runs it there):
two segments of unequal length under a cosine schedule with warmup
against the JAX package's segment runner called twice with the same
epoch-step keys (losses rtol 1e-4, params max-abs 1e-4, as
``check_segment`` holds them); the draws taken before a segment are the
step generators' own; the body is the loop of eager steps it replaced,
bit for bit; the device-table optimiser is optax's amsgrad and the
host path's update bit for bit.

On the card (``cuda`` marker, skipped without one): the replayed
segment equals the eager body bit for bit (losses, params, moments) for
the bench's triplet step and a 2-table ensemble, the capture's warm-up
is the segment's first step, a state loaded in place mid-run continues
as the uninterrupted run, a second ``fit`` does not replay the first's
graph, and a host read in a loss fails the capture.  The module imports
no JAX (the CPU tests import it inside), so the card's tests run where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_graphed_step.py
"""

import numpy as np
import pytest
import torch

from nlsh_tpu_torch import train as T
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.parallel import init_multi_table
from nlsh_tpu_torch.train.base import Amsgrad, _make_lr, device_arrays
from nlsh_tpu_torch.utils import checkpoint as tckpt
from torch_data_common import BITS, BS, D, HIDDEN, make_data

DATA = make_data()
STEPS = 20
TRIPLET = {"positive_k": 5, "margin": 0.5, "balance_lambda": 1.5}
PROPOSED = {"train_k": 5, "lambda1": 0.5, "n_reg_samples": 256}


def _head(seed=0):
    return get_hashing("MultivariateBernoulli",
                       get_encoder("siren", D, list(HIDDEN)), BITS).init(
        torch.Generator().manual_seed(seed))


def _trainer(n_tables=None, learner="triplet"):
    if learner == "triplet":
        tr = T.TripletTrainer(_head(), DATA, **TRIPLET)
    else:
        tr = T.ProposedTrainer(_head(), DATA, **PROPOSED)
    return tr if n_tables is None else T.MultiTableTrainer(tr, n_tables)


def _arrays(n_tables=None, n_steps=STEPS):
    rng = np.random.default_rng(1)
    n = DATA.training.shape[0]
    shape = (n_steps * BS,) if n_tables is None else (n_steps * BS, n_tables)
    return {"anchor": rng.integers(0, n, shape),
            "col": rng.integers(0, 5, shape),
            "neg": rng.integers(0, n, shape)}


def _state(trainer, device, n_tables=None, schedule="cosine"):
    hashing = init_multi_table(_head(), n_tables,
                               torch.Generator().manual_seed(1)) \
        if n_tables else _head()
    hashing = [h.to(device) for h in hashing] if n_tables \
        else hashing.to(device)
    lr = _make_lr(schedule, 3e-3, 100, 10) if schedule else 3e-3
    return trainer.make_state({"hashing": hashing, "extra": {}}, lr)


def _inputs(device):
    return (torch.as_tensor(DATA.training, device=device),
            torch.as_tensor(DATA.training_self_knn.astype(np.int64),
                            device=device))


def _tensors(state) -> list:
    opt = state.opt_state
    return [*opt.params, *opt.mu, *opt.nu, *opt.nu_max]


def _assert_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for x, y in zip(_tensors(a), _tensors(b)):
        assert torch.equal(x, y)


# -- on the CPU ---------------------------------------------------------------

def test_two_segments_with_a_warmup_cosine_schedule_match_jax():
    """7 then 13 steps, the warmup's end (count 10) inside the second:
    each segment's table carries its own counts' rates."""
    import jax

    from nlsh_tpu import train as J
    from torch_train_common import (
        batch_arrays,
        head_pair,
        jax_segment,
        max_abs_diff,
        port_params,
        port_segment,
        port_tree,
    )

    jh, params, th = head_pair()
    params = {"hashing": params, "extra": {}}
    arrays = batch_arrays(DATA, STEPS * BS, k=5)
    jtr, ttr = J.TripletTrainer(jh, DATA, **TRIPLET), \
        T.TripletTrainer(th, DATA, **TRIPLET)
    key = jax.random.PRNGKey(0)
    jstate, jl1 = jax_segment(jtr, params, DATA, arrays, 7, 3e-3, "cosine",
                              key=key)
    jstate, jl2 = jax_segment(jtr, None, DATA, arrays, 13, 3e-3, "cosine",
                              seg_start=7, state=jstate, key=key)
    tstate, tl1 = port_segment(ttr, port_params(th), DATA, arrays, 7, 3e-3,
                               "cosine")
    tstate, tl2 = port_segment(ttr, None, DATA, arrays, 13, 3e-3, "cosine",
                               seg_start=7, state=tstate)
    assert tstate.step == int(jstate.step) == STEPS
    assert tstate.opt_state.schedule_count == STEPS
    np.testing.assert_allclose(np.concatenate([tl1, tl2]),
                               np.concatenate([jl1, jl2]), rtol=1e-4)
    assert max_abs_diff(port_tree(tstate.params),
                        jax.tree.map(np.asarray, jstate.params)) <= 1e-4
    assert max_abs_diff(port_tree(tstate.params),
                        jax.tree.map(np.asarray, params)) > 1e-3


@pytest.mark.parametrize("n_tables", [None, 2])
def test_draws_taken_before_the_segment_are_the_step_generators(n_tables):
    """``segment_draws`` gives each step what its own generator (seeded
    ``step_seed + s``) draws, per table for the ensemble, in step
    order."""
    tr = _trainer(n_tables, "proposed")
    n = DATA.training.shape[0]
    got = tr.segment_draws(5, 3, 4, n)["reg"]
    want = []
    for s in range(3, 7):
        gen = torch.Generator().manual_seed(5 + s)
        if n_tables is None:
            want.append(torch.randint(0, n, (256,), generator=gen))
            continue
        seeds = torch.randint(0, 2 ** 62, (n_tables,), generator=gen).tolist()
        want.append(torch.stack([torch.randint(
            0, n, (256,), generator=torch.Generator().manual_seed(seed))
            for seed in seeds], dim=1))
    assert got.dtype == torch.int64 and torch.equal(got, torch.stack(want))
    assert T.TripletTrainer(_head(), DATA).segment_draws(5, 3, 4, n) == {}


@pytest.mark.parametrize("n_tables", [None, 2])
def test_the_body_is_the_loop_of_eager_steps_bitwise(n_tables):
    """``run_segment`` on the CPU (the captured body, run eagerly) gives
    the params, moments and losses of the loop of eager steps it
    replaced: per step a slice of the arrays, the step generator's
    draws and ``Amsgrad.update``.  No graph is kept for CPU tensors."""
    tr = _trainer(n_tables, "proposed")
    corpus, knn = _inputs("cpu")
    arrays = device_arrays({"anchor": _arrays(n_tables)["anchor"]}, "cpu")
    got = _state(tr, "cpu", n_tables)
    _, losses = tr.run_segment(got, corpus, knn, arrays, 0, STEPS, BS, 9)
    assert got.step_program is None

    want = _state(tr, "cpu", n_tables)
    leaves = want.opt_state.params
    for s in range(STEPS):
        batch = {"anchor": arrays["anchor"][s * BS:(s + 1) * BS],
                 **tr.step_draws(torch.Generator().manual_seed(9 + s),
                                 corpus.shape[0])}
        loss = tr.loss_fn(want.params, corpus, knn, batch, None)
        assert torch.equal(losses[s], loss.detach())
        want.opt_state.update(list(torch.autograd.grad(loss, leaves)))
        want.step += 1
    _assert_equal(got, want)


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("cosine", 10),
                                             ("linear", 10)])
def test_device_table_amsgrad_matches_optax(schedule, warmup):
    """``step_table`` + ``apply`` (what the captured step runs) over 50
    updates: optax's amsgrad within rtol 1e-5 (``test_torch_optim.py``'s
    bound), and the host path's ``update`` (the data-parallel runner's)
    bit for bit."""
    import jax.numpy as jnp
    import optax

    from nlsh_tpu.train.base import _make_lr as j_make_lr

    rng = np.random.default_rng(1)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[((0.01 if t % 4 == 3 else 1.0) * rng.normal(size=s)).astype(
        np.float32) for s in shapes] for t in range(50)]
    lr_t = _make_lr(schedule, 1e-2, 50, warmup, 0.05)
    table_opt = Amsgrad([torch.tensor(p) for p in init], lr_t)
    host_opt = Amsgrad([torch.tensor(p) for p in init], lr_t)
    table = torch.from_numpy(table_opt.step_table(50))
    for row, g in zip(table, grads):
        table_opt.apply([torch.from_numpy(x) for x in g], row[0], row[1],
                        row[2])
        host_opt.update([torch.from_numpy(x) for x in g])
    table_opt.advance(50)

    tx = optax.amsgrad(j_make_lr(schedule, 1e-2, 50, warmup, 0.05))
    params = [jnp.asarray(p) for p in init]
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
    for got, want, p0 in zip(table_opt.params, params, init):
        moved = np.asarray(want) - p0
        np.testing.assert_allclose(got.numpy() - p0, moved, rtol=1e-5,
                                   atol=1e-5 * float(np.max(np.abs(moved))))
    assert table_opt.count == host_opt.count == 50
    assert table_opt.schedule_count == host_opt.schedule_count
    for name in ("params", "mu", "nu", "nu_max"):
        for a, b in zip(getattr(table_opt, name), getattr(host_opt, name)):
            assert torch.equal(a, b), name


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (a captured graph has no CPU mode)")
    return torch.device("cuda", 0)


def _run(trainer, device, n_tables, segments, eager):
    """The segments ``[(seg_start, n_steps), ...]`` from a fresh state,
    replayed or eager; returns the state and the losses."""
    corpus, knn = _inputs(device)
    arrays = device_arrays(_arrays(n_tables), device)
    state = _state(trainer, device, n_tables)
    run = trainer._run_segment_eager if eager else trainer.run_segment
    losses = [run(state, corpus, knn, arrays, start, n, BS, 3)[1]
              for start, n in segments]
    return state, torch.cat(losses)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tables", [None, 2], ids=["triplet", "ensemble"])
def test_replay_equals_the_eager_body_bitwise(cuda_device, n_tables):
    """20 steps (the bench's triplet: random negatives, the balance
    term, a cosine schedule; and a 2-table ensemble of it): two eager
    runs agree bit for bit, and so does the replayed segment."""
    tr = _trainer(n_tables)
    eager, eager_losses = _run(tr, cuda_device, n_tables, [(0, STEPS)], True)
    again, again_losses = _run(tr, cuda_device, n_tables, [(0, STEPS)], True)
    _assert_equal(again, eager)
    assert torch.equal(again_losses, eager_losses)
    graphed, losses = _run(tr, cuda_device, n_tables, [(0, STEPS)], False)
    assert graphed.step_program.graph is not None
    assert eager.step_program is None
    _assert_equal(graphed, eager)
    assert torch.equal(losses, eager_losses)


@pytest.mark.cuda
def test_the_warm_up_is_the_first_step(cuda_device):
    """A first segment of one step is all warm-up (the capture runs
    nothing more); the next segments, one longer than the program's
    capacity (run as chunks), replay: the state after 1 + 7 + 12 steps is
    the eager run's of 20.  A loss of the same params that the caller
    still holds (its graph made on the default stream) does not fail the
    capture."""
    tr = _trainer()
    eager, eager_losses = _run(tr, cuda_device, None, [(0, STEPS)], True)
    corpus, knn = _inputs(cuda_device)
    arrays = device_arrays(_arrays(), cuda_device)
    state = _state(tr, cuda_device)
    held = tr.loss_fn(state.params, corpus, knn,
                      {k: v[:BS] for k, v in arrays.items()}, None)
    torch.autograd.grad(held, state.opt_state.params)
    _, first = tr.run_segment(state, corpus, knn, arrays, 0, 1, BS, 3)
    program = state.step_program
    assert state.step == 1 and state.opt_state.count == 1
    assert program.capacity == 1 and program.graph.capture_s > 0
    losses = [first] + [tr.run_segment(state, corpus, knn, arrays, s, n, BS,
                                       3)[1] for s, n in [(1, 7), (8, 12)]]
    assert state.step_program is program  # one capture for the three
    _assert_equal(state, eager)
    assert torch.equal(torch.cat(losses), eager_losses)


@pytest.mark.cuda
def test_a_state_loaded_mid_run_continues_as_the_uninterrupted_run(
        cuda_device, tmp_path):
    """``load_train_state`` writes in place, so a graph captured before
    the load replays from the loaded values; a fresh state loaded from the
    file captures its own.  Both end as the uninterrupted 16 steps."""
    tr = _trainer()
    corpus, knn = _inputs(cuda_device)
    arrays = device_arrays(_arrays(), cuda_device)
    state = _state(tr, cuda_device)
    tr.run_segment(state, corpus, knn, arrays, 0, 8, BS, 3)
    path = str(tmp_path / "mid.state")
    tckpt.save_train_state(path, state)
    tr.run_segment(state, corpus, knn, arrays, 8, 8, BS, 3)
    uninterrupted = [t.clone() for t in _tensors(state)]
    program = state.step_program

    tckpt.load_train_state(path, state)
    assert state.step == 8 and state.opt_state.count == 8
    tr.run_segment(state, corpus, knn, arrays, 8, 8, BS, 3)
    assert state.step_program is program
    fresh = tckpt.load_train_state(path, _state(tr, cuda_device))
    tr.run_segment(fresh, corpus, knn, arrays, 8, 8, BS, 3)
    for got in (state, fresh):
        assert got.step == 16
        for x, y in zip(_tensors(got), uninterrupted):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_a_second_fit_does_not_replay_the_first_fits_graph(cuda_device,
                                                           tmp_path):
    """``fit`` drops its step's graph when it returns: a second fit of
    the same trainer (its module redrawn in place, new moments) captures
    its own and ends as a fresh trainer's fit of the same seed."""
    kw = dict(K=5, batch_size=BS, epochs=1, test_every_updates=8,
              max_steps=8, hash_times=3, device=cuda_device)
    tr = T.TripletTrainer(_head(), DATA, str(tmp_path / "a"), **TRIPLET)
    first = tr.fit(seed=0, **kw)
    assert first.step_program is None and first.step == 8
    kept = [p.clone() for p in first.opt_state.params]
    second = tr.fit(seed=1, **kw)
    fresh = T.TripletTrainer(_head(), DATA, str(tmp_path / "b"),
                             **TRIPLET).fit(seed=1, **kw)
    _assert_equal(second, fresh)
    assert not torch.equal(second.opt_state.params[0], kept[0])


class _HostRead(T.TripletTrainer):
    def loss_fn(self, params, corpus, knn, batch, generator):
        loss = super().loss_fn(params, corpus, knn, batch, generator)
        return loss * float(loss.detach().item() > -1.0)


@pytest.mark.cuda
def test_a_host_read_in_a_loss_fails_the_capture(cuda_device):
    """The capture is the check that a step reads nothing on the host: a
    ``.item()`` in a loss raises, with no eager fallback."""
    tr = _HostRead(_head(), DATA, **TRIPLET)
    corpus, knn = _inputs(cuda_device)
    arrays = device_arrays(_arrays(), cuda_device)
    state = _state(tr, cuda_device)
    with pytest.raises(RuntimeError):
        tr.run_segment(state, corpus, knn, arrays, 0, 4, BS, 3)
    torch.cuda.synchronize()
