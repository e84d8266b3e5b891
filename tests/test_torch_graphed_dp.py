"""The one-dispatch data-parallel segment: on a mesh of one device the
data-parallel step is one body over device inputs (``DPStepProgram``),
captured on the card as a CUDA graph and replayed once per step.

On the CPU (the body run eagerly, as the runner runs it there): two
segments of unequal length under a cosine schedule with warmup on 2 and
4 entries against the JAX package's ``build_dp_segment_runner`` called
twice with the same key (losses rtol 1e-4, params max-abs 1e-4, as
``tests/test_torch_dp.py`` holds them: the gradients' mean is summed in
another order); the body is the loop of eager steps it replaced, bit
for bit (the triplet, the proposed learner with its per-step draws, a
2-table ensemble); the draws taken before a segment are the
per-(step, entry) generators' own; only a mesh of one device in one
process runs the program.

On the card (``cuda`` marker, skipped without one): the replayed
segment equals the eager body bit for bit on 2 and 4 entries, later
segments reuse the first one's graph (a longer one as chunks of it),
``fit(mesh=)`` replays one graph over its segments and drops it when it
returns, and a host read in a loss fails the capture.  The module
imports no JAX (the CPU parity test imports it inside), so the card's
tests run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_graphed_dp.py
"""

import numpy as np
import pytest
import torch

from nlsh_tpu_torch import train as T
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.parallel import Mesh, init_multi_table, make_mesh
from nlsh_tpu_torch.parallel import mesh as mesh_module
from nlsh_tpu_torch.parallel.dp import build_dp_segment_runner, entry_seed
from nlsh_tpu_torch.train.base import _make_lr, device_arrays
from nlsh_tpu_torch.utils import graphs
from torch_data_common import BITS, BS, D, HIDDEN, make_data

DATA = make_data()
STEPS = 20
TRIPLET = {"positive_k": 5, "margin": 0.5, "balance_lambda": 1.5}
PROPOSED = {"train_k": 5, "lambda1": 0.5, "n_reg_samples": 256}


def _head(seed=0):
    return get_hashing("MultivariateBernoulli",
                       get_encoder("siren", D, list(HIDDEN)), BITS).init(
        torch.Generator().manual_seed(seed))


def _trainer(learner="triplet"):
    if learner == "triplet":
        return T.TripletTrainer(_head(), DATA, **TRIPLET)
    tr = T.ProposedTrainer(_head(), DATA, **PROPOSED)
    return T.MultiTableTrainer(tr, 2) if learner == "ensemble" else tr


def _arrays(learner="triplet", n_steps=STEPS):
    rng = np.random.default_rng(1)
    n = DATA.training.shape[0]
    shape = (n_steps * BS, 2) if learner == "ensemble" else (n_steps * BS,)
    arrays = {"anchor": rng.integers(0, n, shape),
              "col": rng.integers(0, 5, shape),
              "neg": rng.integers(0, n, shape)}
    return arrays if learner == "triplet" else {"anchor": arrays["anchor"]}


def _state(trainer, device, learner="triplet"):
    hashing = [h.to(device) for h in init_multi_table(
        _head(), 2, torch.Generator().manual_seed(1))] \
        if learner == "ensemble" else _head().to(device)
    lr = _make_lr("cosine", 3e-3, 100, 10)
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

@pytest.mark.parametrize("n_dev", [2, 4])
def test_two_segments_of_the_program_match_jax(n_dev):
    """7 then 13 data-parallel steps, the warmup's end (count 10) inside
    the second, through the program's body (``_run_segment_eager``)
    against the JAX package's runner called twice with the same key."""
    import jax
    import jax.numpy as jnp
    import optax

    from nlsh_tpu import train as J
    from nlsh_tpu.parallel import make_mesh as j_make_mesh
    from nlsh_tpu.parallel.dp import build_dp_segment_runner as j_build_dp
    from nlsh_tpu.train.base import TrainState as JTrainState
    from nlsh_tpu.train.base import _make_lr as j_make_lr
    from torch_train_common import (
        batch_arrays,
        head_pair,
        jax_inputs,
        max_abs_diff,
        port_inputs,
        port_params,
        port_tree,
    )

    jh, params, th = head_pair()
    arrays = batch_arrays(DATA, STEPS * BS, k=5)
    jparams = {"hashing": params, "extra": {}}
    tx = optax.amsgrad(j_make_lr("cosine", 3e-3, 100, 10))
    jstate = JTrainState(jparams, tx.init(jparams), jnp.asarray(0, jnp.int32))
    jrun = j_build_dp(J.TripletTrainer(jh, DATA, **TRIPLET).loss_fn, tx, BS,
                      j_make_mesh(n_dev, axis="data"))
    jarrays = {k: jnp.asarray(v) for k, v in arrays.items()}
    key = jax.random.PRNGKey(0)
    jlosses = []
    for start, n in ((0, 7), (7, 13)):
        jstate, jl = jrun(jstate, *jax_inputs(DATA), jarrays,
                          jnp.asarray(start, jnp.int32), key, n)
        jlosses.append(np.asarray(jl))

    ttr = T.TripletTrainer(th, DATA, **TRIPLET)
    tstate = ttr.make_state(port_params(th),
                            _make_lr("cosine", 3e-3, 100, 10))
    run = build_dp_segment_runner(ttr, BS, make_mesh(n_dev, "data",
                                                     platform="cpu"))
    tarrays = device_arrays(arrays, "cpu")
    tlosses = [run._run_segment_eager(tstate, *port_inputs(DATA), tarrays,
                                      start, n)[1].numpy()
               for start, n in ((0, 7), (7, 13))]
    assert tstate.step == int(jstate.step) == STEPS
    assert tstate.step_program is None  # an eager segment keeps none
    np.testing.assert_allclose(np.concatenate(tlosses),
                               np.concatenate(jlosses), rtol=1e-4)
    assert max_abs_diff(port_tree(tstate.params),
                        jax.tree.map(np.asarray, jstate.params)) <= 1e-4
    assert max_abs_diff(port_tree(tstate.params),
                        jax.tree.map(np.asarray, jparams)) > 1e-3


@pytest.mark.parametrize("learner", ["triplet", "proposed", "ensemble"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_the_body_is_the_loop_of_eager_steps_bitwise(n_dev, learner):
    """Two segments (5 then 9 steps) of the program's body on a CPU mesh
    of one device (what ``run`` runs there) give the losses, params and
    moments of the loop of eager steps it replaced (per step each
    entry's slice, its own generator's draws, one ``Amsgrad.update``)."""
    tr = _trainer(learner)
    corpus, knn = _inputs("cpu")
    arrays = device_arrays(_arrays(learner), "cpu")
    run = build_dp_segment_runner(tr, BS, make_mesh(n_dev, "data",
                                                    platform="cpu"))
    got, want = _state(tr, "cpu", learner), _state(tr, "cpu", learner)
    for start, n in ((0, 5), (5, 9)):
        _, losses = run(got, corpus, knn, arrays, start, n, step_seed=11)
        _, loop = run._loop(want, corpus, knn, arrays, start, n,
                            step_seed=11)
        assert torch.equal(losses, loop)
    _assert_equal(got, want)
    assert got.step_program is None


@pytest.mark.parametrize("learner", ["triplet", "proposed", "ensemble"])
def test_entry_draws_are_the_step_generators(learner):
    """``entry_draws`` gives entry ``g`` at step ``s`` what its own
    generator, seeded ``entry_seed(step_seed + s, g, D)``, draws:
    ``(D, n_steps, ...)``; nothing for a learner without draws."""
    tr = _trainer(learner)
    n = DATA.training.shape[0]
    run = build_dp_segment_runner(tr, BS, make_mesh(4, "data",
                                                    platform="cpu"))
    got = run.entry_draws(5, 3, 4, n)
    if learner == "triplet":
        assert got == {}
        return
    want = torch.stack([torch.stack([
        tr.step_draws(torch.Generator().manual_seed(entry_seed(5 + s, g, 4)),
                      n)["reg"]
        for s in range(3, 7)]) for g in range(4)])
    assert got["reg"].dtype == torch.int64 and torch.equal(got["reg"], want)
    assert got["reg"].shape[:2] == (4, 4)


def test_only_a_mesh_of_one_device_in_one_process_runs_the_program(
        monkeypatch):
    """``Mesh.on_one_device``: every entry the same device and one
    process.  A mesh over two devices, or one in a process group, runs
    the loop of eager steps (and has no eager program to run)."""
    assert make_mesh(3, "data", platform="cpu").on_one_device()
    assert Mesh(["cpu"], "data").on_one_device()
    assert not Mesh(["cpu", "cpu:0"], "data").on_one_device()
    tr = _trainer()
    corpus, knn = _inputs("cpu")
    arrays = device_arrays(_arrays(), "cpu")
    split = build_dp_segment_runner(tr, BS, Mesh(["cpu", "cpu:0"], "data"))
    with pytest.raises(ValueError, match="one device"):
        split._run_segment_eager(_state(tr, "cpu"), corpus, knn, arrays, 0, 2)
    monkeypatch.setattr(mesh_module, "process_count", lambda: 2)
    assert not make_mesh(2, "data", platform="cpu").on_one_device()


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (a captured graph has no CPU mode)")
    return torch.device("cuda", 0)


def _card_runner(device, n_dev, learner="triplet"):
    tr = _trainer(learner)
    return tr, build_dp_segment_runner(tr, BS, Mesh([device] * n_dev, "data"))


def _run(runner, device, learner, segments, eager):
    """The segments ``[(seg_start, n_steps), ...]`` from a fresh state,
    replayed or eager; returns the state and the losses."""
    corpus, knn = _inputs(device)
    arrays = device_arrays(_arrays(learner), device)
    state = _state(runner.trainer, device, learner)
    run = runner._run_segment_eager if eager else runner
    losses = [run(state, corpus, knn, arrays, start, n, 3)[1]
              for start, n in segments]
    return state, torch.cat(losses)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev,learner", [(2, "triplet"), (4, "proposed")])
def test_replay_equals_the_eager_body_bitwise(cuda_device, n_dev, learner):
    """20 data-parallel steps: two eager runs agree bit for bit, and so
    does the replayed segment (losses, params, moments)."""
    _, runner = _card_runner(cuda_device, n_dev, learner)
    eager, eager_losses = _run(runner, cuda_device, learner, [(0, STEPS)],
                               True)
    again, again_losses = _run(runner, cuda_device, learner, [(0, STEPS)],
                               True)
    _assert_equal(again, eager)
    assert torch.equal(again_losses, eager_losses)
    graphed, losses = _run(runner, cuda_device, learner, [(0, STEPS)], False)
    assert graphed.step_program.graph is not None
    assert eager.step_program is None
    _assert_equal(graphed, eager)
    assert torch.equal(losses, eager_losses)


@pytest.mark.cuda
def test_later_segments_reuse_the_first_ones_graph(cuda_device):
    """A first segment of one step is all warm-up; the next two, one
    longer than the program's capacity (run as chunks), replay the same
    graph: the state after 1 + 7 + 12 steps is the eager run's of 20."""
    _, runner = _card_runner(cuda_device, 2)
    eager, eager_losses = _run(runner, cuda_device, "triplet", [(0, STEPS)],
                               True)
    corpus, knn = _inputs(cuda_device)
    arrays = device_arrays(_arrays(), cuda_device)
    state = _state(runner.trainer, cuda_device)
    _, first = runner(state, corpus, knn, arrays, 0, 1, 3)
    program = state.step_program
    assert program.capacity == 1 and program.graph.capture_s > 0
    losses = [first] + [runner(state, corpus, knn, arrays, s, n, 3)[1]
                        for s, n in [(1, 7), (8, 12)]]
    assert state.step_program is program
    _assert_equal(state, eager)
    assert torch.equal(torch.cat(losses), eager_losses)


@pytest.mark.cuda
def test_fit_on_a_card_mesh_replays_one_graph_and_drops_it(cuda_device,
                                                           tmp_path,
                                                           monkeypatch):
    """``fit(mesh=)`` over two entries of the card captures one step
    graph for its two segments (its evals capture their serves' graphs
    besides) and drops it when it returns."""
    captured = []
    capture = graphs.capture

    def counted(body, *args, **kwargs):
        graph = capture(body, *args, **kwargs)
        captured.append(kwargs.get("grad", False))
        return graph

    monkeypatch.setattr(graphs, "capture", counted)
    tr = T.TripletTrainer(_head(), DATA, str(tmp_path), **TRIPLET)
    state = tr.fit(K=5, batch_size=BS, epochs=1, test_every_updates=4,
                   max_steps=8, hash_times=3,
                   mesh=Mesh([cuda_device] * 2, "data"))
    assert state.step == 8 and state.step_program is None
    assert captured.count(True) == 1


class _HostRead(T.TripletTrainer):
    def loss_fn(self, params, corpus, knn, batch, generator):
        loss = super().loss_fn(params, corpus, knn, batch, generator)
        return loss * float(loss.detach().item() > -1.0)


@pytest.mark.cuda
def test_a_host_read_in_a_loss_fails_the_capture(cuda_device):
    """A ``.item()`` in an entry's loss raises at the capture, with no
    eager fallback."""
    tr = _HostRead(_head(), DATA, **TRIPLET)
    runner = build_dp_segment_runner(tr, BS, Mesh([cuda_device] * 2, "data"))
    corpus, knn = _inputs(cuda_device)
    arrays = device_arrays(_arrays(), cuda_device)
    with pytest.raises(RuntimeError):
        runner(_state(tr, cuda_device), corpus, knn, arrays, 0, 4, 3)
    torch.cuda.synchronize()
