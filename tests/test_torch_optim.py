"""Port parity of the optimiser and the learning-rate schedules: the
port's ``Amsgrad`` and ``_make_lr`` against ``optax.amsgrad`` and the
JAX package's ``_make_lr`` over 50 updates on the same gradients, rtol
1e-5 (atol 1e-5 of each tensor's largest magnitude).

The gradients shrink by turns, so the second moment shrinks too: that is
where optax (bias correction, then the running max) and
``torch.optim.Adam(amsgrad=True)`` (the max, then the correction) part,
and the last test shows that they do.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nlsh_tpu.train.base import _make_lr as j_make_lr
from nlsh_tpu_torch.train.base import Amsgrad, _make_lr

SHAPES = [(7, 5), (5,), (3, 4, 2)]
SCHEDULES = [("constant", 0), ("cosine", 0), ("cosine", 10), ("linear", 0),
             ("linear", 10)]


def _grads(n_updates: int, seed: int = 0):
    """Per update one gradient per tensor; every fourth update 100x
    smaller, so the second moment falls below its running max."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_updates):
        scale = 0.01 if t % 4 == 3 else 1.0
        out.append([(scale * rng.normal(size=s)).astype(np.float32)
                    for s in SHAPES])
    return out


def _run_optax(lr, params, grads):
    tx = optax.amsgrad(lr)
    params = [jnp.asarray(p) for p in params]
    state = tx.init(params)
    history = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        history.append([np.asarray(p) for p in params])
    return history, state


def _run_port(lr, params, grads):
    params = [torch.tensor(p) for p in params]
    opt = Amsgrad(params, lr)
    history = []
    for g in grads:
        opt.update([torch.from_numpy(x) for x in g])
        history.append([p.numpy().copy() for p in params])
    return history, opt


def _close(got, want, rtol=1e-5):
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("schedule,warmup", SCHEDULES)
def test_schedule_values_match_optax(schedule, warmup):
    total = 40
    want = j_make_lr(schedule, 2e-3, total, warmup, 0.05)
    got = _make_lr(schedule, 2e-3, total, warmup, 0.05)
    if schedule == "constant":
        assert got == want == 2e-3
        return
    for count in range(total + 10):
        np.testing.assert_allclose(float(got(count)), float(want(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=str(count))
    # optax scales update t by the schedule at count t - 1: lr 0 first
    if warmup:
        assert float(got(0)) == 0.0
    with pytest.raises(ValueError, match="lr_schedule"):
        _make_lr("exponential", 1e-3, 100)


@pytest.mark.parametrize("schedule,warmup", SCHEDULES)
def test_amsgrad_matches_optax_over_50_updates(schedule, warmup):
    rng = np.random.default_rng(1)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = _grads(50)
    lr_j = j_make_lr(schedule, 1e-2, 50, warmup, 0.05)
    lr_t = _make_lr(schedule, 1e-2, 50, warmup, 0.05)
    want, jstate = _run_optax(lr_j, params, grads)
    got, opt = _run_port(lr_t, params, grads)
    for g_t, w_t in zip(got, want):
        for a, b, p0 in zip(g_t, w_t, params):
            # the distance travelled, not the (larger) params themselves
            _close(a - p0, b - p0)
    # the optimiser's state is optax's too
    amsgrad_state = jstate[0]
    assert opt.count == int(amsgrad_state.count) == 50
    for name in ("mu", "nu", "nu_max"):
        for a, b in zip(getattr(opt, name), getattr(amsgrad_state, name)):
            _close(a.numpy(), np.asarray(b))
    if schedule == "constant":
        assert opt.schedule_count is None
    else:
        assert opt.schedule_count == int(jstate[1].count) == 50


def test_torch_adam_amsgrad_is_not_optax_amsgrad():
    """Why the port carries its own update: on the same shrinking
    gradients torch's Adam(amsgrad=True) leaves optax's path."""
    rng = np.random.default_rng(1)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = _grads(50)
    want, _ = _run_optax(1e-2, params, grads)
    torch_params = [torch.tensor(p, requires_grad=True) for p in params]
    adam = torch.optim.Adam(torch_params, lr=1e-2, amsgrad=True)
    for g in grads:
        for p, x in zip(torch_params, g):
            p.grad = torch.from_numpy(x)
        adam.step()
    diff = max(float(np.max(np.abs(p.detach().numpy() - w)))
               for p, w in zip(torch_params, want[-1]))
    assert diff > 1e-4
