"""Shared helpers of the training parity tests (``tests/test_torch_*``):
the same numpy-seeded data, heads and params for the JAX package and the
port, and tree comparisons.  Not a test module."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from nlsh_tpu.models import get_encoder as j_encoder
from nlsh_tpu.models import get_hashing as j_hashing
from nlsh_tpu.ops.code_distances import get_code_distance as j_distance
from nlsh_tpu.parallel.multitable import init_multi_table as j_init_multi
from nlsh_tpu.train.base import TrainState as JTrainState
from nlsh_tpu.train.base import _make_lr as j_make_lr
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.ops.code_distances import get_code_distance
from nlsh_tpu_torch.train.base import _make_lr, device_arrays, extra_to
from nlsh_tpu_torch.train.base import param_leaves
from nlsh_tpu_torch.utils import checkpoint as tckpt
from torch_data_common import BITS, BS, D, HIDDEN, Data, make_data  # noqa: F401


def head_pair(kind="MultivariateBernoulli", enc="siren", bits=BITS,
              dist=None, seed=0, d=D, hidden=HIDDEN):
    """A JAX head with fresh params, and the port's twin loaded with them."""
    jh = j_hashing(kind, j_encoder(enc, d, list(hidden)), bits,
                   j_distance(dist) if dist else None)
    params = jh.init(jax.random.PRNGKey(seed))
    th = get_hashing(kind, get_encoder(enc, d, list(hidden)), bits,
                     get_code_distance(dist) if dist else None)
    tckpt.params_from_jax(th, jax.tree.map(np.asarray, params))
    return jh, params, th


def stacked_pair(n_tables, kind="MultivariateBernoulli", enc="siren",
                 bits=BITS, seed=0):
    """An ensemble's stacked JAX params and the port's modules."""
    jh = j_hashing(kind, j_encoder(enc, D, list(HIDDEN)), bits)
    stacked = j_init_multi(jh, n_tables, jax.random.PRNGKey(seed))
    ths = tckpt.stacked_params_from_jax(
        lambda: get_hashing(kind, get_encoder(enc, D, list(HIDDEN)), bits),
        jax.tree.map(np.asarray, stacked))
    return jh, stacked, ths


def port_params(hashing, jax_extra=None) -> dict:
    """The port's ``params`` dict over ``hashing`` (module or list), with
    the JAX extra params' values."""
    extra = jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                         jax_extra or {})
    return {"hashing": hashing, "extra": extra_to(extra, "cpu")}


def port_tree(params: dict, values=None) -> dict:
    """The JAX-layout tree of the port's ``params`` (``values``: tensors
    aligned with :func:`param_leaves`, e.g. gradients)."""
    if values is None:
        return tckpt._params_tree(params, lambda p: p)
    by_id = {id(p): v for p, v in zip(param_leaves(params), values)}
    return tckpt._params_tree(params, lambda p: by_id[id(p)])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flat(tree[key], f"{prefix}/{key}"))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat({str(i): v for i, v in enumerate(tree)}, prefix)
    return {prefix: np.asarray(tree)}


def assert_tree_close(got, want, rtol, atol_rel=None):
    """Leaf by leaf: ``|got - want| <= rtol * |want| + atol_rel *
    max|want|`` (``atol_rel`` defaults to ``rtol``); NaN matches NaN."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    atol_rel = rtol if atol_rel is None else atol_rel
    for key in want:
        w = want[key]
        scale = float(np.nanmax(np.abs(w))) if w.size and \
            np.isfinite(w).any() else 0.0
        np.testing.assert_allclose(got[key], w, rtol=rtol,
                                   atol=atol_rel * scale, err_msg=key)


def max_abs_diff(got, want) -> float:
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    return max(float(np.max(np.abs(got[k] - want[k]))) for k in want)


def jax_loss_grad(jtr, params, corpus, knn, batch, key=None):
    key = jax.random.PRNGKey(0) if key is None else key

    def f(p):
        return jtr.loss_fn(p["hashing"], p["extra"], corpus, knn, batch, key)

    return jax.value_and_grad(f)(params)


def port_loss_grad(ttr, params, corpus, knn, batch, generator=None):
    generator = generator or torch.Generator().manual_seed(0)
    batch = {**batch, **ttr.step_draws(generator, corpus.shape[0])}
    loss = ttr.loss_fn(params, corpus, knn, batch, None)
    leaves = param_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return float(loss.detach()), port_tree(params, grads)


def check_loss(jtr, ttr, jparams, tparams, batch, data=None, key=None):
    """One batch's loss and gradients in both packages, rtol 1e-5;
    returns the port's loss."""
    data = data or make_data()
    jl, jg = jax_loss_grad(jtr, jparams, *jax_inputs(data),
                           {k: jnp.asarray(v) for k, v in batch.items()}, key)
    tl, tg = port_loss_grad(ttr, tparams, *port_inputs(data),
                            {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
                             else torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    assert_tree_close(tg, jax.tree.map(np.asarray, jg), 1e-5)
    return tl


def batch_arrays(data: Data, n_rows: int, seed=1, k=None, n_tables=None,
                 names=("anchor", "col", "neg")) -> dict:
    """Injected index arrays of ``n_rows`` rows (``(n_rows, n_tables)``
    for an ensemble), numpy int32 (``label``: float32 0/1)."""
    rng = np.random.default_rng(seed)
    n = data.training.shape[0]
    k = k or data.training_self_knn.shape[1]
    shape = (n_rows,) if n_tables is None else (n_rows, n_tables)
    draws = {
        "anchor": lambda: rng.integers(0, n, shape),
        "col": lambda: rng.integers(0, k, shape),
        "pos_col": lambda: rng.integers(0, k, shape),
        "neg_col": lambda: rng.integers(k, data.training_self_knn.shape[1],
                                        shape),
        "neg": lambda: rng.integers(0, n, shape),
        "label": lambda: (rng.random(shape) < 0.3),
    }
    out = {}
    for name in names:
        arr = draws[name]()
        out[name] = arr.astype(np.float32 if name == "label" else np.int32)
    return out


def jax_inputs(data: Data):
    return (jnp.asarray(data.training),
            jnp.asarray(data.training_self_knn, dtype=jnp.int32))


def port_inputs(data: Data):
    return (torch.from_numpy(data.training),
            torch.from_numpy(data.training_self_knn.astype(np.int64)))


def jax_segment(jtr, params, data, arrays, n_steps, lr, schedule=None,
                seg_start=0, state=None, key=None):
    """The JAX package's compiled segment runner over injected arrays:
    ``(state, losses)``."""
    lr_ = j_make_lr(schedule, lr, 100, 10) if schedule else lr
    tx = optax.amsgrad(lr_)
    if state is None:
        state = JTrainState(params, tx.init(params), jnp.asarray(0, jnp.int32))
    run = jtr._build_segment_runner(tx, BS)
    corpus, knn = jax_inputs(data)
    key = jax.random.PRNGKey(0) if key is None else key
    state, losses = run(state, corpus, knn,
                        {k: jnp.asarray(v) for k, v in arrays.items()},
                        jnp.asarray(seg_start, jnp.int32), key, n_steps)
    return state, np.asarray(losses)


def port_segment(ttr, params, data, arrays, n_steps, lr, schedule=None,
                 seg_start=0, state=None):
    """The port's ``run_segment`` over the same arrays:
    ``(state, losses)``."""
    if state is None:
        state = ttr.make_state(
            params, _make_lr(schedule, lr, 100, 10) if schedule else lr)
    corpus, knn = port_inputs(data)
    state, losses = ttr.run_segment(state, corpus, knn,
                                    device_arrays(arrays, "cpu"), seg_start,
                                    n_steps, BS)
    return state, losses.numpy()


# -- code-space functions: the same inputs through both packages --------------

def codes(name, shape, seed):
    """Inputs each family is used on: Bernoulli probabilities, tanh codes
    (Cosine) or categorical rows (JS, CategoricalL2)."""
    z = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if name == "Cosine":
        return np.tanh(z)
    if name in ("JS", "CategoricalL2"):
        e = np.exp(z - z.max(axis=-1, keepdims=True))
        return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)


def close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.nanmax(np.abs(want))) if np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def both(jfn, tfn, p, q, seed=9):
    """Values, and gradients of a random weighting of the output, of the
    JAX function and the port's on the same inputs."""
    want = np.asarray(jfn(jnp.asarray(p), jnp.asarray(q)))
    w = np.random.default_rng(seed).normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * w), argnums=(0, 1))(
        jnp.asarray(p), jnp.asarray(q))
    tp = torch.tensor(p, requires_grad=True)
    tq = torch.tensor(q, requires_grad=True)
    got = tfn(tp, tq)
    torch.sum(got * torch.from_numpy(w)).backward()
    return got.detach().numpy(), want, (tp.grad.numpy(), tq.grad.numpy()), \
        tuple(np.asarray(g) for g in jg)


# -- the training steps of both packages -------------------------------------

N_STEPS = 20


def check_segment(jtr, ttr, jparams, tparams, arrays, lr=3e-3, schedule=None,
                  data=None, key=None):
    """20 steps of both runners from the same params on the same arrays;
    returns ``(port state, JAX state)``."""
    data = data or make_data()
    jstate, jl = jax_segment(jtr, jparams, data, arrays, N_STEPS, lr,
                             schedule, key=key)
    tstate, tl = port_segment(ttr, tparams, data, arrays, N_STEPS, lr,
                              schedule)
    assert tstate.step == int(jstate.step) == N_STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert max_abs_diff(port_tree(tstate.params),
                        jax.tree.map(np.asarray, jstate.params)) <= 1e-4
    # the params moved: the comparison is not of two untouched copies
    assert max_abs_diff(port_tree(tstate.params),
                        jax.tree.map(np.asarray, jparams)) > 1e-3
    return tstate, jstate
