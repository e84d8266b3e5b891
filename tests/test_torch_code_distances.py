"""Port parity of the code distances: every family of
``nlsh_tpu_torch.ops.code_distances`` in its three shapes against
``nlsh_tpu.ops.code_distances`` on the same numpy inputs, values and
gradients (``jax.grad`` against autograd), rtol 1e-5 (atol 1e-5 of the
tensor's largest magnitude).  The balance losses and the gradient rules
at ties are in ``test_torch_balance_ties.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsh_tpu.ops import code_distances as J
from nlsh_tpu_torch.ops import code_distances as T
from torch_train_common import both as _both, close as _close, codes as _codes

SHAPES = {"rowwise": ((12, 6), (12, 6)), "pairwise": ((9, 6), (7, 6)),
          "row_pairwise": ((5, 3, 6), (5, 4, 6))}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(J.CODE_DISTANCES))
def test_code_distance_values_and_grads_match_jax(name, shape):
    ps, qs = SHAPES[shape]
    p, q = _codes(name, ps, 0), _codes(name, qs, 1)
    jd, td = J.get_code_distance(name), T.get_code_distance(name)
    got, want, tg, jg = _both(getattr(jd, shape), getattr(td, shape), p, q)
    assert got.shape == want.shape
    _close(got, want)
    for a, b in zip(tg, jg):
        _close(a, b)


def test_registry_and_names():
    assert sorted(T.CODE_DISTANCES) == sorted(J.CODE_DISTANCES)
    for name in T.CODE_DISTANCES:
        assert type(T.get_code_distance(name)).__name__ == \
            type(J.get_code_distance(name)).__name__
        assert T.code_distance_name(T.get_code_distance(name)) == name
    with pytest.raises(ValueError, match="unknown code distance"):
        T.get_code_distance("nope")


def test_mean_kl_pairwise_is_transposed_and_l2_pairwise_squared():
    """Two kept quirks, stated directly: MeanKL's cell (i, j) is the
    symmetrised KL of p_i and q_j; L2's pairwise is squared while its
    rowwise is not."""
    p = torch.from_numpy(_codes("KL", (4, 5), 2))
    q = torch.from_numpy(_codes("KL", (3, 5), 3))
    pw = T.MVBernoulliMeanKLDivergence().pairwise(p, q)
    kl = T.MVBernoulliKLDivergence()
    want = (kl.pairwise(p[1:2], q[2:3]) + kl.pairwise(q[2:3], p[1:2])) / 2
    torch.testing.assert_close(pw[1, 2], want[0, 0])
    l2 = T.MVBernoulliL2()
    torch.testing.assert_close(l2.pairwise(p, q)[:, 0],
                               l2.rowwise(p, q[:1].expand(4, 5)) ** 2,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(12, 6), (5, 3, 6)])
@pytest.mark.parametrize("name", ["hellinger_categorical",
                                  "cross_entropy_multivariate_bernoulli"])
def test_functional_forms_match_jax(name, shape):
    """The two functional forms no family wraps: values and gradients,
    rtol 1e-5, on categorical rows (Hellinger) or Bernoulli
    probabilities (cross entropy)."""
    kind = "JS" if name.startswith("hellinger") else "KL"
    p, q = _codes(kind, shape, 0), _codes(kind, shape, 1)
    got, want, tg, jg = _both(getattr(J, name), getattr(T, name), p, q)
    assert got.shape == want.shape == shape[:-1]
    _close(got, want)
    for a, b in zip(tg, jg):
        _close(a, b)


def test_hellinger_golden_and_nan_gradient_at_equal_rows():
    """The JAX tests' values (0 at equal rows, 1 at disjoint ones), and
    the gradient at equal rows: NaN in both packages, as
    ``jnp.linalg.norm``'s is at zero."""
    p = np.array([[1.0, 0.0], [0.5, 0.5], [0.3, 0.7]], np.float32)
    q = np.array([[1.0, 0.0], [0.5, 0.5], [0.3, 0.7]], np.float32)
    torch.testing.assert_close(
        T.hellinger_categorical(torch.from_numpy(p), torch.from_numpy(q)),
        torch.zeros(3))
    one = T.hellinger_categorical(torch.tensor([[1.0, 0.0]]),
                                  torch.tensor([[0.0, 1.0]]))
    np.testing.assert_allclose(one.numpy(), [1.0], rtol=1e-6)
    got, want, tg, jg = _both(J.hellinger_categorical,
                              T.hellinger_categorical, p[1:], q[1:])
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tg, jg):
        assert np.isnan(b).all() and np.isnan(a).all()


def test_cross_entropy_golden_and_rowwise_uses_it():
    """The JAX tests' golden values (4 decimals), its ``_Q_FLOOR``
    epsilon default, and ``MVBernoulliCrossEntropy.rowwise`` calling the
    function: equal bitwise, and a different epsilon changes both."""
    p = torch.tensor([[0.5, 0.5], [0.1, 0.9], [0.1, 0.9], [0.1, 0.9],
                      [0.2, 0.8], [1.0, 0.0]])
    q = torch.tensor([[0.1, 0.9], [0.5, 0.5], [0.9, 0.1], [0.1, 0.9],
                      [0.2, 0.8], [0.0, 1.0]])
    got = T.cross_entropy_multivariate_bernoulli(p, q)
    np.testing.assert_array_almost_equal(
        got.numpy(),
        [1.203973, 0.693147, 2.082862, 0.325083, 0.500402, 46.0517],
        decimal=4)
    want = np.asarray(J.cross_entropy_multivariate_bernoulli(
        jnp.asarray(p.numpy()), jnp.asarray(q.numpy())))
    _close(got.numpy(), want)
    assert torch.equal(T.MVBernoulliCrossEntropy().rowwise(p, q), got)
    assert torch.equal(
        T.cross_entropy_multivariate_bernoulli(p, q, epsilon=T._Q_FLOOR), got)
    assert not torch.equal(
        T.cross_entropy_multivariate_bernoulli(p, q, epsilon=1e-3), got)
    assert torch.equal(T.MVBernoulliCrossEntropy(1e-3).rowwise(p, q),
                       T.cross_entropy_multivariate_bernoulli(p, q, 1e-3))
