"""Port parity of the code distances: every family of
``nlsh_tpu_torch.ops.code_distances`` in its three shapes against
``nlsh_tpu.ops.code_distances`` on the same numpy inputs, values and
gradients (``jax.grad`` against autograd), rtol 1e-5 (atol 1e-5 of the
tensor's largest magnitude).  The balance losses and the gradient rules
at ties are in ``test_torch_balance_ties.py``.
"""

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
