"""What the port's sweep tests share (``tests/test_torch_evaluate*.py``):
a seeded JAX head and the port's copy of it, a small synthetic case, the
engine pairs, and the rows' comparison.  Not a test module."""

import jax
import numpy as np

from nlsh_tpu.data import SyntheticDataset
from nlsh_tpu.models import get_encoder as j_encoder
from nlsh_tpu.models import get_hashing as j_hashing
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.utils.checkpoint import params_from_jax

MAX_PROBES = 6
# (the JAX package's engine, the port's)
ENGINES = {"xla": "gather", "pallas": "fixed", "pallas-grouped": "grouped",
           "pallas-windowed": "windowed"}


def heads(dim: int, bits: int, seed: int = 0):
    """A seeded JAX MVB head on SIREN (32) with its params, and the
    port's copy of it."""
    jh = j_hashing("MultivariateBernoulli", j_encoder("siren", dim, [32]),
                   bits)
    params = jh.init(jax.random.PRNGKey(seed))
    th = get_hashing("MultivariateBernoulli", get_encoder("siren", dim, [32]),
                     bits)
    return jh, params, params_from_jax(th, jax.tree.map(np.asarray, params))


def small_case():
    """``(data, jax head, its params, the port's head)`` over 512 rows of
    16 features, 32 queries, 7 bits."""
    data = SyntheticDataset(n_train=512, n_test=32, dim=16, metric="cosine",
                            k_ground_truth=10, seed=2).load()
    return (data,) + heads(16, 7)


def assert_rows_match(got, want):
    """The same probe counts and keys, float values, candidates equal and
    recall within 1e-6."""
    assert [r["n_probes"] for r in got] == [r["n_probes"] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert type(g["avg_n_candidates"]) is float
        assert type(g["recall"]) is float
        assert g["avg_n_candidates"] == w["avg_n_candidates"], g["n_probes"]
        assert abs(g["recall"] - w["recall"]) <= 1e-6, g["n_probes"]
