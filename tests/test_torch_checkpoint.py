"""The port's standard-library reader of flax msgpack, against flax
itself, and the JAX -> torch parameter loader."""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from nlsh_tpu.models.encoders import SirenEncoder as JSiren
from nlsh_tpu.models.hashings import MultivariateBernoulli as JMVB
from nlsh_tpu_torch.models import MultivariateBernoulli, SirenEncoder
from nlsh_tpu_torch.utils.checkpoint import (
    msgpack_restore, params_from_jax, read_msgpack,
)

BENCH_PARAMS = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "artifacts", "bench_cache",
    "params_s0_n1183514_d100_q10000_k10_ts131072_v2_4da04f430c.msgpack")


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert isinstance(got, (np.ndarray, np.generic))
        assert got.dtype == want.dtype and np.shape(got) == np.shape(want)
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_reader_matches_flax_on_bench_params():
    data = open(BENCH_PARAMS, "rb").read()
    got = read_msgpack(BENCH_PARAMS)
    _assert_tree_equal(got, serialization.msgpack_restore(data))
    assert got["encoder"]["layers"]["0"]["w"].shape == (100, 256)


def test_reader_matches_flax_on_fresh_tree():
    rng = np.random.default_rng(0)
    tree = {
        "a": rng.normal(size=(3, 4)).astype(np.float32),
        "layers": [{"w": rng.integers(-5, 5, (2, 2, 2)).astype(np.int32)},
                   {"w": np.arange(7, dtype=np.int64),
                    "b": rng.random(3).astype(np.float16)}],
        "flags": np.array([True, False]),
        "scalar": np.float32(1.5),
        "n": 300, "neg": -70000, "x": 0.25, "name": "siren" * 10,
        "t": True, "none": None, "c": 1.5 - 2j,
        "big": rng.normal(size=(70000,)).astype(np.float32),
    }
    data = serialization.msgpack_serialize(tree)
    _assert_tree_equal(msgpack_restore(data), serialization.msgpack_restore(data))
    with pytest.raises(ValueError):
        msgpack_restore(data[:-3])


def test_params_from_jax_round_trips():
    jh = JMVB(JSiren(12, (16, 8)), 5)
    params = jax.tree.map(np.asarray, jh.init(jax.random.PRNGKey(3)))
    # flax stores the layer list as a map keyed "0", "1": accept both forms
    as_map = serialization.msgpack_restore(serialization.msgpack_serialize(params))
    for tree in (params, as_map):
        th = MultivariateBernoulli(SirenEncoder(12, (16, 8)), 5)
        params_from_jax(th, tree)
        for i, layer in enumerate(th.encoder.layers):
            np.testing.assert_array_equal(
                layer.weight.detach().numpy().T, params["encoder"]["layers"][i]["w"])
            np.testing.assert_array_equal(
                layer.bias.detach().numpy(), params["encoder"]["layers"][i]["b"])
        np.testing.assert_array_equal(th.out.weight.detach().numpy().T,
                                      params["out"]["w"])
    wrong = MultivariateBernoulli(SirenEncoder(12, (16, 9)), 5)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(wrong, params)


def test_bench_params_load_into_the_bench_model():
    th = MultivariateBernoulli(SirenEncoder(100, (256, 256)), 12)
    params_from_jax(th, read_msgpack(BENCH_PARAMS))
    with torch.no_grad():
        codes = th.hash_hard(torch.zeros(2, 100))
    assert codes.shape == (2,) and codes.dtype == torch.int32
