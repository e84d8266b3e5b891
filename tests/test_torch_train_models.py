"""The heads' training surface in the port: ``init`` from an explicit
``torch.Generator`` (the JAX package's distributions, never torch's
global generator), ``output_dim``, ``code_distance`` and its defaults,
``get_hashing(..., code_distance)``, ``build_hashing`` honouring the
artifact's ``code_distance``, and ``init_multi_table``, each against the
JAX package where it has a counterpart."""

import json

import jax
import numpy as np
import pytest
import torch

from nlsh_tpu.models import get_encoder as j_encoder
from nlsh_tpu.models import get_hashing as j_hashing
from nlsh_tpu.ops.code_distances import get_code_distance as j_distance
from nlsh_tpu.utils import checkpoint as jckpt
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.ops.code_distances import get_code_distance
from nlsh_tpu_torch.parallel import init_multi_table
from nlsh_tpu_torch.utils import checkpoint as tckpt

HEADS = [("MultivariateBernoulli", 6), ("MultivariateBernoulliTanh", 6),
         ("Categorical", 16), ("ProductQuantization", 8)]


def _pair(kind, hash_size, enc="siren", dist=None):
    jd = j_distance(dist) if dist else None
    td = get_code_distance(dist) if dist else None
    return (j_hashing(kind, j_encoder(enc, 12, [16, 8]), hash_size, jd),
            get_hashing(kind, get_encoder(enc, 12, [16, 8]), hash_size, td))


@pytest.mark.parametrize("kind,hash_size", HEADS)
def test_output_dim_and_default_code_distance_match_jax(kind, hash_size):
    jh, th = _pair(kind, hash_size)
    assert th.output_dim == jh.output_dim
    assert th.predict(torch.zeros(2, 12)).shape == (2, jh.output_dim)
    assert type(th.code_distance).__name__ == type(jh.code_distance).__name__
    jh, th = _pair(kind, hash_size, dist="JS" if kind in (
        "Categorical", "ProductQuantization") else "KL")
    assert type(th.code_distance).__name__ == type(jh.code_distance).__name__


@pytest.mark.parametrize("enc", ["siren", "mlp"])
@pytest.mark.parametrize("kind,hash_size", HEADS)
def test_init_draws_only_from_the_generator(kind, hash_size, enc):
    """The same generator seed gives the same weights whatever torch's
    global generator holds, and a module built without ``init`` keeps
    torch's construction-time weights."""
    heads = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        _, th = _pair(kind, hash_size, enc)
        heads.append(th.init(torch.Generator().manual_seed(7)))
    for a, b in zip(heads[0].parameters(), heads[1].parameters()):
        assert torch.equal(a, b)
    other = _pair(kind, hash_size, enc)[1].init(torch.Generator().manual_seed(8))
    assert not torch.equal(other.out.weight, heads[0].out.weight)


def test_init_distributions_are_the_jax_package_s():
    """SIREN: first layer U(+-1/fan_in), hidden U(+-sqrt(6/fan_in)/w0);
    linear layers (MLP and the output layer) U(+-1/sqrt(fan_in)), weights
    and biases alike: the bounds are reached and never passed, as in the
    JAX package's params."""
    th = get_hashing("MultivariateBernoulli",
                     get_encoder("siren", 100, [256, 256]), 12)
    th.init(torch.Generator().manual_seed(0))
    jh = j_hashing("MultivariateBernoulli", j_encoder("siren", 100, [256, 256]),
                   12)
    jp = jh.init(jax.random.PRNGKey(0))
    mine = tckpt.params_to_jax(th)
    bounds = [1 / 100, np.sqrt(6 / 256), 1 / np.sqrt(256)]
    for want, got, bound in zip(
            [jp["encoder"]["layers"][0], jp["encoder"]["layers"][1], jp["out"]],
            [mine["encoder"]["layers"][0], mine["encoder"]["layers"][1],
             mine["out"]], bounds):
        for key in ("w", "b"):
            for sample in (np.asarray(want[key]), got[key]):
                top = np.abs(sample).max()
                assert top <= bound * (1 + 1e-6)
                if sample.size >= 256:           # wide enough to near it
                    assert top >= 0.95 * bound
    mlp = get_encoder("mlp", 40, [30]).init(torch.Generator().manual_seed(0))
    w = mlp.layers[0].weight
    assert float(w.abs().max()) <= 1 / np.sqrt(40)
    assert float(w.abs().max()) > 0.95 / np.sqrt(40)


def test_init_on_any_device_draws_on_the_generator_s():
    """A CPU generator fills a module wherever it lives with the same
    values (here: a module already moved, and a fresh one)."""
    a = get_hashing("MultivariateBernoulli", get_encoder("mlp", 8, [8]), 4)
    b = get_hashing("MultivariateBernoulli", get_encoder("mlp", 8, [8]), 4)
    a.to("cpu").init(torch.Generator().manual_seed(3))
    b.init(torch.Generator().manual_seed(3))
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dist", ["KL", "MeanKL", "CrossEntropy", "L2"])
def test_build_hashing_honours_the_artifact_code_distance(tmp_path, dist):
    jh = j_hashing("MultivariateBernoulli", j_encoder("mlp", 12, [8]), 5,
                   j_distance(dist))
    jckpt.save_model(str(tmp_path / "m"), jh, jh.init(jax.random.PRNGKey(0)))
    th = tckpt.load_model(str(tmp_path / "m"), device="cpu")
    assert type(th.code_distance).__name__ == type(jh.code_distance).__name__
    # and the port writes back the distance it holds
    tckpt.save_model(str(tmp_path / "back"), th)
    assert json.loads((tmp_path / "back.json").read_text()) == \
        json.loads((tmp_path / "m.json").read_text())


def test_build_hashing_without_a_distance_takes_the_head_default():
    th = get_hashing("MultivariateBernoulliTanh", get_encoder("mlp", 12, [8]), 5)
    cfg = tckpt.hashing_config(th)
    assert cfg["code_distance"] == "Cosine"
    cfg["code_distance"] = None
    assert type(tckpt.build_hashing(cfg).code_distance).__name__ == \
        "MVBernoulliTanhCosine"


def test_init_multi_table_draws_independent_tables():
    template = get_hashing("MultivariateBernoulli", get_encoder("siren", 12, [8]),
                           4)
    tables = init_multi_table(template, 3, torch.Generator().manual_seed(0))
    again = init_multi_table(template, 3, torch.Generator().manual_seed(0))
    assert len(tables) == 3 and all(t is not template for t in tables)
    for t, u in zip(tables, again):
        for x, y in zip(t.parameters(), u.parameters()):
            assert torch.equal(x, y)
    assert not torch.equal(tables[0].out.weight, tables[1].out.weight)
    tree = tckpt.stacked_params_to_jax(tables)
    assert np.shape(tree["out"]["w"]) == (3, 8, 4)
