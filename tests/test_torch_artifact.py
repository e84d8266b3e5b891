"""The model artifact (``<base>.json`` + ``<base>.msgpack``) across the
two packages.

* the port's standard-library msgpack writer gives flax's bytes for the
  same tree, and its reader reads them back;
* an artifact written by ``nlsh_tpu.utils.checkpoint.save_model`` loads
  in the port, and one written by the port loads in the JAX package:
  every head type, both encoders, single module and ensemble
  (``n_tables``); the loaded model hashes as the saving one does
  (integers exact, probabilities atol 1e-6);
* the suffixes are appended to the base name, never substituted: base
  names with dots keep them.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from nlsh_tpu.models import get_encoder as j_encoder
from nlsh_tpu.models import get_hashing as j_hashing
from nlsh_tpu.parallel.multitable import init_multi_table
from nlsh_tpu.utils import checkpoint as jckpt
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.ops.code_distances import get_code_distance
from nlsh_tpu_torch.utils import checkpoint as tckpt

D = 12
HEADS = [("MultivariateBernoulli", 7), ("MultivariateBernoulliTanh", 6),
         ("Categorical", 19), ("ProductQuantization", 8),
         ("ProductQuantization", 6)]


def _x(n=120, seed=1):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _assert_hashes_alike(jh, params, th, tables=None):
    x = _x()
    if tables is None:
        pairs = [(params, th)]
    else:
        pairs = [(jax.tree.map(lambda a: a[t], params), th[t])
                 for t in range(tables)]
    for p, h in pairs:
        with torch.no_grad():
            probs = h.probs(torch.from_numpy(x)).numpy()
            hard = h.hash_hard(torch.from_numpy(x)).numpy()
            ids, valid = h.hash(torch.from_numpy(x), n_probes=4,
                                probe_mode="flip")
        np.testing.assert_allclose(
            probs, np.asarray(jh.probs(p, jnp.asarray(x))), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(
            hard, np.asarray(jh.hash_hard(p, jnp.asarray(x))))
        j_ids, j_valid = jh.hash(p, jnp.asarray(x), n_probes=4,
                                 probe_mode="flip")
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))


# -- the writer ---------------------------------------------------------------

def test_writer_gives_flax_bytes():
    rng = np.random.default_rng(0)
    tree = {
        "a": rng.normal(size=(3, 4)).astype(np.float32),
        "layers": [{"w": rng.integers(-5, 5, (2, 2, 2)).astype(np.int32)},
                   {"w": np.arange(7, dtype=np.int64),
                    "b": rng.random(3).astype(np.float16)}],
        "flags": np.array([True, False]),
        "scalar": np.float32(1.5),
        "empty": np.zeros((0, 3), np.float32),
        "n": 300, "small": 5, "neg": -70000, "tiny": -3, "x": 0.25,
        "name": "siren" * 10, "t": True, "none": None,
        "big": rng.normal(size=(70000,)).astype(np.float32),
        "wide": {f"k{i}": i for i in range(20)},
    }
    got = tckpt.msgpack_serialize(tree)
    assert got == serialization.to_bytes(tree)
    back = tckpt.msgpack_restore(got)
    np.testing.assert_array_equal(back["big"], tree["big"])
    assert back["layers"]["1"]["b"].dtype == np.float16
    # tensors serialise as the arrays they hold
    assert tckpt.msgpack_serialize({"w": torch.from_numpy(tree["a"])}) == \
        serialization.to_bytes({"w": tree["a"]})
    with pytest.raises(ValueError, match="cannot serialise"):
        tckpt.msgpack_serialize({"bad": object()})
    with pytest.raises(ValueError, match="str keys"):
        tckpt.msgpack_serialize({1: 2})


@pytest.mark.parametrize("kind,hash_size", HEADS)
def test_params_to_jax_inverts_params_from_jax(kind, hash_size):
    jh = j_hashing(kind, j_encoder("siren", D, [16, 8]), hash_size)
    params = jax.tree.map(np.asarray, jh.init(jax.random.PRNGKey(0)))
    th = get_hashing(kind, get_encoder("siren", D, [16, 8]), hash_size)
    tckpt.params_from_jax(th, params)
    back = tckpt.params_to_jax(th)
    assert tckpt.msgpack_serialize(back) == serialization.to_bytes(params)


# -- the artifact, both directions ---------------------------------------------

@pytest.mark.parametrize("enc,enc_kw", [("siren", {}), ("mlp", {}),
                                        ("mlp", {"with_layernorm": True})])
@pytest.mark.parametrize("kind,hash_size", HEADS)
def test_artifact_saved_by_jax_loads_in_the_port(tmp_path, kind, hash_size,
                                                 enc, enc_kw):
    jh = j_hashing(kind, j_encoder(enc, D, [16, 8], **enc_kw), hash_size)
    params = jh.init(jax.random.PRNGKey(1))
    base = str(tmp_path / "model")
    jckpt.save_model(base, jh, params)
    th = tckpt.load_model(base, device="cpu")
    assert type(th).__name__ == type(jh).__name__ and not th.training
    assert th.hash_size == jh.hash_size and th.n_buckets == jh.n_buckets
    _assert_hashes_alike(jh, params, th)
    # the port's description of the loaded module is the file's
    assert tckpt.hashing_config(th) == \
        json.loads((tmp_path / "model.json").read_text())
    # either suffix names the same artifact
    for suffix in (".json", ".msgpack"):
        again = tckpt.load_model(base + suffix, device="cpu")
        assert tckpt.msgpack_serialize(tckpt.params_to_jax(again)) == \
            (tmp_path / "model.msgpack").read_bytes()


@pytest.mark.parametrize("enc,enc_kw", [("siren", {}),
                                        ("mlp", {"with_layernorm": True})])
@pytest.mark.parametrize("kind,hash_size", HEADS)
def test_artifact_saved_by_the_port_loads_in_jax(tmp_path, kind, hash_size,
                                                 enc, enc_kw):
    th = get_hashing(kind, get_encoder(enc, D, [16, 8], **enc_kw), hash_size)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in th.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    base = str(tmp_path / "sub" / "model")          # the directory is made
    tckpt.save_model(base, th)
    jh, params = jckpt.load_model(base)
    assert type(jh).__name__ == type(th).__name__
    assert jh.hash_size == th.hash_size
    _assert_hashes_alike(jh, params, th.eval())
    # ... and the JAX package's description of it is the port's file
    assert jckpt.hashing_config(jh) == json.loads(
        (tmp_path / "sub" / "model.json").read_text())
    back = tckpt.load_model(base, device="cpu")
    for a, b in zip(back.parameters(), th.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,hash_size", [("MultivariateBernoulli", 6),
                                            ("ProductQuantization", 6)])
def test_ensemble_artifact_both_directions(tmp_path, kind, hash_size):
    L = 3
    jh = j_hashing(kind, j_encoder("siren", D, [16]), hash_size)
    stacked = init_multi_table(jh, L, jax.random.PRNGKey(4))
    jckpt.save_model(str(tmp_path / "ens"), jh, stacked, n_tables=L)
    hashings = tckpt.load_model(str(tmp_path / "ens"), device="cpu")
    assert isinstance(hashings, list) and len(hashings) == L
    _assert_hashes_alike(jh, stacked, hashings, tables=L)
    # the tables differ from one another
    assert not torch.equal(hashings[0].out.weight, hashings[1].out.weight)

    tckpt.save_model(str(tmp_path / "back"), hashings)
    cfg = json.loads((tmp_path / "back.json").read_text())
    assert cfg["n_tables"] == L
    assert cfg == json.loads((tmp_path / "ens.json").read_text())
    assert (tmp_path / "back.msgpack").read_bytes() == \
        (tmp_path / "ens.msgpack").read_bytes()
    jh2, stacked2 = jckpt.load_model(str(tmp_path / "back"))
    for a, b in zip(jax.tree.leaves(stacked2), jax.tree.leaves(stacked)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # a JSON that promises another table count than the params hold
    cfg["n_tables"] = L + 1
    (tmp_path / "back.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="tables"):
        tckpt.load_model(str(tmp_path / "back"), device="cpu")


@pytest.mark.parametrize("name", ["run_300_0.6528", "v1.2.model", "plain",
                                  "ends.json.x"])
def test_dotted_base_names_keep_their_dots(tmp_path, name):
    th = get_hashing("MultivariateBernoulli", get_encoder("mlp", D, [8]), 5)
    base = str(tmp_path / name)
    tckpt.save_model(base, th)
    assert (tmp_path / (name + ".json")).exists()
    assert (tmp_path / (name + ".msgpack")).exists()
    assert len(list(tmp_path.iterdir())) == 2
    jh, params = jckpt.load_model(base)
    _assert_hashes_alike(jh, params, th.eval())
    back = tckpt.load_model(base + ".msgpack", device="cpu")
    assert torch.equal(back.out.weight, th.out.weight)


def test_code_distance_is_written_as_given_and_otherwise_ignored(tmp_path):
    th = get_hashing("MultivariateBernoulli", get_encoder("mlp", D, [8]), 5)
    assert tckpt.hashing_config(th)["code_distance"] == "L2"
    assert tckpt.hashing_config(
        get_hashing("MultivariateBernoulliTanh", get_encoder("mlp", D, [8]), 5)
    )["code_distance"] == "Cosine"
    assert tckpt.hashing_config(
        get_hashing("Categorical", get_encoder("mlp", D, [8]), 5)
    )["code_distance"] == "CategoricalL2"
    th = get_hashing("MultivariateBernoulli", get_encoder("mlp", D, [8]), 5,
                     get_code_distance("KL"))
    tckpt.save_model(str(tmp_path / "kl"), th)
    assert tckpt.model_config(str(tmp_path / "kl"))["code_distance"] == "KL"
    jh, _ = jckpt.load_model(str(tmp_path / "kl"))
    assert type(jh.code_distance).__name__ == "MVBernoulliKLDivergence"
    # the port's loader builds the distance the artifact names, as JAX's
    assert type(tckpt.load_model(str(tmp_path / "kl"), device="cpu")
                .code_distance).__name__ == "MVBernoulliKLDivergence"
    cfg = tckpt.model_config(str(tmp_path / "kl"))
    cfg["code_distance"] = "a distance the port has never heard of"
    with pytest.raises(ValueError, match="unknown code distance"):
        tckpt.build_hashing(cfg)
    cfg["code_distance"], cfg["type"] = "KL", "Nope"
    with pytest.raises(ValueError, match="unknown hashing type"):
        tckpt.build_hashing(cfg)
