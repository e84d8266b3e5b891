"""The port's training and precompute CLIs against the JAX package's:
``nlsh_tpu_torch.cli.train``'s parser has every dest and default of
``nlsh_tpu.cli.train``'s (plus ``--device``), its learners train on the
synthetic dataset on the CPU, a run writes its JSONL log and its
checkpoints, a checkpoint serves, and ``--resume_from`` continues at
the saved step; ``precompute`` of a tiny hdf5 file writes what the JAX
package's writes."""

import json
import os

import h5py
import numpy as np
import pytest
import torch

from nlsh_tpu.cli.precompute import precompute as j_precompute
from nlsh_tpu.cli.train import nlsh_argparse as j_argparse
from nlsh_tpu_torch.cli.precompute import precompute
from nlsh_tpu_torch.cli.train import main, nlsh_argparse
from nlsh_tpu_torch.index import Indexer
from nlsh_tpu_torch.utils.checkpoint import load_model

TINY = ["--data_id", "synthetic", "-hs", "4", "-es", "16", "-et", "mlp",
        "-bs", "256", "--epochs", "1", "--hash_times", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def _synth_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("synth"))


@pytest.fixture(autouse=True)
def _own_dirs(_synth_cache, tmp_path, monkeypatch):
    """This file's synthetic data (made once) and each test's logs in
    directories of their own."""
    monkeypatch.setenv("NLSH_SYNTH_CACHE_DIR", _synth_cache)
    monkeypatch.setenv("NLSH_LOG_DIR", str(tmp_path / "logs"))


def _defaults(parser):
    return {a.dest: (a.default, tuple(a.choices) if a.choices else None)
            for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_package_s_dests_and_defaults():
    ours, theirs = _defaults(nlsh_argparse()), _defaults(j_argparse())
    assert ours.pop("device") == ("cuda", None)
    assert ours == theirs
    args = nlsh_argparse().parse_args(["--data_id", "synthetic"])
    want = j_argparse().parse_args(["--data_id", "synthetic"])
    assert vars(args) == {**vars(want), "device": "cuda"}


@pytest.mark.parametrize("learner", ["triplet", "siamese", "proposed", "ae",
                                     "vqvae"])
def test_every_learner_trains_from_the_cli(learner, tmp_path):
    state = main(TINY + ["--learner_type", learner, "--debug",
                         "--test_every_updates", "8", "--max_steps", "8",
                         "--model_save_dir", str(tmp_path)])
    assert state.step == 8


@pytest.mark.parametrize("hashing,distance,n_tables", [
    ("MultivariateBernoulliTanh", "Cosine", 1),
    ("ProductQuantization", "L2", 1), ("Categorical", "JS", 1),
    ("MultivariateBernoulli", "KL", 2)])
def test_heads_distances_and_ensembles_from_the_cli(tmp_path, hashing,
                                                    distance, n_tables):
    state = main(TINY + ["--debug", "-ht", hashing, "-dt", distance,
                         "--n_tables", str(n_tables), "--max_steps", "4",
                         "--test_every_updates", "4",
                         "--model_save_dir", str(tmp_path)])
    modules = state.params["hashing"]
    modules = modules if isinstance(modules, list) else [modules]
    assert len(modules) == n_tables
    assert {type(m).__name__ for m in modules} == \
        {"MultivariateBernoulli" if "Bernoulli" in hashing else hashing}
    for m in modules:
        assert type(m.code_distance).__name__ == {
            "Cosine": "MVBernoulliTanhCosine", "L2": "CategoricalL2",
            "JS": "CategoricalJSD", "KL": "MVBernoulliKLDivergence"}[distance]


def test_a_run_logs_checkpoints_serves_and_resumes(tmp_path):
    save_dir = tmp_path / "models"
    state = main(TINY + ["--logger_type", "jsonl", "--test_every_updates", "4",
                         "--max_steps", "8", "--model_save_dir",
                         str(save_dir)])
    logs = os.listdir(tmp_path / "logs")
    assert len(logs) == 1 and logs[0].startswith("triplet_")
    records = [json.loads(line)
               for line in (tmp_path / "logs" / logs[0]).read_text().splitlines()]
    assert [r["step"] for r in records if r.get("name") == "training/loss"] \
        == list(range(1, 9))
    saved = sorted((f for f in os.listdir(save_dir) if f.endswith(".state")),
                   key=lambda f: int(f.split("_")[-2]))
    assert saved and saved[0].startswith(logs[0][:-len(".jsonl")])
    base = str(save_dir / saved[-1][:-len(".state")])
    step = int(saved[-1].split("_")[-2])

    hashing = load_model(base, device="cpu")
    from nlsh_tpu_torch.data import SyntheticDataset

    data = SyntheticDataset(device="cpu").load()
    idx = Indexer(hashing, data.training, device="cpu")
    ids, n_cand = idx.query(data.testing, k=10, hash_times=3,
                            probe_mode="flip")
    assert ids.shape == (data.testing.shape[0], 10) and (n_cand > 0).all()
    assert state.step == 8

    resumed = main(TINY + ["--debug", "--test_every_updates", "4",
                           "--max_steps", str(step + 4), "--resume_from",
                           base + ".state", "--model_save_dir",
                           str(tmp_path / "again")])
    assert resumed.step == step + 4


def test_unported_and_invalid_requests_raise(tmp_path):
    common = TINY + ["--debug", "--model_save_dir", str(tmp_path)]
    # the HNSW baseline runs on the synthetic dataset and logs its recall
    recall = main(TINY + ["--learner_type", "hnsw", "--logger_type", "jsonl",
                          "--model_save_dir", str(tmp_path)])
    (log,) = os.listdir(os.environ["NLSH_LOG_DIR"])
    with open(os.path.join(os.environ["NLSH_LOG_DIR"], log)) as f:
        logged = {r["name"]: r["value"] for r in map(json.loads, f)
                  if r.get("kind") == "metric"}
    assert set(logged) == {"test/recall", "test/query_size", "test/qps"}
    assert logged["test/recall"] == pytest.approx(recall) and recall > 0.9
    with pytest.raises(RuntimeError, match="not valid"):
        main(common + ["-ht", "MultivariateBernoulli", "-dt", "Cosine"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(common + ["--device", "cuda"])


def _printed(capsys):
    """The CLI's printed lines, meta dicts parsed (without the port's
    ``device`` key)."""
    import ast

    out = []
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            d = ast.literal_eval(line)
            d.pop("device", None)
            out.append(d)
        elif line.strip():
            out.append(line)
    return out


def test_n_devices_trains_data_parallel_like_the_jax_cli(tmp_path, capsys):
    """``--n_devices 2 --device cpu`` splits each step's batch over a
    2-entry CPU mesh and prints the JAX package's lines (its run over 2
    of the conftest's virtual devices), ``{'n_devices': 2}`` among
    them."""
    import jax

    from nlsh_tpu.cli.train import main as j_main

    argv = TINY[:-2] + ["--debug", "--max_steps", "4", "--test_every_updates",
                        "4", "--n_devices", "2"]
    capsys.readouterr()
    state = main(argv + ["--device", "cpu", "--model_save_dir",
                         str(tmp_path / "t")])
    ours = _printed(capsys)
    j_state = j_main(argv + ["--model_save_dir", str(tmp_path / "j")])
    theirs = _printed(capsys)
    assert state.step == int(j_state.step) == 4
    assert {"n_devices": 2} in ours and ours == theirs
    assert all(bool(torch.isfinite(p).all())
               for p in state.params["hashing"].parameters())
    assert jax.device_count() == 8
    with pytest.raises(ValueError, match="not divisible"):
        main(TINY[:-2] + ["--device", "cpu", "--debug", "--max_steps", "2",
                          "-bs", "255", "--n_devices", "2",
                          "--model_save_dir", str(tmp_path / "x")])


@pytest.mark.parametrize("metric", ["cosine", "sq_euclidean"])
def test_precompute_writes_what_the_jax_package_writes(tmp_path, metric):
    rng = np.random.default_rng(0)
    src = str(tmp_path / "toy.hdf5")
    with h5py.File(src, "w") as f:
        f.create_dataset("train", data=rng.normal(size=(300, 8)).astype(np.float32))
        f.create_dataset("test", data=rng.normal(size=(20, 8)).astype(np.float32))
        f.create_dataset("neighbors", data=rng.integers(0, 300, (20, 10)))
        f.create_dataset("distances", data=rng.random((20, 10)).astype(np.float32))
    want = j_precompute(src, metric, k=7, out_path=str(tmp_path / "jax.h5"))
    got = precompute(src, metric, k=7, out_path=str(tmp_path / "port.h5"),
                     device="cpu")
    with h5py.File(want) as a, h5py.File(got) as b:
        assert set(a.keys()) == set(b.keys())
        for key in a.keys():
            np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]))
    assert precompute(src, metric, k=3, device="cpu") == src + ".processed"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            precompute(src, metric, k=3)
