"""The port's trainers end to end on the CPU (``fit(device="cpu")``): the
behaviour the JAX package's ``tests/test_trainers.py`` holds its own
trainers to (a short fit per learner, a falling loss with logged
metrics, the recall-only checkpoint gate, per-step draws that differ
across segments, the cosine schedule), plus what is the port's own: one
seed gives the same run, a CUDA request without a card raises, the
checkpoint files load and ``resume_from`` continues at the saved step."""

import json
import os

import numpy as np
import pytest
import torch

from nlsh_tpu_torch import train as T
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.parallel import make_mesh
from nlsh_tpu_torch.utils import checkpoint as tckpt
from nlsh_tpu_torch.utils.loggers import JSONLLogger
from torch_train_common import make_data

DATA = make_data(n=512, nq=64, d=8, k=10)
FIT = dict(K=5, batch_size=64, epochs=1, test_every_updates=4, max_steps=8,
           hash_times=3, device="cpu")


def _head(bits=4, seed=None):
    h = get_hashing("MultivariateBernoulli", get_encoder("mlp", 8, [16]), bits)
    return h if seed is None else h.init(torch.Generator().manual_seed(seed))


LEARNERS = {
    "random": lambda h, d, **kw: T.TripletTrainer(h, DATA, d, positive_k=5,
                                                  **kw),
    "nearest": lambda h, d, **kw: T.TripletTrainer(
        h, DATA, d, positive_k=5, negative_sampling_method="nearest", **kw),
    "hard": lambda h, d, **kw: T.TripletTrainer(
        h, DATA, d, positive_k=5, negative_sampling_method="hard", **kw),
    "semi-hard": lambda h, d, **kw: T.TripletTrainer(
        h, DATA, d, positive_k=5, negative_sampling_method="semi-hard", **kw),
    "siamese": lambda h, d, **kw: T.SiameseTrainer(h, DATA, d,
                                                   positive_rate=0.3, **kw),
    "siamese-locally": lambda h, d, **kw: T.SiameseTrainer(
        h, DATA, d, locally=True, inner_k=3, outer_k=8, **kw),
    "proposed": lambda h, d, **kw: T.ProposedTrainer(
        h, DATA, d, train_k=5, lambda1=0.01, n_reg_samples=256, **kw),
    "ae": lambda h, d, **kw: T.AETrainer(h, DATA, d, decoder_hidden=32, **kw),
    "vqvae": lambda h, d, **kw: T.VQVAETrainer(h, DATA, d, **kw),
    "ensemble": lambda h, d, **kw: T.MultiTableTrainer(
        T.TripletTrainer(h, DATA, d, positive_k=5, balance_lambda=1.0, **kw), 3),
}


def _finite(state) -> bool:
    from nlsh_tpu_torch.train.base import param_leaves

    return all(bool(torch.isfinite(p).all()) for p in param_leaves(state.params))


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_each_learner_fits_on_the_cpu(name, tmp_path):
    state = LEARNERS[name](_head(), str(tmp_path)).fit(**FIT)
    assert state.step == 8 and state.opt_state.count == 8
    assert _finite(state)
    if name == "ae":
        assert set(state.params["extra"]) == {"fc1", "fc2"}
    if name == "vqvae":
        assert state.params["extra"]["codebook"].shape == (4, 8)
    if name == "ensemble":
        assert len(state.params["hashing"]) == 3
    # the evals at steps 4 and 8 checkpoint at least once, in both formats
    states = [f for f in os.listdir(tmp_path) if f.endswith(".state")]
    assert states, os.listdir(tmp_path)
    base = str(tmp_path / states[0][:-len(".state")])
    loaded = tckpt.load_model(base, device="cpu")
    assert isinstance(loaded, list) == (name == "ensemble")


def test_triplet_training_reduces_loss_and_logs(tmp_path):
    log_path = tmp_path / "run.jsonl"
    tr = T.TripletTrainer(_head(bits=5), DATA, str(tmp_path),
                          logger=JSONLLogger(str(log_path)), positive_k=5,
                          margin=0.5)
    tr.fit(K=5, batch_size=64, learning_rate=3e-3, epochs=25,
           test_every_updates=100, max_steps=200, hash_times=3, device="cpu")
    records = [json.loads(line) for line in log_path.read_text().splitlines()]
    metrics = {}
    for r in records:
        if r["kind"] == "metric":
            metrics.setdefault(r["name"], []).append((r["step"], r["value"]))
    losses = [v for _, v in metrics["training/loss"]]
    assert [s for s, _ in metrics["training/loss"]] == list(range(1, 201))
    assert np.mean(losses[:20]) > np.mean(losses[-20:])
    assert {"test/n_indexes", "test/std_index_rows", "test/recall",
            "test/query_size", "test/qps", "training/recall",
            "training/query_size"} <= set(metrics)
    assert [s for s, _ in metrics["test/recall"]] == [104, 200]
    assert all(0.0 <= v <= 1.0 for _, v in metrics["test/recall"])


def test_checkpoint_gate_is_recall_only(tmp_path, monkeypatch):
    """A model whose recall improves while its query size grows is still
    saved: the gate is recall-only."""
    tr = T.TripletTrainer(_head(), DATA, str(tmp_path), positive_k=5)
    script = iter([(0.5, 100.0), (0.7, 500.0), (0.6, 50.0)])
    saved = []
    monkeypatch.setattr(tr, "_evaluate", lambda *a, **k: next(script))
    monkeypatch.setattr(tr, "save_checkpoint",
                        lambda state, recall: saved.append(recall))
    tr.fit(**{**FIT, "epochs": 3, "test_every_updates": 2, "max_steps": 6})
    assert saved == [0.5, 0.7]


def test_step_draws_differ_across_segments_and_epochs(tmp_path):
    """Each step's generator is seeded by the epoch's seed plus the EPOCH
    step, so the segments of one epoch never replay each other's draws."""
    seeds = []

    class Recorder(T.ProposedTrainer):
        def _reg_samples(self, n, generator):
            seeds.append(generator.initial_seed())
            return super()._reg_samples(n, generator)

    tr = Recorder(_head(), DATA, str(tmp_path), train_k=5, n_reg_samples=64)
    # 512 rows / 64 = 8 steps an epoch, segments of 2: 4 segments an epoch
    tr.fit(**{**FIT, "epochs": 2, "test_every_updates": 2, "max_steps": 16})
    assert len(seeds) == 16 and len(set(seeds)) == 16
    assert seeds[1] - seeds[0] == 1 and seeds[8] - seeds[0] != 8


def test_one_seed_gives_one_run(tmp_path):
    a = LEARNERS["random"](_head(), str(tmp_path / "a")).fit(**FIT, seed=3)
    b = LEARNERS["random"](_head(), str(tmp_path / "b")).fit(**FIT, seed=3)
    c = LEARNERS["random"](_head(), str(tmp_path / "c")).fit(**FIT, seed=4)
    for x, y in zip(a.opt_state.params, b.opt_state.params):
        assert torch.equal(x, y)
    assert not torch.equal(a.opt_state.params[0], c.opt_state.params[0])


def test_fit_with_cosine_schedule(tmp_path):
    state = LEARNERS["random"](_head(), str(tmp_path)).fit(
        **FIT, lr_schedule="cosine", warmup_steps=2)
    assert state.step == 8 and state.opt_state.schedule_count == 8
    assert _finite(state)


def test_resume_continues_at_the_saved_step(tmp_path):
    first = LEARNERS["random"](_head(), str(tmp_path)).fit(**FIT)
    path = sorted((f for f in os.listdir(tmp_path) if f.endswith(".state")),
                  key=lambda f: int(f.split("_")[1]))[-1]
    saved_step = int(path.split("_")[1])
    resumed = LEARNERS["random"](_head(), str(tmp_path / "more")).fit(
        **{**FIT, "max_steps": saved_step + 3},
        resume_from=str(tmp_path / path))
    assert resumed.step == saved_step + 3
    assert resumed.opt_state.count == saved_step + 3
    assert first.step == 8


def test_cuda_without_a_card_raises_and_mesh_is_not_ported(tmp_path):
    """A CUDA request without a card raises; ``fit(mesh=)`` (the
    data-parallel path, ported now) runs on a CPU mesh for every
    learner family's segment and refuses a batch the mesh does not
    divide."""
    tr = LEARNERS["random"](_head(), str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tr.fit(**{**FIT, "device": "cuda"})
        with pytest.raises(ValueError, match="only 0 available"):
            make_mesh(2)
    for name in ("random", "proposed", "ensemble"):
        state = LEARNERS[name](_head(), str(tmp_path / name)).fit(
            **FIT, mesh=make_mesh(2, platform="cpu"))
        assert state.step == 8 and _finite(state), name
    with pytest.raises(ValueError, match="not divisible"):
        tr.fit(**{**FIT, "batch_size": 63}, mesh=make_mesh(2, platform="cpu"))
