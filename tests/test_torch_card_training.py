"""Training on the card: the same steps on the card and on the CPU from
the same init and the same index arrays (the step's loss and every
gradient within rtol 1e-4 of the tensor's largest magnitude, 20 steps'
losses within rtol 1e-3), and ``fit`` on the card evaluating through the
CUDA kernels (K1 for one table, K3 for an ensemble).  Every test needs a
CUDA GPU (``cuda`` marker) and skips without one.  Imports no JAX:

    python -m pytest -m cuda tests/test_torch_card_training.py
"""

import copy

import numpy as np
import pytest
import torch

from nlsh_tpu_torch import train as T
from nlsh_tpu_torch.models import get_encoder, get_hashing
from nlsh_tpu_torch.ops.cuda import query_kernel as qk
from nlsh_tpu_torch.parallel import init_multi_table
from nlsh_tpu_torch.train.base import device_arrays, param_leaves

N, D, BS, STEPS = 4096, 32, 256, 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


class _Data:
    def __init__(self, seed=0, n=N, nq=128, k=10):
        rng = np.random.default_rng(seed)
        centers = rng.normal(size=(32, D))
        pts = centers[rng.integers(0, 32, n + nq)] + 0.3 * rng.normal(
            size=(n + nq, D))
        pts = (pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(
            np.float32)
        self.training, self.testing = pts[:n], pts[n:]
        sim = self.training.astype(np.float64) @ self.training.T
        np.fill_diagonal(sim, -np.inf)
        self.training_self_knn = np.argsort(-sim, axis=1)[:, :k].astype(np.int32)
        self.ground_truth = np.argsort(
            -(self.testing.astype(np.float64) @ self.training.T),
            axis=1)[:, :k].astype(np.int32)
        self.metric, self.prepared, self.dim = "cosine", True, D

    def load(self):
        return self


DATA = _Data()


def _head():
    return get_hashing("MultivariateBernoulli", get_encoder("siren", D, [64, 64]),
                       8).init(torch.Generator().manual_seed(0))


def _arrays(n_tables=None):
    rng = np.random.default_rng(1)
    shape = (STEPS * BS,) if n_tables is None else (STEPS * BS, n_tables)
    return {"anchor": rng.integers(0, N, shape), "col": rng.integers(0, 5, shape),
            "neg": rng.integers(0, N, shape)}


def _inputs(device):
    return (torch.as_tensor(DATA.training, device=device),
            torch.as_tensor(DATA.training_self_knn.astype(np.int64),
                            device=device))


def _close(got, want, rtol):
    got, want = got.detach().cpu(), want.detach().cpu()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * scale)


def _both(trainer, hashing, device, n_tables=None):
    """One step's loss and gradients, then 20 steps' losses, on the CPU
    and on ``device`` from the same params and arrays."""
    out = []
    for dev in ("cpu", device):
        h = [copy.deepcopy(m).to(dev) for m in hashing] \
            if isinstance(hashing, list) else copy.deepcopy(hashing).to(dev)
        params = {"hashing": h, "extra": {}}
        corpus, knn = _inputs(dev)
        arrays = device_arrays(_arrays(n_tables), dev)
        batch = {k: v[:BS] for k, v in arrays.items()}
        loss = trainer.loss_fn(params, corpus, knn, batch,
                               torch.Generator().manual_seed(0))
        grads = torch.autograd.grad(loss, param_leaves(params))
        state = trainer.make_state(params, 1e-3)
        _, losses = trainer.run_segment(state, corpus, knn, arrays, 0, STEPS,
                                        BS)
        out.append((loss, grads, losses))
    (l0, g0, s0), (l1, g1, s1) = out
    _close(l1, l0, 1e-4)
    for a, b in zip(g1, g0):
        _close(a, b, 1e-4)
    _close(s1, s0, 1e-3)


@pytest.mark.cuda
def test_triplet_steps_on_the_card_match_the_cpu(cuda_device):
    tr = T.TripletTrainer(_head(), DATA, positive_k=5, margin=0.5,
                          balance_lambda=1.5)
    _both(tr, _head(), cuda_device)


@pytest.mark.cuda
def test_ensemble_steps_on_the_card_match_the_cpu(cuda_device):
    inner = T.TripletTrainer(_head(), DATA, positive_k=5, margin=0.5,
                             balance_lambda=1.5)
    tables = init_multi_table(_head(), 2, torch.Generator().manual_seed(1))
    _both(T.MultiTableTrainer(inner, 2), tables, cuda_device, n_tables=2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tables,kernel", [(1, "grouped_scores_topk"),
                                             (3, "windowed_scores_topk")])
def test_fit_on_the_card_evaluates_through_the_kernels(cuda_device, tmp_path,
                                                       n_tables, kernel):
    tr = T.TripletTrainer(_head(), DATA, str(tmp_path), positive_k=5,
                          margin=0.5, balance_lambda=1.5)
    if n_tables > 1:
        tr = T.MultiTableTrainer(tr, n_tables)
    for name in qk.KERNEL_LAUNCHES:
        qk.KERNEL_LAUNCHES[name] = 0
    state = tr.fit(K=10, batch_size=BS, epochs=2, test_every_updates=8,
                   max_steps=16, hash_times=4, probe_mode="flip",
                   device=cuda_device)
    assert state.step == 16
    assert qk.KERNEL_LAUNCHES[kernel] >= 2       # two evals, val + probe
    assert any(p.name.endswith(".state") for p in tmp_path.iterdir())
