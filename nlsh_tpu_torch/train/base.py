"""Trainer harness: the template-method training loop.

Port of :mod:`nlsh_tpu.train.base`.  The JAX package scans whole
segments of steps inside one compiled program; here a segment is a
Python loop of eager steps on the device, with the losses kept on the
device and read once per segment.  Per-epoch batch composition
(shuffles, positive and negative draws) is a dict of index arrays from
each learner's :meth:`Trainer.epoch_arrays`, sliced per step.

Template contract (the JAX package's):

* ``epoch_arrays(generator, params)``: per-epoch index/label arrays, each
  ``(n, ...)``, sliced ``batch_size`` rows per step;
* ``loss_fn(params, corpus, knn, batch, generator)``: the scalar loss of
  one batch; ``params`` is ``{"hashing": module, "extra": dict}`` and
  ``generator`` is the step's own CPU ``torch.Generator`` (the JAX
  package's per-step key);
* ``init_extra(generator)`` (auxiliary params, e.g. the AE decoder, as a
  nested dict of tensors in the JAX layout) and
  ``init_hashing_params(generator)``.

The optimiser is optax's ``amsgrad`` (:class:`Amsgrad`), not
``torch.optim.Adam(amsgrad=True)``: optax bias-corrects the second
moment before the running max, torch after it, and the two differ
whenever the second moment shrinks.  Learning-rate schedules are optax's
formulas as functions of the update count (:func:`_make_lr`).

Everything random (init, epoch arrays, the train-probe set, the per-step
generators' seeds) comes from one CPU ``torch.Generator`` seeded by
``seed`` and is moved to the device afterwards, so one seed gives the
same batches on the card and on the CPU.

Evaluation every ``test_every_updates`` steps builds an
:class:`~nlsh_tpu_torch.index.indexer.Indexer` over the live module (the
grouped engine, kernel K1 on the card) and logs ``test/n_indexes``,
``test/std_index_rows``, ``test/recall``, ``test/query_size``,
``test/qps``, ``training/recall`` and ``training/query_size``; a model
is checkpointed whenever its recall improves (recall only, the JAX
package's gate), as ``{run_name}_{step}_{recall:.4f}`` plus a ``.state``
file in the JAX package's format.
"""

from __future__ import annotations

import abc
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from nlsh_tpu_torch.index.indexer import Indexer
from nlsh_tpu_torch.utils import checkpoint as ckpt
from nlsh_tpu_torch.utils.loggers import NullLogger
from nlsh_tpu_torch.utils.metrics import calculate_recall

_F32 = np.float32


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine
    without one raises (the port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return device


# ---------------------------------------------------------------------------
# learning-rate schedules: optax's formulas, in float32, of the count of
# updates made before the one they scale (optax's scale_by_schedule)
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int) -> Callable[[int], Any]:
    """``optax.linear_schedule(init, end, steps)``."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int):
        c = _F32(min(max(count, 0), steps))
        return _F32(init - end) * (_F32(1) - c / _F32(steps)) + _F32(end)

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], Any]:
    """``optax.cosine_decay_schedule(init, decay_steps, alpha)``."""

    def schedule(count: int):
        c = np.minimum(_F32(count), _F32(decay_steps))
        decay = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c
                                              / _F32(decay_steps)))
        return _F32(init) * (_F32(1 - alpha) * decay + _F32(alpha))

    return schedule


def _join(first, second, boundary: int) -> Callable[[int], Any]:
    """``optax.join_schedules([first, second], [boundary])``: the second
    schedule counts from the boundary."""
    return lambda count: first(count) if count < boundary \
        else second(count - boundary)


def _make_lr(schedule: str, peak: float, total_steps: int,
             warmup_steps: int = 0, end_frac: float = 0.05):
    """A float (constant) or a schedule ``count -> lr`` (see
    :meth:`Trainer.fit`)."""
    if schedule == "constant":
        return peak
    total = max(int(total_steps), 1)
    warm = min(int(warmup_steps), total - 1) if warmup_steps else 0
    end = peak * end_frac
    if schedule == "cosine":
        if warm:  # optax.warmup_cosine_decay_schedule(0, peak, warm, total, end)
            alpha = 0.0 if peak == 0.0 else end / peak
            return _join(_linear(0.0, peak, warm),
                         _cosine(peak, total - warm, alpha), warm)
        return _cosine(peak, total, end_frac)
    if schedule == "linear":
        sched = _linear(peak, end, total - warm)
        return _join(_linear(0.0, peak, warm), sched, warm) if warm else sched
    raise ValueError(f"unknown lr_schedule {schedule!r} "
                     "(constant|cosine|linear)")


class Amsgrad:
    """optax's ``amsgrad(learning_rate)`` (its defaults: b1 0.9, b2
    0.999, eps 1e-8, eps_root 0) over a list of tensors: the first and
    second moments, the second bias-corrected BEFORE the running max
    (``nu_max = max(nu_max, nu / (1 - b2**t))``), then
    ``-lr * mu_hat / (sqrt(nu_max) + eps)``.  ``learning_rate`` is a
    float or a schedule of the update count, which then has a count of
    its own (``schedule_count``, optax's second state)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: list[torch.Tensor], learning_rate):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.count = 0
        self.schedule_count = 0 if callable(learning_rate) else None
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> None:
        """One optimiser step on ``self.params`` in place."""
        self.count += 1
        t = _F32(self.count)
        # optax's bias corrections, in float32
        bc1 = _F32(1) - _F32(self.b1) ** t
        bc2 = _F32(1) - _F32(self.b2) ** t
        if self.schedule_count is None:
            lr = self.learning_rate
        else:
            lr = float(self.learning_rate(self.schedule_count))
            self.schedule_count += 1
        b1, b2 = self.b1, self.b2
        # filled on the device: a host tensor copied in would wait for
        # the stream, and a Python divisor becomes a reciprocal product
        device = self.params[0].device
        c1 = torch.full((), float(bc1), dtype=torch.float32, device=device)
        c2 = torch.full((), float(bc2), dtype=torch.float32, device=device)
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu,
                                        self.nu_max):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            nu_max.copy_(torch.maximum(nu_max, nu / c2))
            upd = (mu / c1) / (torch.sqrt(nu_max) + self.eps)
            p.add_(upd * -lr)


@dataclasses.dataclass
class TrainState:
    """``params`` is ``{"hashing": module (or a list of modules, one per
    table), "extra": nested dict of tensors}``, ``opt_state`` the
    :class:`Amsgrad` over them, ``step`` the updates made."""

    params: dict
    opt_state: Amsgrad
    step: int = 0


def param_leaves(params: dict) -> list[torch.Tensor]:
    """Every trained tensor of ``params``: the hashing modules'
    parameters, then the extra params in sorted-key order."""
    h = params["hashing"]
    leaves = [p for m in (h if isinstance(h, (list, tuple)) else [h])
              for p in m.parameters()]

    def walk(extra: dict):
        for key in sorted(extra):
            v = extra[key]
            if isinstance(v, dict):
                walk(v)
            else:
                leaves.append(v)

    walk(params["extra"])
    return leaves


def extra_to(extra: dict, device) -> dict:
    """The extra params' nested dict as trainable leaves on ``device``."""
    return {key: extra_to(v, device) if isinstance(v, dict) else
            v.detach().to(device=device, dtype=torch.float32).requires_grad_()
            for key, v in extra.items()}


def device_arrays(arrays: dict, device) -> dict:
    """Epoch arrays (tensors or numpy) on ``device``: integer arrays as
    int64 indices, the rest float32."""
    out = {}
    for name, arr in arrays.items():
        t = torch.as_tensor(arr)
        dtype = torch.float32 if t.is_floating_point() else torch.int64
        out[name] = t.to(device=device, dtype=dtype)
    return out


def _corpus_tensor(data, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(data.training, np.float32), device=device)


class Trainer(abc.ABC):
    """Template-method trainer."""

    def __init__(self, hashing: nn.Module, data, model_save_dir=None,
                 logger=None):
        self.hashing = hashing
        self.data = data
        self.model_save_dir = model_save_dir or os.path.join(
            tempfile.gettempdir(), "nlsh_models")
        self.logger = logger or NullLogger()

    # -- template hooks ------------------------------------------------------
    @abc.abstractmethod
    def epoch_arrays(self, generator: torch.Generator,
                     params: dict) -> dict[str, torch.Tensor]:
        """Per-epoch index/label arrays, each ``(n_train, ...)``."""

    @abc.abstractmethod
    def loss_fn(self, params: dict, corpus: torch.Tensor, knn: torch.Tensor,
                batch: dict[str, torch.Tensor],
                generator: torch.Generator) -> torch.Tensor:
        """Scalar loss of one batch."""

    def init_extra(self, generator: torch.Generator) -> dict:
        return {}

    def init_hashing_params(self, generator: torch.Generator):
        """The module(s) to train, drawn from ``generator``; ensemble
        trainers return one module per table."""
        return self.hashing.init(generator)

    def make_state(self, params: dict, learning_rate) -> TrainState:
        """A fresh :class:`TrainState` (step 0, zero moments) over
        ``params``."""
        return TrainState(params, Amsgrad(param_leaves(params), learning_rate))

    def save_checkpoint(self, state: TrainState, recall: float) -> None:
        base = (f"{self.model_save_dir}/{self.logger.run_name}"
                f"_{state.step}_{recall:.4f}")
        ckpt.save_model(base, state.params["hashing"])
        ckpt.save_train_state(base + ".state", state)

    # -- the steps ------------------------------------------------------------
    def run_segment(self, state: TrainState, corpus: torch.Tensor,
                    knn: torch.Tensor, arrays: dict, seg_start: int,
                    n_steps: int, batch_size: int, step_seed: int = 0):
        """``n_steps`` optimiser steps on the epoch's steps ``seg_start,
        seg_start + 1, ...``: step ``s`` takes rows ``[s * batch_size,
        (s + 1) * batch_size)`` of every array in ``arrays`` and a CPU
        generator seeded ``step_seed + s`` (the epoch step, not the
        segment-local one, so the segments of one epoch never replay each
        other's draws).  Updates ``state`` in place; returns it and the
        ``(n_steps,)`` losses, on the device."""
        leaves = state.opt_state.params
        losses = []
        for i in range(n_steps):
            s = seg_start + i
            batch = {name: arr[s * batch_size:(s + 1) * batch_size]
                     for name, arr in arrays.items()}
            gen = torch.Generator().manual_seed(step_seed + s)
            loss = self.loss_fn(state.params, corpus, knn, batch, gen)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            state.opt_state.update([torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)])
            state.step += 1
            losses.append(loss.detach())
        return state, torch.stack(losses)

    # -- evaluation -------------------------------------------------------------
    def _evaluate(self, params, corpus, val, ground_truth, probe_train,
                  probe_gt, K, hash_times, step, eval_seed,
                  probe_mode: str = "sample") -> tuple[float, float]:
        """Index the corpus with the live module, query the validation
        set and the train probe, log; returns ``(recall, query_size)``."""
        hashing = params["hashing"]
        try:
            indexer = Indexer(hashing, corpus, device=corpus.device,
                              metric=self.data.metric)
            # a power-of-two budget, as the JAX package rounds it
            indexer.probe_budget = _next_pow2(indexer.probe_budget)
            self.logger.log("test/n_indexes", indexer.n_buckets_used(), step)
            self.logger.log("test/std_index_rows", indexer.occupancy_std(),
                            step)

            def query(q):
                gen = torch.Generator(device=corpus.device).manual_seed(
                    eval_seed)
                return indexer.query(q, k=K, hash_times=hash_times,
                                     generator=gen, probe_mode=probe_mode)

            t1 = time.perf_counter()
            topk, n_cand = query(val)
            t2 = time.perf_counter()
            recall = float(calculate_recall(ground_truth, topk, np.mean))
            query_size = float(np.mean(n_cand))
            self.logger.log("test/recall", recall, step)
            self.logger.log("test/query_size", query_size, step)
            self.logger.log("test/qps", val.shape[0] / (t2 - t1), step)
            topk_t, n_cand_t = query(probe_train)
            self.logger.log("training/recall",
                            calculate_recall(probe_gt, topk_t, np.mean), step)
            self.logger.log("training/query_size", float(np.mean(n_cand_t)),
                            step)
        finally:
            hashing.train()
        return recall, query_size

    # -- the loop -----------------------------------------------------------------
    def fit(self, K: int = 10, batch_size: int = 1024,
            learning_rate: float = 3e-4, test_every_updates: int = 1000,
            epochs: int = 100, hash_times: int = 10,
            probe_mode: str = "sample", seed: int = 0,
            n_train_probe: int = 10000, max_steps: int | None = None,
            resume_from: str | None = None, mesh=None,
            lr_schedule: str = "constant", warmup_steps: int = 0,
            lr_end_frac: float = 0.05, device="cuda") -> TrainState:
        """Train (the JAX package's ``fit``, same defaults) on ``device``.

        ``lr_schedule``: ``"constant"``, ``"cosine"`` or ``"linear"``
        decay to ``learning_rate * lr_end_frac`` over the run, with an
        optional linear ``warmup_steps`` ramp.  ``resume_from``: a
        ``.state`` file of either package.  ``mesh``: a 1-D
        :class:`~nlsh_tpu_torch.parallel.mesh.Mesh`; each step's batch is
        then split over its entries with the gradients ``pmean``-ed
        (:func:`nlsh_tpu_torch.parallel.dp.build_dp_segment_runner`), and
        the state lives on its first device (``device`` is not used)."""
        if mesh is not None:
            from nlsh_tpu_torch.parallel.dp import build_dp_segment_runner

            device = mesh.devices[0]
            dp_segment = build_dp_segment_runner(self, batch_size, mesh)
        device = resolve_device(device)
        if not self.data.prepared:
            self.data.load()
        gen = torch.Generator().manual_seed(seed)
        corpus = _corpus_tensor(self.data, device)
        val = torch.as_tensor(np.asarray(self.data.testing, np.float32),
                              device=device)
        ground_truth = np.asarray(self.data.ground_truth)[:, :K]
        knn_np = np.asarray(self.data.training_self_knn)
        knn = torch.as_tensor(knn_np.astype(np.int64), device=device)
        n = corpus.shape[0]

        # the train-set overfit probe
        probe_idx = torch.randint(0, n, (min(n_train_probe, n),),
                                  generator=gen)
        probe_train = corpus[probe_idx.to(device)]
        probe_gt = knn_np[probe_idx.numpy(), :K]

        hashing = self.init_hashing_params(gen)
        hashing = [h.to(device) for h in hashing] \
            if isinstance(hashing, (list, tuple)) else hashing.to(device)
        params = {"hashing": hashing,
                  "extra": extra_to(self.init_extra(gen), device)}
        n_batches = n // batch_size
        if n_batches == 0:
            raise ValueError(f"batch_size {batch_size} exceeds corpus size {n}")
        n_usable = n_batches * batch_size

        total_steps = max_steps if max_steps is not None \
            else epochs * n_batches
        lr = _make_lr(lr_schedule, learning_rate, total_steps, warmup_steps,
                      lr_end_frac)
        state = self.make_state(params, lr)
        if resume_from:
            ckpt.load_train_state(resume_from, state)

        best_recall = 0.0
        stop = False
        last_eval_bucket = 0  # one eval per test_every_updates steps
        for _ in range(epochs):
            arrays = self.epoch_arrays(gen, state.params)
            step_seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
            arrays = device_arrays({k: v[:n_usable] for k, v in arrays.items()},
                                   device)
            done = 0
            while done < n_batches and not stop:
                seg = min(test_every_updates, n_batches - done)
                if max_steps is not None:
                    seg = min(seg, max_steps - state.step)
                    if seg <= 0:
                        stop = True
                        break
                if mesh is None:
                    state, losses = self.run_segment(
                        state, corpus, knn, arrays, done, seg, batch_size,
                        step_seed)
                else:
                    state, losses = dp_segment(state, corpus, knn, arrays,
                                               done, seg, step_seed)
                base_step = state.step - seg
                for i, loss in enumerate(losses.cpu().numpy()):
                    self.logger.log("training/loss", float(loss),
                                    base_step + i + 1)
                done += seg
                # evaluate at the first segment boundary past each
                # multiple of test_every_updates
                eval_bucket = state.step // test_every_updates
                if eval_bucket > last_eval_bucket:
                    last_eval_bucket = eval_bucket
                    recall, _ = self._evaluate(
                        state.params, corpus, val, ground_truth, probe_train,
                        probe_gt, K, hash_times, state.step, seed + 1,
                        probe_mode)
                    # recall-only gate: the reference's best_query_size is
                    # never updated, so its AND gate is recall-only
                    if recall > best_recall:
                        best_recall = recall
                        self.save_checkpoint(state, recall)
            if stop:
                break
        return state
