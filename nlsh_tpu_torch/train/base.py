"""Trainer harness: the template-method training loop.

Port of :mod:`nlsh_tpu.train.base`.  The JAX package scans whole
segments of steps inside one compiled program, so the host steps in only
at evaluation boundaries.  Here the step is one body over device inputs
(:class:`StepProgram`), captured on the card as a CUDA graph and
replayed once per step: the host builds a segment's inputs, replays,
reads the losses once per segment and evaluates.  Per-epoch batch
composition (shuffles, positive and negative draws) is a dict of index
arrays from each learner's :meth:`Trainer.epoch_arrays`, gathered per
step on the device.

Template contract (the JAX package's):

* ``epoch_arrays(generator, params)``: per-epoch index/label arrays, each
  ``(n, ...)``, sliced ``batch_size`` rows per step;
* ``step_draws(generator, n_rows)``: a step's own random draws (the
  proposed learner's regulariser rows) from the step's CPU
  ``torch.Generator``, the JAX package's per-step key; taken before the
  segment and put into the step's batch;
* ``loss_fn(params, corpus, knn, batch, generator)``: the scalar loss of
  one batch and its draws; ``params`` is ``{"hashing": module, "extra":
  dict}``; the step passes ``generator=None``, since a captured step
  would replay one draw forever;
* ``init_extra(generator)`` (auxiliary params, e.g. the AE decoder, as a
  nested dict of tensors in the JAX layout) and
  ``init_hashing_params(generator)``.

The optimiser is optax's ``amsgrad`` (:class:`Amsgrad`), not
``torch.optim.Adam(amsgrad=True)``: optax bias-corrects the second
moment before the running max, torch after it, and the two differ
whenever the second moment shrinks.  Learning-rate schedules are optax's
formulas as functions of the update count (:func:`_make_lr`).

Everything random (init, epoch arrays, the train-probe set, the per-step
generators' seeds and draws) comes from one CPU ``torch.Generator``
seeded by ``seed`` and is moved to the device afterwards, so one seed
gives the same batches on the card and on the CPU.  The optimiser's
per-step scalars (the learning rate, the bias corrections) are a table
built on the host per segment (:meth:`Amsgrad.step_table`), so the
captured step reads each step's own.

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
import contextlib
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
from nlsh_tpu_torch.utils import graphs
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

    def step_table(self, n: int) -> np.ndarray:
        """The next ``n`` updates' scalars, ``(n, 3)`` float32: per update
        ``(lr, 1 - b1**t, 1 - b2**t)``, optax's float32 arithmetic at
        counts ``t = count + 1, ...`` (and schedule counts
        ``schedule_count, ...``).  Leaves the counts alone."""
        table = np.empty((n, 3), np.float32)
        for j in range(n):
            t = _F32(self.count + 1 + j)
            table[j, 1] = _F32(1) - _F32(self.b1) ** t
            table[j, 2] = _F32(1) - _F32(self.b2) ** t
            table[j, 0] = self.learning_rate if self.schedule_count is None \
                else self.learning_rate(self.schedule_count + j)
        return table

    def advance(self, n: int) -> None:
        """Count ``n`` updates made by :meth:`apply`."""
        self.count += n
        if self.schedule_count is not None:
            self.schedule_count += n

    @torch.no_grad()
    def apply(self, grads: list[torch.Tensor], lr: torch.Tensor,
              c1: torch.Tensor, c2: torch.Tensor) -> None:
        """One optimiser step on ``self.params`` in place from 0-d float32
        tensors on their device: the learning rate and the two bias
        corrections (a row of :meth:`step_table`).  Reads nothing on the
        host and leaves the counts alone, so a captured graph replays it
        at each step's own row; a Python divisor would also become a
        reciprocal product on the card."""
        b1, b2 = self.b1, self.b2
        neg_lr = -lr
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu,
                                        self.nu_max):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            nu_max.copy_(torch.maximum(nu_max, nu / c2))
            upd = (mu / c1) / (torch.sqrt(nu_max) + self.eps)
            p.add_(upd * neg_lr)

    def update(self, grads: list[torch.Tensor]) -> None:
        """One optimiser step on ``self.params`` in place, counted."""
        device = self.params[0].device
        # filled on the device: a host tensor copied in would wait for
        # the stream
        self.apply(grads, *(torch.full((), float(v), dtype=torch.float32,
                                       device=device)
                            for v in self.step_table(1)[0]))
        self.advance(1)


@dataclasses.dataclass
class TrainState:
    """``params`` is ``{"hashing": module (or a list of modules, one per
    table), "extra": nested dict of tensors}``, ``opt_state`` the
    :class:`Amsgrad` over them, ``step`` the updates made.
    ``step_program`` is the captured step of :meth:`Trainer.run_segment`
    on the card (a :class:`StepProgram`), or of the data-parallel runner
    on a mesh of the one card (its ``DPStepProgram``), which reads these
    params and moments by address; ``fit`` drops it when it returns."""

    params: dict
    opt_state: Amsgrad
    step: int = 0
    step_program: Any = dataclasses.field(default=None, repr=False,
                                          compare=False)


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


@contextlib.contextmanager
def fresh_leaves(params: dict):
    """``params`` with each trained tensor replaced, while entered, by a
    new leaf over the same storage: the modules' parameters are swapped
    in place (and put back on exit), the extra params' dict is copied.
    Yields the swapped ``params``; its :func:`param_leaves` are the new
    leaves, in the originals' order.

    Autograd's accumulator of a leaf remembers the stream it was made on,
    and lives as long as any graph through the leaf: a loss the caller
    still holds keeps one of the default stream alive, and a backward on
    a capture's stream would then wait on the default stream, which the
    capture refuses.  A new leaf gets its accumulator on the step's own
    stream.  Updating the originals in place updates the new leaves,
    which alias them."""
    h = params["hashing"]
    new, swapped = {}, []
    for module in (h if isinstance(h, (list, tuple)) else [h]):
        for sub in module.modules():
            for name, p in list(sub._parameters.items()):
                if p is not None:
                    if id(p) not in new:
                        new[id(p)] = nn.Parameter(p.detach(), p.requires_grad)
                    swapped.append((sub, name, p))
                    sub._parameters[name] = new[id(p)]

    def walk(extra: dict) -> dict:
        return {key: walk(v) if isinstance(v, dict) else
                v.detach().requires_grad_(v.requires_grad)
                for key, v in extra.items()}

    try:
        yield {"hashing": h, "extra": walk(params["extra"])}
    finally:
        for sub, name, p in swapped:
            sub._parameters[name] = p


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


def host_to(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``; to the card through pinned memory, so
    the copy does not wait for the stream."""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class StepProgram:
    """The optimiser step as one body over static inputs, the counterpart
    of the scan body of the JAX package's segment runner; on the card it
    is captured once (:func:`nlsh_tpu_torch.utils.graphs.capture`, with
    autograd on) and replayed once per step.

    The static inputs hold one chunk of at most ``capacity`` steps of a
    segment: the chunk's rows of every epoch array, its rows of the
    per-step draws (:meth:`Trainer.step_draws`) and of the optimiser's
    scalars (:meth:`Amsgrad.step_table`), and ``i``, the chunk-local step
    (a device int64 scalar).  The body gathers step ``i``'s batch rows,
    computes the loss and its gradients, applies the update in place,
    writes the loss into row ``i`` of ``losses`` and adds one to ``i``: it
    reads nothing on the host, so every replay is the next step.  The
    graph reads the params, the moments, the corpus and the kNN table by
    address, and the program holds them."""

    def __init__(self, key: tuple, trainer: "Trainer", state: TrainState,
                 corpus: torch.Tensor, knn: torch.Tensor, arrays: dict,
                 draws: dict, batch_size: int, capacity: int):
        self.key = key
        self.trainer, self.params, self.opt = trainer, state.params, \
            state.opt_state
        self.corpus, self.knn = corpus, knn
        self.batch_size, self.capacity = batch_size, capacity
        device = corpus.device
        self.i = torch.zeros((), dtype=torch.int64, device=device)
        self.offsets = torch.arange(batch_size, device=device)
        self.arrays = {name: a.new_empty((capacity * batch_size,
                                          *a.shape[1:]))
                       for name, a in arrays.items()}
        self.draws = {name: torch.empty((capacity, *d.shape[1:]),
                                        dtype=d.dtype, device=device)
                      for name, d in draws.items()}
        self.table = torch.empty((capacity, 3), dtype=torch.float32,
                                 device=device)
        self.losses = torch.empty(capacity, dtype=torch.float32,
                                  device=device)
        self.graph = None

    def step(self) -> None:
        """The body: one optimiser step at the chunk's step ``i``."""
        at = self.i.view(1)
        rows = self.i * self.batch_size + self.offsets
        batch = {name: a.index_select(0, rows)
                 for name, a in self.arrays.items()}
        batch.update({name: d.index_select(0, at)[0]
                      for name, d in self.draws.items()})
        with fresh_leaves(self.params) as params:
            loss = self.trainer.loss_fn(params, self.corpus, self.knn, batch,
                                        None)
            leaves = param_leaves(params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        row = self.table.index_select(0, at)[0]
        self.opt.apply([torch.zeros_like(p) if g is None else g
                        for p, g in zip(leaves, grads)],
                       row[0], row[1], row[2])
        self.losses.index_copy_(0, at, loss.detach().view(1))
        self.i.add_(1)

    def _fill(self, arrays: dict, draws: dict, first_step: int, j: int,
              n: int) -> None:
        """Copy the chunk's rows into the static inputs: epoch steps
        ``first_step, ...`` of the arrays, rows ``j, ...`` of the
        segment's draws."""
        bs = self.batch_size
        for name, a in self.arrays.items():
            a[:n * bs].copy_(arrays[name][first_step * bs:
                                          (first_step + n) * bs])
        for name, d in self.draws.items():
            d[:n].copy_(draws[name][j:j + n])

    def run(self, arrays: dict, draws: dict, table: torch.Tensor,
            seg_start: int, j: int, n: int, graphed: bool) -> torch.Tensor:
        """The segment's steps ``j, ..., j + n - 1`` (``n <= capacity``;
        ``draws`` and ``table``: the segment's, on the device): replays
        of the graph where ``graphed`` (the first one captured after its
        warm-up, which is the chunk's first step), else the body run
        eagerly; returns the ``(n,)`` losses."""
        with torch.no_grad():
            self._fill(arrays, draws, seg_start + j, j, n)
            self.table[:n].copy_(table[j:j + n])
            self.i.zero_()
        done = 0
        if graphed and self.graph is None:
            self.graph = graphs.capture(self.step, (), self.corpus.device,
                                        grad=True)
            done = 1
        with torch.enable_grad():
            for _ in range(done, n):
                if graphed:
                    self.graph.replay()
                else:
                    self.step()
        return self.losses[:n].clone()


def _program_key(trainer, state, corpus, knn, arrays, draws,
                 batch_size, step_dims: int = 1) -> tuple:
    """What a :class:`StepProgram` is built for: a program is replayed
    only for the same trainer, state, corpus and kNN (by address) and
    the same batch size, array and draw shapes (a draw's shape past its
    first ``step_dims`` dimensions)."""
    return (id(trainer), id(state.params), id(state.opt_state),
            corpus.device, corpus.data_ptr(), tuple(corpus.shape),
            knn.data_ptr(), tuple(knn.shape), batch_size,
            tuple((name, a.dtype, tuple(a.shape[1:]))
                  for name, a in arrays.items()),
            tuple((name, d.dtype, tuple(d.shape[step_dims:]))
                  for name, d in draws.items()))


def held_program(state: TrainState, key: tuple, graphed: bool,
                 make: Callable[[], StepProgram]) -> StepProgram:
    """The program a segment runs: the state's captured one where
    ``graphed`` and its key is ``key``, else a new one from ``make()``
    (held by the state where ``graphed``; the old graph's pool is
    dropped first).  An eager segment builds its own, never held."""
    if not graphed:
        return make()
    if state.step_program is None or state.step_program.key != key:
        state.step_program = None
        state.step_program = make()
    return state.step_program


def run_chunks(state: TrainState, program: StepProgram, arrays: dict,
               draws: dict, table: torch.Tensor, seg_start: int,
               n_steps: int, graphed: bool):
    """A segment of ``n_steps`` as chunks of the program's capacity;
    counts the steps on the state and its optimiser.  Returns the state
    and the ``(n_steps,)`` losses."""
    losses = [program.run(arrays, draws, table, seg_start, j,
                          min(program.capacity, n_steps - j), graphed)
              for j in range(0, n_steps, program.capacity)]
    state.opt_state.advance(n_steps)
    state.step += n_steps
    return state, torch.cat(losses)


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

    def step_draws(self, generator: torch.Generator,
                   n_rows: int) -> dict[str, torch.Tensor]:
        """The random draws of one step, taken from the step's own CPU
        generator before the segment and handed to :meth:`loss_fn` in
        its batch (``n_rows``: the corpus's); none by default."""
        return {}

    # -- the steps ------------------------------------------------------------
    def segment_draws(self, step_seed: int, seg_start: int, n_steps: int,
                      n_rows: int) -> dict[str, torch.Tensor]:
        """Every step's :meth:`step_draws`, stacked ``(n_steps, ...)`` on
        the CPU: step ``s`` draws from a generator seeded ``step_seed +
        s``, in step order, as a loop of eager steps would."""
        per_step = [self.step_draws(torch.Generator().manual_seed(
            step_seed + s), n_rows) for s in range(seg_start,
                                                   seg_start + n_steps)]
        return {name: torch.stack([d[name] for d in per_step])
                for name in per_step[0]}

    def run_segment(self, state: TrainState, corpus: torch.Tensor,
                    knn: torch.Tensor, arrays: dict, seg_start: int,
                    n_steps: int, batch_size: int, step_seed: int = 0):
        """``n_steps`` optimiser steps on the epoch's steps ``seg_start,
        seg_start + 1, ...``: step ``s`` takes rows ``[s * batch_size,
        (s + 1) * batch_size)`` of every array in ``arrays`` and the
        draws of a CPU generator seeded ``step_seed + s`` (the epoch
        step, not the segment-local one, so the segments of one epoch
        never replay each other's draws).  Updates ``state`` in place;
        returns it and the ``(n_steps,)`` losses, on the device.

        On the card every step is a replay of the state's captured
        :class:`StepProgram` (captured at its first segment, whose first
        step is the capture's warm-up); a segment longer than the
        program's capacity, the first segment's length, runs as chunks
        of it.  CPU tensors run the same body eagerly."""
        return self._segment(state, corpus, knn, arrays, seg_start, n_steps,
                             batch_size, step_seed, corpus.is_cuda)

    def _run_segment_eager(self, state, corpus, knn, arrays, seg_start,
                           n_steps, batch_size, step_seed=0):
        """:meth:`run_segment` with the body run eagerly on any device:
        the reference the card's replays are held to."""
        return self._segment(state, corpus, knn, arrays, seg_start, n_steps,
                             batch_size, step_seed, False)

    def _segment(self, state, corpus, knn, arrays, seg_start, n_steps,
                 batch_size, step_seed, graphed: bool):
        device = corpus.device
        draws = {name: host_to(d, device) for name, d in self.segment_draws(
            step_seed, seg_start, n_steps, corpus.shape[0]).items()}
        table = host_to(torch.from_numpy(state.opt_state.step_table(n_steps)),
                        device)
        key = _program_key(self, state, corpus, knn, arrays, draws,
                           batch_size)
        program = held_program(state, key, graphed, lambda: StepProgram(
            key, self, state, corpus, knn, arrays, draws, batch_size,
            n_steps))
        return run_chunks(state, program, arrays, draws, table, seg_start,
                          n_steps, graphed)

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
        (:func:`nlsh_tpu_torch.parallel.dp.build_dp_segment_runner`; on a
        mesh of one card every step is a replay of one captured graph,
        held on the state as the meshless step's is), and the state lives
        on its first device (``device`` is not used)."""
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
        state.step_program = None  # the step's graph, and its pool
        return state
