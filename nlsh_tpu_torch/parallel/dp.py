"""Data-parallel training over a mesh.

Port of :mod:`nlsh_tpu.parallel.dp`.  Each entry of the mesh owns a
contiguous block of the epoch's batch-composition arrays (and so a slice
of every global batch), computes the loss and gradients of its slice,
and the gradients and loss are
:func:`~nlsh_tpu_torch.parallel.mesh.pmean`-ed (in entry order, then
across processes) before one amsgrad update of the trainer's state.

On a mesh whose entries all name one device in one process
(:meth:`~nlsh_tpu_torch.parallel.mesh.Mesh.on_one_device`) the entries
share the state's own parameters and the whole step is one body over
device inputs (:class:`DPStepProgram`, the counterpart of the JAX
package's scan body inside ``shard_map``): on the card it is captured
once and replayed once per step, on the CPU it runs eagerly.  Other
meshes (several devices, several processes, whose collectives a graph
cannot capture) run a loop of eager steps: each entry on another device
than the state's computes on a replica of the parameters, which is set
to the updated parameters after every step.
"""

from __future__ import annotations

import copy

import torch

from nlsh_tpu_torch.parallel.mesh import Mesh, pmean
from nlsh_tpu_torch.train.base import (
    StepProgram,
    _program_key,
    extra_to,
    fresh_leaves,
    held_program,
    host_to,
    param_leaves,
    run_chunks,
)


def _replica(params: dict, dev) -> dict:
    """``params`` copied to ``dev``: the hashing module(s) and the extra
    leaves."""
    h = params["hashing"]
    hashing = [copy.deepcopy(m).to(dev) for m in h] \
        if isinstance(h, (list, tuple)) else copy.deepcopy(h).to(dev)
    return {"hashing": hashing, "extra": extra_to(params["extra"], dev)}


def entry_seed(epoch_step: int, entry: int, n_entries: int) -> int:
    """The seed of global entry ``entry``'s generator at an epoch step:
    distinct for every (step, entry) of an epoch, and the epoch step, not
    the segment-local one, so segments of one epoch never replay each
    other's draws."""
    return (int(epoch_step) * n_entries + entry) % 2 ** 64


def _flat_grad(leaves, loss) -> torch.Tensor:
    """``loss``'s gradient with respect to ``leaves``, flattened into one
    tensor (zeros for a leaf the loss does not use)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for p, g in zip(leaves, grads)])


class DPStepProgram(StepProgram):
    """The data-parallel step as one body over static inputs, on a mesh
    of one device: the counterpart of the scan body of the JAX package's
    ``build_dp_segment_runner``.

    The static inputs hold one chunk of at most ``capacity`` steps: each
    local entry's chunk rows of every epoch array ``(D, capacity *
    local_bs, ...)``, its per-step draws ``(D, capacity, ...)``, the
    optimiser's scalars (:meth:`Amsgrad.step_table`) and the chunk-local
    step ``i`` (a device int64 scalar).  The body gathers each entry's
    rows of step ``i``, computes its loss and flat gradient on the
    state's own parameters, ``pmean``-s the losses and the gradients in
    entry order, applies one update in place, writes the loss into row
    ``i`` and adds one to ``i``: it reads nothing on the host, so every
    replay is the next step."""

    def __init__(self, key: tuple, runner: "DPSegmentRunner", state,
                 corpus: torch.Tensor, knn: torch.Tensor, arrays: dict,
                 draws: dict, capacity: int):
        super().__init__(key, runner.trainer, state, corpus, knn, {}, {},
                         runner.local_bs, capacity)
        self.runner = runner
        d = runner.mesh.size
        self.arrays = {name: a.new_empty((d, capacity * runner.local_bs,
                                          *a.shape[1:]))
                       for name, a in arrays.items()}
        self.draws = {name: x.new_empty((d, capacity, *x.shape[2:]))
                      for name, x in draws.items()}

    def step(self) -> None:
        """The body: one data-parallel step at the chunk's step ``i``."""
        at = self.i.view(1)
        rows = self.i * self.batch_size + self.offsets
        flat_grads, losses = [], []
        with fresh_leaves(self.params) as params:
            leaves = param_leaves(params)
            for e in range(self.runner.mesh.size):
                batch = {name: a[e].index_select(0, rows)
                         for name, a in self.arrays.items()}
                batch.update({name: d[e].index_select(0, at)[0]
                              for name, d in self.draws.items()})
                loss = self.trainer.loss_fn(params, self.corpus, self.knn,
                                            batch, None)
                flat_grads.append(_flat_grad(leaves, loss))
                losses.append(loss.detach())
        loss, flat = pmean(losses), pmean(flat_grads)
        row = self.table.index_select(0, at)[0]
        self.opt.apply([part.view_as(p) for part, p in zip(
            flat.split([p.numel() for p in leaves]), leaves)],
            row[0], row[1], row[2])
        self.losses.index_copy_(0, at, loss.view(1))
        self.i.add_(1)

    def _fill(self, arrays: dict, draws: dict, first_step: int, j: int,
              n: int) -> None:
        """Each entry's rows of epoch steps ``first_step, ...`` (of its
        block of every array) and of the segment's draws ``j, ...``."""
        lbs, n_dev = self.batch_size, self.runner.n_dev
        for e, g in enumerate(self.runner.global_entries()):
            for name, a in self.arrays.items():
                src = arrays[name]
                lo = g * src.shape[0] // n_dev + first_step * lbs
                a[e, :n * lbs].copy_(src[lo:lo + n * lbs])
            for name, d in self.draws.items():
                d[e, :n].copy_(draws[name][e, j:j + n])


class DPSegmentRunner:
    """Data-parallel counterpart of :meth:`Trainer.run_segment`:
    ``run(state, corpus, knn, arrays, seg_start, n_steps, step_seed=0)``
    returns ``(state, losses)`` as it does.

    With D global entries, entry ``d`` owns rows ``[d * n / D, (d + 1) *
    n / D)`` of every epoch array (``n`` its length, trimmed by the
    trainer to whole batches), and step ``s`` takes the rows ``[s * B /
    D, (s + 1) * B / D)`` of that block (``B = batch_size``), with the
    draws (:meth:`Trainer.step_draws`) of a CPU generator seeded
    :func:`entry_seed` ``(step_seed + s, d, D)``.  The corpus and the
    kNN table are replicated.  ``batch_size`` must divide by D.

    On a mesh of one device that holds the state (see the module
    docstring) a segment runs the state's :class:`DPStepProgram`: on the
    card every step is a replay of its graph (captured at the first
    segment, whose first step is the capture's warm-up; a longer segment
    runs as chunks of it), on the CPU the same body eagerly.  Other
    meshes run the loop of eager steps."""

    def __init__(self, trainer, batch_size: int, mesh: Mesh):
        n_dev = mesh.global_size()
        if batch_size % n_dev:
            raise ValueError(
                f"batch_size {batch_size} not divisible by mesh size {n_dev}")
        self.trainer = trainer
        self.mesh = mesh
        self.n_dev = n_dev
        self.local_bs = batch_size // n_dev

    def global_entries(self) -> tuple[int, ...]:
        """The global index of each local entry."""
        return tuple(self.mesh.global_index(i) for i in range(self.mesh.size))

    def entry_draws(self, step_seed: int, seg_start: int, n_steps: int,
                    n_rows: int) -> dict[str, torch.Tensor]:
        """Every local entry's :meth:`Trainer.step_draws` of every step,
        ``(D, n_steps, ...)`` on the CPU: entry ``g`` at step ``s`` draws
        from a generator seeded :func:`entry_seed` ``(step_seed + s, g,
        D)``, taken in step order and entry order within a step, as the
        loop of eager steps takes them."""
        per = [[self.trainer.step_draws(torch.Generator().manual_seed(
            entry_seed(step_seed + s, g, self.n_dev)), n_rows)
            for g in self.global_entries()]
            for s in range(seg_start, seg_start + n_steps)]
        return {name: torch.stack([torch.stack([d[name] for d in step])
                                   for step in per], dim=1)
                for name in per[0][0]}

    def _on_one_device(self, state) -> bool:
        return self.mesh.on_one_device() and \
            param_leaves(state.params)[0].device == self.mesh.devices[0]

    def _entries(self, state, corpus, knn, arrays):
        """Each local entry's ``(global index, params, their leaves,
        corpus, knn, array block)``; entries on the state's device share
        its parameters, others get one replica per device."""
        home = param_leaves(state.params)[0].device
        copies, entries = {}, []
        for i, dev in enumerate(self.mesh.devices):
            g = self.mesh.global_index(i)
            if dev not in copies:
                params = state.params if dev == home else \
                    _replica(state.params, dev)
                copies[dev] = (params, param_leaves(params), corpus.to(dev),
                               knn.to(dev))
            block = {name: arr[g * arr.shape[0] // self.n_dev:
                               (g + 1) * arr.shape[0] // self.n_dev].to(dev)
                     for name, arr in arrays.items()}
            entries.append((g, *copies[dev], block))
        return entries

    def _step(self, entries, s: int, step_seed: int):
        """Step ``s``'s loss and flat gradient, each ``pmean``-ed over the
        entries, on the first entry's device."""
        flat_grads, losses = [], []
        for g, params, leaves, corpus, knn, block in entries:
            batch = {name: arr[s * self.local_bs:(s + 1) * self.local_bs]
                     for name, arr in block.items()}
            gen = torch.Generator().manual_seed(
                entry_seed(step_seed + s, g, self.n_dev))
            draws = self.trainer.step_draws(gen, corpus.shape[0])
            batch.update({name: host_to(d, corpus.device)
                          for name, d in draws.items()})
            loss = self.trainer.loss_fn(params, corpus, knn, batch, None)
            flat_grads.append(_flat_grad(leaves, loss))
            losses.append(loss.detach())
        return pmean(losses), pmean(flat_grads)

    def loss_and_grads(self, state, corpus, knn, arrays, step: int = 0,
                       step_seed: int = 0):
        """Epoch step ``step``'s ``pmean``-ed loss and gradients (one
        tensor per leaf of the state's params), without an update; run
        eagerly on every mesh."""
        loss, flat = self._step(self._entries(state, corpus, knn, arrays),
                                step, step_seed)
        primary = param_leaves(state.params)
        return loss, [part.view_as(p) for part, p in zip(
            flat.split([p.numel() for p in primary]), primary)]

    def __call__(self, state, corpus, knn, arrays, seg_start: int,
                 n_steps: int, step_seed: int = 0):
        if not self._on_one_device(state):
            return self._loop(state, corpus, knn, arrays, seg_start, n_steps,
                              step_seed)
        return self._segment(state, corpus, knn, arrays, seg_start, n_steps,
                             step_seed, corpus.is_cuda)

    def _run_segment_eager(self, state, corpus, knn, arrays, seg_start: int,
                           n_steps: int, step_seed: int = 0):
        """The segment with the :class:`DPStepProgram` body run eagerly on
        any device, on a mesh of one device: the reference the card's
        replays are held to."""
        if not self._on_one_device(state):
            raise ValueError("the data-parallel program needs a mesh of one "
                             "device that holds the state")
        return self._segment(state, corpus, knn, arrays, seg_start, n_steps,
                             step_seed, False)

    def _segment(self, state, corpus, knn, arrays, seg_start, n_steps,
                 step_seed, graphed: bool):
        device = self.mesh.devices[0]
        corpus, knn = corpus.to(device), knn.to(device)
        draws = {name: host_to(d, device) for name, d in self.entry_draws(
            step_seed, seg_start, n_steps, corpus.shape[0]).items()}
        table = host_to(torch.from_numpy(state.opt_state.step_table(n_steps)),
                        device)
        key = ("dp", self.mesh.devices, self.global_entries(), self.n_dev,
               *_program_key(self.trainer, state, corpus, knn, arrays, draws,
                             self.local_bs, step_dims=2))
        program = held_program(state, key, graphed, lambda: DPStepProgram(
            key, self, state, corpus, knn, arrays, draws, n_steps))
        return run_chunks(state, program, arrays, draws, table, seg_start,
                          n_steps, graphed)

    def _loop(self, state, corpus, knn, arrays, seg_start: int, n_steps: int,
              step_seed: int = 0):
        """The loop of eager steps, one ``Amsgrad.update`` each, with the
        replicas on other devices set to the updated parameters: the path
        of meshes over several devices or processes."""
        entries = self._entries(state, corpus, knn, arrays)
        primary = param_leaves(state.params)
        home = primary[0].device
        sizes = [p.numel() for p in primary]
        losses = []
        for i in range(n_steps):
            loss, flat = self._step(entries, seg_start + i, step_seed)
            flat = flat.to(home)
            state.opt_state.update([part.view_as(p) for part, p in
                                    zip(flat.split(sizes), primary)])
            state.step += 1
            with torch.no_grad():  # the replicas take the updated params
                for _, params, leaves, *_ in entries:
                    if params is not state.params:
                        for rep, p in zip(leaves, primary):
                            rep.copy_(p)
            losses.append(loss.to(home))
        return state, torch.stack(losses)


def build_dp_segment_runner(trainer, batch_size: int,
                            mesh: Mesh) -> DPSegmentRunner:
    """The data-parallel segment runner of ``trainer`` (the JAX package's
    ``build_dp_segment_runner``): see :class:`DPSegmentRunner`."""
    return DPSegmentRunner(trainer, batch_size, mesh)
