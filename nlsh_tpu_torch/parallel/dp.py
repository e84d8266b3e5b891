"""Data-parallel training over a mesh.

Port of :mod:`nlsh_tpu.parallel.dp`.  Each entry of the mesh owns a
contiguous block of the epoch's batch-composition arrays (and so a slice
of every global batch), computes the loss and gradients of its slice on
a replica of the parameters, and the gradients and loss are
:func:`~nlsh_tpu_torch.parallel.mesh.pmean`-ed (in entry order, then
across processes).  One amsgrad update is applied to the trainer's
state, and each replica on another device is set to the updated
parameters, so every replica stays equal.  Entries that share a device
share the state's own parameters.
"""

from __future__ import annotations

import copy

import torch

from nlsh_tpu_torch.parallel.mesh import Mesh, pmean
from nlsh_tpu_torch.train.base import extra_to, host_to, param_leaves


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


class DPSegmentRunner:
    """Data-parallel counterpart of :meth:`Trainer.run_segment`:
    ``run(state, corpus, knn, arrays, seg_start, n_steps, step_seed=0)``
    returns ``(state, losses)`` as it does.

    With D global entries, entry ``d`` owns rows ``[d * n / D, (d + 1) *
    n / D)`` of every epoch array (``n`` its length, trimmed by the
    trainer to whole batches), and step ``s`` takes the rows ``[s * B /
    D, (s + 1) * B / D)`` of that block (``B = batch_size``), with the
    draws (:meth:`Trainer.step_draws`) of a CPU generator seeded
    :func:`entry_seed` ``(step_seed + s, d, D)``.  The
    corpus and the kNN table are replicated.  ``batch_size`` must divide
    by D."""

    def __init__(self, trainer, batch_size: int, mesh: Mesh):
        n_dev = mesh.global_size()
        if batch_size % n_dev:
            raise ValueError(
                f"batch_size {batch_size} not divisible by mesh size {n_dev}")
        self.trainer = trainer
        self.mesh = mesh
        self.n_dev = n_dev
        self.local_bs = batch_size // n_dev

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
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            flat_grads.append(torch.cat([
                (torch.zeros_like(p) if gr is None else gr).reshape(-1)
                for p, gr in zip(leaves, grads)]))
            losses.append(loss.detach())
        return pmean(losses), pmean(flat_grads)

    def loss_and_grads(self, state, corpus, knn, arrays, step: int = 0,
                       step_seed: int = 0):
        """Epoch step ``step``'s ``pmean``-ed loss and gradients (one
        tensor per leaf of the state's params), without an update."""
        loss, flat = self._step(self._entries(state, corpus, knn, arrays),
                                step, step_seed)
        primary = param_leaves(state.params)
        return loss, [part.view_as(p) for part, p in zip(
            flat.split([p.numel() for p in primary]), primary)]

    def __call__(self, state, corpus, knn, arrays, seg_start: int,
                 n_steps: int, step_seed: int = 0):
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
