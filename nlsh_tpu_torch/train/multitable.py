"""Jointly trained multi-table ensembles (port of
:mod:`nlsh_tpu.train.multitable`).

Wraps an extra-model-free learner (triplet / siamese / proposed):
``n_tables`` hashings of one architecture, one module per table, each
drawing its own batch composition so the ensemble decorrelates.  A step
sums the per-table losses (a loop over the tables, all in the one
captured step on the card, the counterpart of the JAX package's
``vmap``) and updates every table.  Evaluation builds a
:class:`~nlsh_tpu_torch.parallel.multitable.MultiTableIndexer` (the
windowed engine, kernel K3 on the card) and logs the single-table
channels, ``test/query_size`` being the exact distinct-candidate count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nlsh_tpu_torch.parallel.multitable import (
    MultiTableIndexer,
    init_multi_table,
)
from nlsh_tpu_torch.train.base import Trainer
from nlsh_tpu_torch.utils import checkpoint as ckpt
from nlsh_tpu_torch.utils.metrics import calculate_recall


class MultiTableTrainer(Trainer):
    """Train ``n_tables`` hashings jointly from a single-table learner
    ``inner``, whose ``loss_fn``/``epoch_arrays`` define each table's
    objective."""

    def __init__(self, inner: Trainer, n_tables: int):
        super().__init__(inner.hashing, inner.data, inner.model_save_dir,
                         inner.logger)
        if type(inner).init_extra is not Trainer.init_extra:
            raise ValueError(
                "MultiTableTrainer supports extra-model-free learners only "
                f"(got {type(inner).__name__})")
        self.inner = inner
        self.n_tables = n_tables

    def init_hashing_params(self, generator):
        return init_multi_table(self.hashing, self.n_tables, generator)

    def _table(self, params: dict, t: int) -> dict:
        return {"hashing": params["hashing"][t], "extra": params["extra"]}

    def epoch_arrays(self, generator, params):
        """Independent per-table compositions, stacked on axis 1 so the
        per-step row slicing (axis 0) still applies."""
        per_table = [self.inner.epoch_arrays(generator, self._table(params, t))
                     for t in range(self.n_tables)]
        return {name: torch.stack([a[name] for a in per_table], dim=1)
                for name in per_table[0]}

    def step_draws(self, generator, n_rows):
        """Each table's draws from a generator of its own, seeded from the
        step's, stacked on axis 1 as the epoch arrays are."""
        seeds = torch.randint(0, 2 ** 62, (self.n_tables,),
                              generator=generator).tolist()
        per_table = [self.inner.step_draws(torch.Generator().manual_seed(seed),
                                           n_rows) for seed in seeds]
        return {name: torch.stack([d[name] for d in per_table], dim=1)
                for name in per_table[0]}

    def loss_fn(self, params, corpus, knn, batch, generator):
        losses = [
            self.inner.loss_fn(self._table(params, t), corpus, knn,
                               {name: arr[:, t] for name, arr in batch.items()},
                               generator)
            for t in range(self.n_tables)]
        return torch.sum(torch.stack(losses))

    # -- ensemble evaluation and checkpoints -----------------------------------
    def _evaluate(self, params, corpus, val, ground_truth, probe_train,
                  probe_gt, K, hash_times, step, eval_seed,
                  probe_mode: str = "sample"):
        hashings = params["hashing"]
        try:
            indexer = MultiTableIndexer(hashings, corpus, device=corpus.device,
                                        metric=self.data.metric)
            counts = indexer.counts
            self.logger.log("test/n_indexes", int(torch.sum(counts > 0)), step)
            self.logger.log(
                "test/std_index_rows",
                float(torch.std(counts.to(torch.float32), correction=0)), step)
            t1 = time.perf_counter()
            topk, _ = indexer.query(val, k=K, hash_times=1)
            t2 = time.perf_counter()
            recall = float(calculate_recall(ground_truth, topk, np.mean))
            # the exact distinct-candidate count, whichever engine answered
            query_size = float(np.mean(indexer.exact_query_size(val,
                                                                hash_times=1)))
            self.logger.log("test/recall", recall, step)
            self.logger.log("test/query_size", query_size, step)
            self.logger.log("test/qps", val.shape[0] / (t2 - t1), step)
            topk_t, _ = indexer.query(probe_train, k=K, hash_times=1)
            self.logger.log("training/recall",
                            calculate_recall(probe_gt, topk_t, np.mean), step)
            self.logger.log("training/query_size", float(np.mean(
                indexer.exact_query_size(probe_train, hash_times=1))), step)
        finally:
            for h in hashings:
                h.train()
        return recall, query_size

    def save_checkpoint(self, state, recall):
        base = (f"{self.model_save_dir}/{self.logger.run_name}"
                f"_{state.step}_{recall:.4f}_L{self.n_tables}")
        ckpt.save_model(base, list(state.params["hashing"]))
        ckpt.save_train_state(base + ".state", state)
