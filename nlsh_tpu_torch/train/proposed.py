"""The "proposed" trainer, the reference repo's own method (port of
:mod:`nlsh_tpu.train.proposed`).

Loss = the mean code distance from each anchor to each of its top-k
ground-truth neighbours, plus ``lambda1`` times a query-size
regulariser: of ``n_reg_samples`` corpus rows drawn per step (the step's
``reg`` draws, taken before the segment), every row whose hard bucket no
anchor of the batch probes adds its least confident bit's ``|p - 0.5|``.
Bucket membership is a dense comparison of packed codes on the device.
"""

from __future__ import annotations

import torch

from nlsh_tpu_torch.ops.packing import pack_bits
from nlsh_tpu_torch.train.base import Trainer


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs`` with its gradient, 1 at 0 (``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


class ProposedTrainer(Trainer):

    def __init__(self, hashing, data, model_save_dir=None, logger=None,
                 train_k: int = 10, lambda1: float = 0.001,
                 n_reg_samples: int = 65536):
        super().__init__(hashing, data, model_save_dir, logger)
        self.train_k = train_k
        self.lambda1 = lambda1
        self.n_reg_samples = n_reg_samples

    def epoch_arrays(self, generator, params):
        n = self.data.training.shape[0]
        return {"anchor": torch.randperm(n, generator=generator)}

    def _reg_samples(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """The step's regulariser rows: ``n_reg_samples`` uniform ids in
        ``[0, n)``, drawn on the CPU."""
        return torch.randint(0, n, (self.n_reg_samples,), generator=generator)

    def step_draws(self, generator, n_rows):
        return {"reg": self._reg_samples(n_rows, generator).to(torch.int64)}

    def loss_fn(self, params, corpus, knn, batch, generator):
        hashing = params["hashing"]
        anchor_idx = batch["anchor"]
        k = min(self.train_k, knn.shape[1])
        pos_idx = knn[anchor_idx, :k]                            # (bs, k)
        hashed_anchor = hashing.predict(corpus[anchor_idx])
        bs = anchor_idx.shape[0]
        hashed_pos = hashing.predict(corpus[pos_idx.reshape(-1)]).reshape(
            bs, k, -1)
        # row_pairwise((bs, 1, bits), (bs, k, bits)) -> (bs, 1, k)
        positive_loss = torch.mean(hashing.code_distance.row_pairwise(
            hashed_anchor[:, None, :], hashed_pos)[:, 0, :])

        hashed_cand = hashing.predict(corpus[batch["reg"]])
        query_codes = pack_bits((hashed_anchor.detach() > 0.5).to(torch.int32))
        cand_codes = pack_bits((hashed_cand.detach() > 0.5).to(torch.int32))
        in_probed = torch.any(cand_codes[:, None] == query_codes[None, :], dim=1)
        # amin shares the gradient among tied bits, as jnp.min does
        confidence = torch.amin(_abs(hashed_cand - 0.5), dim=1)
        query_size_loss = torch.sum(confidence * (~in_probed).to(torch.float32))
        return positive_loss + self.lambda1 * query_size_loss
