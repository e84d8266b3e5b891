"""Autoencoder trainer (port of :mod:`nlsh_tpu.train.ae`).

The hashing's probability code is decoded back to the input space by a
2-layer ReLU decoder (ReLU on the output layer too, as in the
reference), trained with the squared data-metric distance between the
reconstruction and the input.  The decoder is the trainer's extra params
in the JAX layout, ``{"fc1": {"b", "w"}, "fc2": {"b", "w"}}`` with ``w``
as ``(fan_in, fan_out)``, optimised jointly with the hashing.
"""

from __future__ import annotations

import math

import torch

from nlsh_tpu_torch.models.encoders import uniform_
from nlsh_tpu_torch.ops import distances as D
from nlsh_tpu_torch.train.base import Trainer


def _linear_init(generator, fan_in: int, fan_out: int) -> dict:
    """The JAX package's ``_linear_init``: U(+-1/sqrt(fan_in)) for ``w``
    ``(fan_in, fan_out)`` and ``b``."""
    layer = {"w": torch.empty(fan_in, fan_out), "b": torch.empty(fan_out)}
    for key in ("w", "b"):
        uniform_(layer[key], 1.0 / math.sqrt(fan_in), generator)
    return layer


class AETrainer(Trainer):

    def __init__(self, hashing, data, model_save_dir=None, logger=None,
                 decoder_hidden: int = 256):
        super().__init__(hashing, data, model_save_dir, logger)
        self.decoder_hidden = decoder_hidden

    def init_extra(self, generator):
        if not self.data.prepared:
            self.data.load()
        return {"fc1": _linear_init(generator, self.hashing.output_dim,
                                    self.decoder_hidden),
                "fc2": _linear_init(generator, self.decoder_hidden,
                                    self.data.dim)}

    @staticmethod
    def _decode(extra: dict, code: torch.Tensor) -> torch.Tensor:
        h = torch.relu(code @ extra["fc1"]["w"] + extra["fc1"]["b"])
        return torch.relu(h @ extra["fc2"]["w"] + extra["fc2"]["b"])

    def epoch_arrays(self, generator, params):
        n = self.data.training.shape[0]
        return {"anchor": torch.randperm(n, generator=generator)}

    def loss_fn(self, params, corpus, knn, batch, generator):
        x = corpus[batch["anchor"]]
        recon = self._decode(params["extra"], params["hashing"].predict(x))
        dist = D.get_metric(self.data.metric)["rowwise"](recon, x)
        return torch.mean(dist ** 2)
