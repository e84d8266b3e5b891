"""VQ-VAE trainer (port of :mod:`nlsh_tpu.train.vqvae`).

The hashing's probabilities select a codebook row by argmax; the loss is
the squared L2 between that row and the input.  The backward is the
reference's straight-through lookup, not a plain STE:

* to the probabilities: the *norm* of the incoming gradient, put in each
  row's argmax slot;
* to the codebook: the incoming gradient added at the selected rows.

The codebook has ``output_dim`` rows (``hash_size`` for the Bernoulli
head), as the reference's ``nn.Embedding(hash_size, dim)``.
"""

from __future__ import annotations

import torch

from nlsh_tpu_torch.train.base import Trainer


class _STCodebookLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, probs, codebook):
        idx = torch.argmax(probs, dim=-1)
        ctx.save_for_backward(idx)
        ctx.shapes = (probs.shape, codebook.shape)
        return codebook[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        probs_shape, codebook_shape = ctx.shapes
        g_norm = torch.sqrt(torch.sum(g * g, dim=-1))            # (bs,)
        rows = torch.arange(probs_shape[0], device=g.device)
        grad_probs = torch.zeros(probs_shape, dtype=g.dtype, device=g.device)
        grad_probs.index_put_((rows, idx), g_norm)
        grad_codebook = torch.zeros(codebook_shape, dtype=g.dtype,
                                    device=g.device).index_add_(0, idx, g)
        return grad_probs, grad_codebook


def st_codebook_lookup(probs: torch.Tensor,
                       codebook: torch.Tensor) -> torch.Tensor:
    """``codebook[argmax(probs, -1)]`` with the straight-through backward
    above."""
    return _STCodebookLookup.apply(probs, codebook)


class VQVAETrainer(Trainer):

    def init_extra(self, generator):
        if not self.data.prepared:
            self.data.load()
        # torch nn.Embedding's default init: N(0, 1)
        return {"codebook": torch.randn((self.hashing.output_dim,
                                         self.data.dim), generator=generator)}

    def epoch_arrays(self, generator, params):
        n = self.data.training.shape[0]
        return {"anchor": torch.randperm(n, generator=generator)}

    def loss_fn(self, params, corpus, knn, batch, generator):
        x = corpus[batch["anchor"]]
        probs = params["hashing"].predict(x)
        d = st_codebook_lookup(probs, params["extra"]["codebook"]) - x
        return torch.mean(torch.sum(d * d, dim=-1))
