"""Learned hash functions (hashing heads).

Port of :mod:`nlsh_tpu.models.hashings`, the ``MultivariateBernoulli``
head the serving path runs: encoder -> Linear -> sigmoid gives per-bit
probabilities, the hard hash thresholds them at 0.5, and multi-probe
either samples the bits (``probe_mode="sample"``, from an explicit
``torch.Generator``) or flips the least-confident ones
(``probe_mode="flip"``).  The other heads are still to be ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nlsh_tpu_torch.ops import packing


class MultivariateBernoulli(nn.Module):
    """Per-bit Bernoulli hashing; ``tanh_output`` uses tanh rescaled to
    [0, 1] in place of the sigmoid."""

    def __init__(self, encoder: nn.Module, hash_size: int,
                 tanh_output: bool = False):
        super().__init__()
        self.encoder = encoder
        self.hash_size = hash_size
        self.tanh_output = tanh_output
        self.out = nn.Linear(encoder.output_dim, hash_size)

    @property
    def n_buckets(self) -> int:
        return 2 ** self.hash_size

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        z = self.out(self.encoder(x))
        return torch.tanh(z) if self.tanh_output else torch.sigmoid(z)

    forward = predict

    def probs(self, x: torch.Tensor) -> torch.Tensor:
        """Bernoulli probabilities in [0, 1]."""
        p = self.predict(x)
        return p / 2.0 + 0.5 if self.tanh_output else p

    def hash(self, x: torch.Tensor, n_probes: int = 1,
             generator: torch.Generator | None = None,
             probe_mode: str = "sample") -> tuple[torch.Tensor, torch.Tensor]:
        """Bucket ids ``(ids, valid)`` of shape ``(n, n_probes)``: probe 0
        is the hard code, the others Bernoulli samples of the code
        (``"sample"``, drawn from ``generator``) or flips of the
        least-confident bits (``"flip"``).  Ids are sorted per row, with
        repeats masked out of ``valid``."""
        if n_probes < 1:
            raise ValueError(f"`n_probes` should be a positive integer, got {n_probes}")
        if probe_mode not in ("sample", "flip"):
            raise ValueError(f"unknown probe_mode {probe_mode!r} (sample|flip)")
        p = self.probs(x)
        if probe_mode == "flip" and n_probes > 1:
            return self._hash_flip(p, n_probes)
        hard = (p > 0.5).to(torch.int32)[:, None, :]
        if n_probes == 1:
            codes = hard
        else:
            if generator is None:
                raise ValueError("multi-probe sampling needs a `generator`")
            u = torch.rand((x.shape[0], n_probes - 1, self.hash_size),
                           generator=generator, device=p.device)
            codes = torch.cat([hard, (u < p[:, None, :]).to(torch.int32)], dim=1)
        return packing.hash_codes(codes)

    def _hash_flip(self, p: torch.Tensor, n_probes: int):
        """Flip subsets of the ceil(log2(n_probes)) least-confident bits of
        the hard code, enumerated by flip mask (mask 0 = the hard code)."""
        bits = self.hash_size
        n_flip = min(max(math.ceil(math.log2(n_probes)), 1), bits)
        base = packing.pack_bits((p > 0.5).to(torch.int32))
        conf = torch.abs(p - 0.5)
        # the JAX package takes lax.top_k(-conf), which keeps the lowest
        # bit index among equal confidences; a stable ascending sort does
        # the same (torch.topk promises no order among ties)
        flip_pos = torch.sort(conf, dim=1, stable=True).indices[:, :n_flip]
        weights = (1 << (bits - 1 - flip_pos)).to(torch.int32)
        masks = torch.arange(n_probes, dtype=torch.int32, device=p.device)
        shifts = torch.arange(n_flip, dtype=torch.int32, device=p.device)
        take = (masks[None, :, None] >> shifts) & 1       # (1, P, n_flip)
        xor = torch.sum(take * weights[:, None, :], dim=-1, dtype=torch.int32)
        return packing.dedupe_codes(torch.bitwise_xor(base[:, None], xor))

    def hash_hard(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic single bucket id per row: ``(n,)`` int32."""
        return packing.pack_bits((self.probs(x) > 0.5).to(torch.int32))


_NOT_PORTED = {
    "Categorical": "ROADMAP.md Queue 1, item 1 (Categorical)",
    "ProductQuantization": "ROADMAP.md Queue 1, item 1 (ProductQuantization)",
}


def get_hashing(hashing_type: str, encoder: nn.Module, hash_size: int) -> nn.Module:
    """Factory keyed like the JAX package's ``get_hashing``."""
    if hashing_type == "MultivariateBernoulli":
        return MultivariateBernoulli(encoder, hash_size)
    if hashing_type == "MultivariateBernoulliTanh":
        return MultivariateBernoulli(encoder, hash_size, tanh_output=True)
    if hashing_type in _NOT_PORTED:
        raise NotImplementedError(
            f"{hashing_type} is not ported yet: {_NOT_PORTED[hashing_type]}"
        )
    raise ValueError(f"{hashing_type!r} is not a valid hashing type")
