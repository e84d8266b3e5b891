"""Encoder trunks mapping input vectors to hash-head features.

Port of :mod:`nlsh_tpu.models.encoders` as ``nn.Module``s.  Weights
load from the JAX package's params with
:func:`nlsh_tpu_torch.utils.checkpoint.params_from_jax`; JAX keeps a
layer's ``w`` as ``(fan_in, fan_out)`` and ``nn.Linear`` as
``(out, in)``, so the loader transposes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class MLPEncoder(nn.Module):
    """ReLU MLP trunk, with an optional parameter-free layer norm after
    each linear layer (as in the JAX package)."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int],
                 with_bias: bool = True, with_layernorm: bool = False):
        super().__init__()
        self.input_dim = input_dim
        self.hidden_dims = tuple(hidden_dims)
        self.with_bias = with_bias
        self.with_layernorm = with_layernorm
        dims = (input_dim,) + self.hidden_dims
        self.layers = nn.ModuleList(
            nn.Linear(a, b, bias=with_bias) for a, b in zip(dims, dims[1:])
        )

    @property
    def output_dim(self) -> int:
        return self.hidden_dims[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
            if self.with_layernorm:
                mean = x.mean(dim=-1, keepdim=True)
                var = x.var(dim=-1, unbiased=False, keepdim=True)
                x = (x - mean) * torch.rsqrt(var + 1e-5)
            x = torch.relu(x)
        return x


class SirenEncoder(nn.Module):
    """Sinusoidal trunk: ``sin(w0 * (Wx + b))`` layers, ``w0_initial``
    on the first, ``w0`` on the hidden ones, and a linear last layer.

    Initialisation is the standard SIREN one: first layer
    ``U(-1/fan_in, 1/fan_in)``, the others
    ``U(-sqrt(6/fan_in)/w0, sqrt(6/fan_in)/w0)``."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int],
                 w0: float = 1.0, w0_initial: float = 30.0):
        super().__init__()
        self.input_dim = input_dim
        self.hidden_dims = tuple(hidden_dims)
        self.w0 = w0
        self.w0_initial = w0_initial
        dims = (input_dim,) + self.hidden_dims
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims, dims[1:])
        )
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                fan_in = layer.in_features
                bound = 1.0 / fan_in if i == 0 else math.sqrt(6.0 / fan_in) / w0
                layer.weight.uniform_(-bound, bound)
                layer.bias.uniform_(-bound, bound)

    @property
    def output_dim(self) -> int:
        return self.hidden_dims[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            z = layer(x)
            if i == last:
                x = z
            else:
                x = torch.sin((self.w0_initial if i == 0 else self.w0) * z)
        return x


ENCODERS = {"mlp": MLPEncoder, "siren": SirenEncoder}


def get_encoder(name: str, input_dim: int, hidden_dims: Sequence[int], **kw) -> nn.Module:
    try:
        cls = ENCODERS[name]
    except KeyError:
        raise ValueError(f"unknown encoder {name!r}; one of {sorted(ENCODERS)}")
    return cls(input_dim, tuple(hidden_dims), **kw)
