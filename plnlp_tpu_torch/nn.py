"""Parameter initializers drawing from an explicit ``torch.Generator``
(port of plnlp_tpu/nn.py).

Each reproduces the torch/PyG default the reference trains with:

* :func:`torch_linear_init` — torch.nn.Linear: U(±1/√fan_in) for weight
  and bias.
* :func:`glorot_init` — PyG GCNConv: glorot-uniform weight, zero bias.
* :func:`xavier_uniform` — the embedding table (torch xavier_uniform_).

Draws happen on the CPU generator, so the same seed gives the same weights
whatever device the model later moves to.  :func:`dropout` draws its mask
from the generator it is handed (on the tensor's device); the JAX package
draws from ``jax.random``, so the two masks never agree and parity holds
at rate 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["linear", "torch_linear_init", "glorot_init", "xavier_uniform", "dropout"]


def linear(fan_in: int, fan_out: int, bias: bool = True) -> nn.Linear:
    """An ``nn.Linear`` (weight ``(out, in)``) whose parameters are left
    uninitialized, so building it draws nothing from the global RNG."""
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out, bias=bias)


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def torch_linear_init(
    gen: torch.Generator, fan_in: int, fan_out: int, bias: bool = True
) -> nn.Linear:
    lin = linear(fan_in, fan_out, bias)
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    lin.weight.copy_(_uniform(gen, (fan_out, fan_in), bound))
    if bias:
        lin.bias.copy_(_uniform(gen, (fan_out,), bound))
    return lin


@torch.no_grad()
def glorot_init(
    gen: torch.Generator, fan_in: int, fan_out: int, bias: bool = True
) -> nn.Linear:
    lin = linear(fan_in, fan_out, bias)
    lin.weight.copy_(_uniform(gen, (fan_out, fan_in), math.sqrt(6.0 / (fan_in + fan_out))))
    if bias:
        lin.bias.zero_()
    return lin


def xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """A ``(rows, cols)`` table with torch's xavier_uniform_ bound."""
    rows, cols = shape
    return _uniform(gen, shape, math.sqrt(6.0 / (rows + cols)))


def dropout(
    x: torch.Tensor, rate: float, gen: Optional[torch.Generator], train: bool
) -> torch.Tensor:
    """torch.nn.functional.dropout semantics (inverted scaling at train).

    The keep mask is drawn from ``gen``; nothing happens outside training,
    at rate 0 or without a generator, as in the JAX package."""
    if not train or rate == 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
