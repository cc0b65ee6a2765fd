"""Pairwise edge scorers s(u, v): the six predictor families (port of
plnlp_tpu/models/predictors.py), with dropout between layers at train time.

Output shapes follow the reference: MLP/MLPCAT return (B, 1);
DOT/BIL/MLPDOT/MLPBIL return (B,).  MLPDOT/MLPBIL keep the reference
factory's width-1 tower: Linear(h, 1) then (L-1) x Linear(1, 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from plnlp_tpu_torch.nn import dropout as _dropout
from plnlp_tpu_torch.nn import torch_linear_init

PREDICTOR_NAMES = ("DOT", "BIL", "MLP", "MLPDOT", "MLPBIL", "MLPCAT")

__all__ = [
    "Predictor",
    "PREDICTOR_NAMES",
    "grid_factorizable",
    "grid_transform_right",
    "grid_scores_left",
    "grid_scores",
]


def _stack(gen, dims):
    return nn.ModuleList(
        torch_linear_init(gen, dims[i], dims[i + 1]) for i in range(len(dims) - 1)
    )


def _mlp_final_scalar(lins, x, rate=0.0, gen=None, train=False):
    """relu + dropout between layers, the last linear."""
    for lin in lins[:-1]:
        x = _dropout(torch.relu(lin(x)), rate, gen, train)
    return lins[-1](x)


def _tower(lins, x, rate=0.0, gen=None, train=False):
    """relu + dropout after every layer (MLPDOT/MLPBIL towers)."""
    for lin in lins:
        x = _dropout(torch.relu(lin(x)), rate, gen, train)
    return x


class Predictor(nn.Module):
    """Attribute names (``lins``, ``bilin``) follow the JAX params pytree."""

    def __init__(self, gen: torch.Generator, name: str, hidden_channels: int, num_layers: int):
        super().__init__()
        self.name = name.upper()
        h = hidden_channels
        if self.name == "DOT":
            pass
        elif self.name == "BIL":
            self.bilin = torch_linear_init(gen, h, h, bias=False)
        elif self.name == "MLP":
            self.lins = _stack(gen, [h] + [h] * (num_layers - 1) + [1])
        elif self.name == "MLPCAT":
            self.lins = _stack(gen, [2 * h] + [h] * (num_layers - 1) + [1])
        elif self.name in ("MLPDOT", "MLPBIL"):
            self.lins = _stack(gen, [h] + [1] * num_layers)
            if self.name == "MLPBIL":
                self.bilin = torch_linear_init(gen, 1, 1, bias=False)
        else:
            raise ValueError(f"unknown predictor: {name}")

    def forward(
        self,
        x_i: torch.Tensor,
        x_j: torch.Tensor,
        *,
        dropout: float = 0.0,
        train: bool = False,
        gen: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        name = self.name
        drop = (dropout, gen, train)
        if name == "DOT":
            return (x_i * x_j).sum(-1)
        if name == "BIL":
            return (self.bilin(x_i) * x_j).sum(-1)
        if name == "MLP":
            return _mlp_final_scalar(self.lins, x_i * x_j, *drop)
        if name == "MLPCAT":
            o1 = _mlp_final_scalar(self.lins, torch.cat([x_i, x_j], -1), *drop)
            o2 = _mlp_final_scalar(self.lins, torch.cat([x_j, x_i], -1), *drop)
            return (o1 + o2) / 2
        ti, tj = _tower(self.lins, x_i, *drop), _tower(self.lins, x_j, *drop)
        if name == "MLPDOT":
            return (ti * tj).sum(-1)
        return (self.bilin(ti) * tj).sum(-1)


_FACTORIZABLE = ("DOT", "BIL", "MLPDOT", "MLPBIL")


def grid_factorizable(name: str) -> bool:
    """True when all-pairs scoring factorizes into per-node transforms plus
    one matmul; MLP/MLPCAT consume a per-pair vector."""
    return name.upper() in _FACTORIZABLE


def _not_factorizable(name):
    return ValueError(f"{name} does not factorize (see grid_factorizable)")


def grid_transform_right(pred: Predictor, h_cand: torch.Tensor) -> torch.Tensor:
    """Candidate-side per-node transform, computed once per candidate set."""
    if pred.name in ("DOT", "BIL"):
        return h_cand
    if pred.name in ("MLPDOT", "MLPBIL"):
        return _tower(pred.lins, h_cand)
    raise _not_factorizable(pred.name)


def grid_scores_left(pred: Predictor, h_src: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """(S, C) scores: source-side transform + one matmul against a
    precomputed :func:`grid_transform_right` result."""
    if pred.name == "DOT":
        left = h_src
    elif pred.name == "BIL":
        left = pred.bilin(h_src)
    elif pred.name == "MLPDOT":
        left = _tower(pred.lins, h_src)
    elif pred.name == "MLPBIL":
        left = pred.bilin(_tower(pred.lins, h_src))
    else:
        raise _not_factorizable(pred.name)
    return left @ right.t()


def grid_scores(pred: Predictor, h_src: torch.Tensor, h_cand: torch.Tensor):
    """(S, C) all-pairs scores, or None for the pairwise predictors."""
    if not grid_factorizable(pred.name):
        return None
    return grid_scores_left(pred, h_src, grid_transform_right(pred, h_cand))
