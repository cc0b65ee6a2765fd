"""Carry parameters between a plnlp_tpu pytree and the port's :class:`Model`.

The JAX side stores each dense layer as ``{"w": (in, out), "b": (out,)}``;
``nn.Linear`` keeps ``weight`` as ``(out, in)``, so weights are transposed.
Module and attribute names mirror the pytree keys (``emb``,
``encoder.layers[i].lin_l``, ``predictor.lins[i]``, ``predictor.bilin``),
so the walk is by name.  Every parameter of the model must be covered.

Usage: ``params_from_jax(jax.tree_util.tree_map(np.asarray, params), model)``;
``params_to_jax(model)`` gives the model's parameters back as a numpy tree
in the JAX layout (to compare the two after training steps).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_jax", "params_to_jax"]


def _copy(param: torch.Tensor, value, where: str, loaded: set) -> None:
    value = torch.from_numpy(np.array(value, np.float32))
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{where}: shape {tuple(value.shape)} != {tuple(param.shape)}")
    param.copy_(value)
    loaded.add(id(param))


def _load(module: nn.Module, tree, where: str, loaded: set) -> None:
    if isinstance(tree, dict) and "w" in tree:
        if not isinstance(module, nn.Linear):
            raise ValueError(f"{where}: expected nn.Linear, got {type(module).__name__}")
        _copy(module.weight, np.asarray(tree["w"]).T, f"{where}.w", loaded)
        if ("b" in tree) != (module.bias is not None):
            raise ValueError(f"{where}: bias present on one side only")
        if "b" in tree:
            _copy(module.bias, tree["b"], f"{where}.b", loaded)
    elif isinstance(tree, dict):
        for key, sub in tree.items():
            child = module[key] if isinstance(module, nn.ModuleDict) else getattr(module, key)
            _load(child, sub, f"{where}.{key}", loaded)
    elif isinstance(tree, (list, tuple)):
        if len(tree) != len(module):
            raise ValueError(f"{where}: {len(tree)} entries != {len(module)}")
        for i, sub in enumerate(tree):
            _load(module[i], sub, f"{where}[{i}]", loaded)
    else:
        raise ValueError(f"{where}: unexpected leaf {type(tree).__name__}")


@torch.no_grad()
def params_from_jax(np_tree, model: nn.Module) -> nn.Module:
    """Copy ``np_tree`` (the JAX params pytree as numpy arrays) into
    ``model`` in place and return it."""
    loaded: set = set()
    for key, sub in np_tree.items():
        if key == "emb":
            _copy(model.emb, sub, "emb", loaded)
        else:
            _load(getattr(model, key), sub, key, loaded)
    missing = [n for n, p in model.named_parameters() if id(p) not in loaded]
    if missing:
        raise ValueError(f"parameters not in the JAX tree: {missing}")
    return model


def _dump(module: nn.Module):
    if isinstance(module, nn.Linear):
        tree = {"w": module.weight.detach().cpu().numpy().T.copy()}
        if module.bias is not None:
            tree["b"] = module.bias.detach().cpu().numpy().copy()
        return tree
    if isinstance(module, nn.ModuleList):
        return [_dump(m) for m in module]
    return {name: _dump(child) for name, child in module.named_children()}


@torch.no_grad()
def params_to_jax(model: nn.Module) -> dict:
    """``model``'s parameters as a numpy tree in the JAX pytree layout
    (``emb``, ``encoder.layers[i]``, ``predictor``; weights ``(in, out)``)."""
    tree = {"encoder": _dump(model.encoder), "predictor": _dump(model.predictor)}
    if model.emb is not None:
        tree["emb"] = model.emb.detach().cpu().numpy().copy()
    return tree
