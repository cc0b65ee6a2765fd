"""Per-epoch random-walk pair augmentation (port of plnlp_tpu/augment.py;
reference main.py:228-253).

Each epoch: walk ``walk_length`` steps from every start node and emit the
training pairs ``(walk[:, 0], walk[:, j+1])`` with weight ``1/(j+1)`` for
j = 0..L-1.  These pairs replace the epoch's training positives, and the
weights become the WeightedHingeAUC margins (reference loss.py:31-35).

The reference drops self-pairs with ``masked_select``; here, as in the JAX
package, the output keeps its (S·L, 2) shape, step-major, with a validity
mask that ``Model.train_epoch`` applies to the loss: the same gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from plnlp_tpu_torch.graph import Graph
from plnlp_tpu_torch.ops.walk import random_walk

__all__ = ["random_walk_pairs"]


def random_walk_pairs(
    graph: Graph, start, walk_length: int, gen: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pairs (S·L, 2) int64, weights (S·L,) f32, valid (S·L,) bool)."""
    walk = random_walk(graph, start, walk_length, gen)  # (S, L+1)
    s = walk.shape[0]
    src = walk[:, 0].repeat(walk_length)
    dst = walk[:, 1:].t().reshape(-1)  # step-major: all of step 1, then step 2...
    steps = torch.arange(1, walk_length + 1, device=walk.device, dtype=torch.float32)
    weights = (1.0 / steps).repeat_interleave(s)
    return torch.stack([src, dst], dim=1), weights, src != dst
