"""Per-edge dot products and the edge softmax (port of plnlp_tpu/ops/sddmm.py).

With SpMM they compose TransformerConv: the logit of edge e is
q[receivers[e]] · k[senders[e]] / √d, the softmax runs over each
destination's in-edges, and the values are summed with those weights.
Edges are sorted by destination (a ``Graph`` invariant).
"""

from __future__ import annotations

import torch

from plnlp_tpu_torch.graph import Graph

__all__ = ["sddmm_dot", "edge_softmax"]

_TINY = torch.finfo(torch.float32).tiny


def sddmm_dot(graph: Graph, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """out[e] = q[receivers[e]] · k[senders[e]]."""
    return (q[graph.receivers] * k[graph.senders]).sum(-1)


def edge_softmax(graph: Graph, logits: torch.Tensor) -> torch.Tensor:
    """Softmax of per-edge logits over each destination's in-edges, in
    float32, max-subtracted; edges of weight 0 get 0.  The row max is taken
    without a gradient: the softmax does not depend on the shift."""
    out_dtype = logits.dtype
    logits = logits.float()
    valid = graph.edge_weight != 0
    recv = graph.receivers.long()
    masked = torch.where(valid, logits, float("-inf")).detach()
    seg_max = logits.new_full((graph.num_nodes,), float("-inf")).scatter_reduce_(
        0, recv, masked, "amax"
    )
    # rows with no edge keep -inf; read it as 0 so exp() below stays finite
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.where(valid, torch.exp(logits - seg_max[recv]), 0.0)
    seg_sum = logits.new_zeros(graph.num_nodes).index_add_(0, recv, ex)
    return (ex / seg_sum.clamp(min=_TINY)[recv]).to(out_dtype)
