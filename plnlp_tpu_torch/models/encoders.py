"""GNN encoders: SAGE / GCN / WSAGE / TRANSFORMER (port of
plnlp_tpu/models/encoders.py).

Each layer is linears around one aggregation over the full graph: an SpMM
(``ops/spmm.py``), or for TRANSFORMER an attention-weighted sum.
Stacking follows the reference BaseGNN: conv -> relu -> dropout between
layers, the last layer linear, except that a single-layer stack applies
relu and dropout after its one layer.

Over a perm-free ``HybridGraph`` the stack runs padded-carry: x is padded
once to num_nodes rounded up to the tile size and sliced once at the end,
so no layer pads or slices (``ops/tile_spmm.is_padded_operand``).  Pad rows
carry garbage (bias, relu) that never reaches a real row: pad nodes have
no edges, and their cotangents are zero.

* SAGE  — out = lin_l(mean_{j∈N(i)} x_j) + lin_r(x_i); bias on lin_l only.
* GCN   — out = Â (x W) + b with Â precomputed (gcn_normalize_edges).
* WSAGE — out = lin_rel(Σ_j w_ij x_j) + lin_root(x_i), D⁻¹A precomputed.
* TRANSFORMER — TransformerConv (one head): α_ij = softmax_j(⟨W_q x_i,
  W_k x_j⟩/√d), out = W_skip x_i + Σ_j α_ij W_v x_j, adjacency values
  ignored.  Dispatched in the JAX package's order: over a
  ``GraphParallel`` the partitioned TransformerConv
  (``parallel/graph_parallel.partitioned_transformer_conv``; x is this
  rank's rows: K1 over a blocked partition, K3-K5 on the shard's tiles
  and K1 on its residual over a tiled one,
  ``parallel/tile_transformer.py``); over a
  ``HybridGraph`` the block-sparse flash path (``ops/tile_attention.py``);
  over a blocked ``Graph`` with ``tconv_map`` and a blocked transpose the
  hand-written backward on K1 (``ops/transformer.py``); over a
  ``DenseAdj`` dense attention masked where the adjacency is zero, with
  float32 logits and softmax; otherwise the per-edge path below.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from plnlp_tpu_torch.dense import DenseAdj
from plnlp_tpu_torch.graph import Graph, _pad_to
from plnlp_tpu_torch.nn import apply_linear, glorot_init, torch_linear_init
from plnlp_tpu_torch.nn import dropout as _dropout
from plnlp_tpu_torch.ops import transformer as blocked_transformer
from plnlp_tpu_torch.ops.sddmm import edge_softmax
from plnlp_tpu_torch.ops.spmm import spmm
from plnlp_tpu_torch.ops.tile_attention import hybrid_transformer_conv
from plnlp_tpu_torch.ops.tile_spmm import HybridGraph
from plnlp_tpu_torch.parallel.graph_parallel import GraphParallel, partitioned_transformer_conv

ENCODER_NAMES = ("SAGE", "GCN", "WSAGE", "TRANSFORMER")

__all__ = ["Encoder", "ENCODER_NAMES"]


def _layer_dims(in_ch, hidden_ch, out_ch, num_layers):
    return [
        (in_ch if i == 0 else hidden_ch, out_ch if i == num_layers - 1 else hidden_ch)
        for i in range(num_layers)
    ]


def _sage_conv(lp, graph, graph_t, x):
    agg = spmm(graph, x, reduce="mean", graph_t=graph_t)
    return apply_linear(lp["lin_l"], agg) + apply_linear(lp["lin_r"], x)


def _gcn_conv(lp, graph, graph_t, x):
    # GCNConv order: out = Â (x W) + b (bias added after aggregation).
    lin = lp["lin"]
    hw = x @ lin.weight.to(x.dtype).t()
    return spmm(graph, hw, reduce="sum", graph_t=graph_t) + lin.bias.to(x.dtype)


def _wsage_conv(lp, graph, graph_t, x):
    agg = spmm(graph, x, reduce="sum", graph_t=graph_t)
    return apply_linear(lp["lin_rel"], agg) + apply_linear(lp["lin_root"], x)


def _transformer_conv(lp, graph, graph_t, x):
    if isinstance(graph, GraphParallel):
        return partitioned_transformer_conv(graph, lp, x)
    if isinstance(graph, HybridGraph):
        return hybrid_transformer_conv(lp, graph, x)
    if not isinstance(graph, (Graph, DenseAdj)):
        raise TypeError(f"unknown aggregation operand: {type(graph).__name__}")
    if (
        isinstance(graph, Graph) and graph.blk_src is not None and graph.tconv_map is not None
        and graph_t is not None and graph_t.blk_src is not None
    ):
        return blocked_transformer.transformer_conv_blocked(lp, graph, graph_t, x)
    d = lp["lin_query"].out_features
    q, k, v = (apply_linear(lp[name], x) for name in ("lin_query", "lin_key", "lin_value"))
    if isinstance(graph, DenseAdj):
        # The mask is a select, never a product: the row max is taken over
        # the edges only, exp sees 0 off the edges (no inf, so no NaN in the
        # gradient), and a row without an in-edge keeps only the skip term.
        # The logits and the softmax are float32 (bf16 products are exact in
        # f32); the probabilities meet v in x's dtype.
        logits = (q.float() @ k.float().t()) / math.sqrt(d)
        mask = graph.adj != 0
        f32 = torch.finfo(torch.float32)
        m = torch.where(mask, logits, f32.min).amax(1, keepdim=True)
        ex = torch.where(mask, torch.exp(torch.where(mask, logits - m, 0.0)), 0.0)
        denom = ex.sum(1, keepdim=True).clamp(min=f32.tiny)
        return (ex / denom).to(x.dtype) @ v + apply_linear(lp["lin_skip"], x)
    # per-edge path; k and v are gathered at the same ids in one wide gather
    kv = torch.cat([k, v], -1)[graph.senders]
    logits = (q[graph.receivers] * kv[:, :d]).sum(-1) / math.sqrt(d)
    alpha = edge_softmax(graph, logits)
    agg = x.new_zeros((graph.num_nodes, d)).index_add_(
        0, graph.receivers, kv[:, d:] * alpha[:, None]
    )
    return agg + apply_linear(lp["lin_skip"], x)


_CONVS = {
    "SAGE": _sage_conv,
    "GCN": _gcn_conv,
    "WSAGE": _wsage_conv,
    "TRANSFORMER": _transformer_conv,
}


class Encoder(nn.Module):
    """``layers[i]`` is a ModuleDict named as in the JAX params pytree
    (``lin_l``/``lin_r``, ``lin``, ``lin_rel``/``lin_root``,
    ``lin_query``/``lin_key``/``lin_value``/``lin_skip``)."""

    def __init__(
        self,
        gen: torch.Generator,
        name: str,
        in_channels: int,
        hidden_channels: int,
        num_layers: int,
        out_channels: Optional[int] = None,
    ):
        super().__init__()
        self.name = name.upper()
        if self.name not in _CONVS:
            raise ValueError(f"unknown encoder: {name}")
        out_channels = hidden_channels if out_channels is None else out_channels
        layers = []
        for fan_in, fan_out in _layer_dims(
            in_channels, hidden_channels, out_channels, num_layers
        ):
            if self.name == "SAGE":
                lp = {
                    "lin_l": torch_linear_init(gen, fan_in, fan_out, bias=True),
                    "lin_r": torch_linear_init(gen, fan_in, fan_out, bias=False),
                }
            elif self.name == "GCN":
                lp = {"lin": glorot_init(gen, fan_in, fan_out, bias=True)}
            elif self.name == "TRANSFORMER":
                lp = {
                    name: torch_linear_init(gen, fan_in, fan_out, bias=True)
                    for name in ("lin_query", "lin_key", "lin_value", "lin_skip")
                }
            else:
                lp = {
                    "lin_rel": torch_linear_init(gen, fan_in, fan_out, bias=True),
                    "lin_root": torch_linear_init(gen, fan_in, fan_out, bias=False),
                }
            layers.append(nn.ModuleDict(lp))
        self.layers = nn.ModuleList(layers)

    def forward(
        self,
        graph,
        x: torch.Tensor,
        graph_t=None,
        *,
        dropout: float = 0.0,
        train: bool = False,
        gen: Optional[torch.Generator] = None,
        remat: bool = False,
    ) -> torch.Tensor:
        """``remat=True`` recomputes each conv in the backward
        (``torch.utils.checkpoint``): activation memory for FLOPs."""
        conv = _CONVS[self.name]
        if remat:
            plain = conv

            def conv(lp, graph, graph_t, x):
                return checkpoint(plain, lp, graph, graph_t, x, use_reentrant=False)

        n = x.shape[0]
        pad_rows = 0
        if isinstance(graph, HybridGraph) and graph.perm_in is None and n == graph.num_nodes:
            pad_rows = _pad_to(n, graph.tile) - n
            if pad_rows:
                x = torch.cat([x, x.new_zeros((pad_rows, x.shape[1]))])
        for lp in self.layers[:-1]:
            x = torch.relu(conv(lp, graph, graph_t, x))
            x = _dropout(x, dropout, gen, train)
        x = conv(self.layers[-1], graph, graph_t, x)
        if len(self.layers) == 1:
            # Reference quirk: a single-layer stack applies relu and dropout
            # to its last layer (layer.py:23-27).
            x = _dropout(torch.relu(x), dropout, gen, train)
        return x[:n] if pad_rows else x
