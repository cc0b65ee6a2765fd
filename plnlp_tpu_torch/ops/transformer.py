"""Blocked TransformerConv with a hand-written backward over blocked CSR
(port of plnlp_tpu/ops/transformer.py).

One head, as the reference TransformerConv: α_ij = softmax_j(⟨q_i, k_j⟩/√d),
out_i = skip(x_i) + Σ_j α_ij v_j, adjacency values ignored (an edge slot of
weight 0 is padding).  Every feature-width sum runs as K1
(``ops/scatter_matmul.scatter_matmul``) with per-call edge weights, over
the graph (destination-grouped) or its transpose (source-grouped); the
per-edge scalars cross between the two layouts through the slot pairing
``graph.tconv_map`` (``graph.prepare_graph(couple_transpose=True)``):

    agg[dst]  = Σ_e α_e v[src_e]                  K1 over graph, weights α
    dα_e      = g[dst_e] · v[src_e]
    dlogit_e  = α_e (dα_e − Σ_{e' into dst_e} α dα)  (scalar segment sums)
    dq[dst]   = Σ_e (dlogit_e/√d) k[src_e]        K1 over graph
    dk[src]   = Σ_e (dlogit_e/√d) q[dst_e]        K1 over graph_t
    dv[src]   = Σ_e α_e g[dst_e]                  K1 over graph_t

so a layer launches K1 once forward and three times backward.  The logits,
α, dα and the softmax are float32 whatever the compute dtype; in bfloat16
q, k, v and g go into K1 in bf16 (K1 rounds each weight to bf16 and sums in
f32) and agg, dq, dk and dv come back in bf16, as the JAX package casts.

The linears stay outside the Function, under autograd; it saves q, k, v and
α (the JAX version recomputes q, k, v from x in its backward).  JAX's
``feats=`` pre-gathered entry of ``blocked_sum_arrays`` is not needed: K1
gathers the source rows itself.

K1 skips slots whose weight (rounded to x's dtype) is exactly 0.  Here the
weights are computed per call and are 0 at live slots (dlogit on a row
with one in-edge, an underflowed α); such a slot adds 0 either way, and the
kernel's runs and carries key on the rows of the slots it takes, so a
skipped slot mid-row leaves them right.
"""

from __future__ import annotations

import math

import torch

from plnlp_tpu_torch.graph import Graph
from plnlp_tpu_torch.nn import apply_linear
from plnlp_tpu_torch.ops.scatter_matmul import scatter_matmul

__all__ = ["transformer_conv_blocked", "BlockedAttn"]

_TINY = torch.finfo(torch.float32).tiny


def _slot_dst(graph: Graph) -> torch.Tensor:
    """(nblk, B) destination row of each slot (padding: its row-block's
    first row, which is < num_nodes)."""
    return graph.blk_rowblock[:, None].long() * graph.block_rows + graph.blk_local


def _rowdot(a: torch.Tensor, ia: torch.Tensor, b: torch.Tensor, ib: torch.Tensor):
    """Σ_d a[ia] b[ib] per slot, in float32 (bf16 rows are exact in f32)."""
    return (a[ia].float() * b[ib].float()).sum(-1)


def _k1(x, graph: Graph, weight: torch.Tensor) -> torch.Tensor:
    return scatter_matmul(x.contiguous(), graph.blk_src, graph.blk_local, weight.contiguous(),
                          graph.blk_rowptr, graph.block_rows, graph.num_nodes)


class BlockedAttn(torch.autograd.Function):
    """agg (num_nodes, D) = Σ_j α_ij v_j over the blocked graph, in v's
    dtype, with the hand-written backward of the module note."""

    @staticmethod
    def forward(ctx, q, k, v, graph: Graph, graph_t: Graph):
        n, d = q.shape
        dst, src = _slot_dst(graph), graph.blk_src
        valid = graph.blk_weight != 0
        logits = _rowdot(q, dst, k, src) / math.sqrt(d)
        flat_dst = dst.reshape(-1)
        masked = torch.where(valid, logits, float("-inf")).reshape(-1)
        seg_max = logits.new_full((n,), float("-inf")).scatter_reduce_(0, flat_dst, masked, "amax")
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
        ex = torch.where(valid, torch.exp(logits - seg_max[dst]), 0.0)
        seg_sum = logits.new_zeros(n).index_add_(0, flat_dst, ex.reshape(-1))
        alpha = ex / seg_sum.clamp(min=_TINY)[dst]
        ctx.graphs = (graph, graph_t)
        ctx.save_for_backward(q, k, v, alpha)
        return _k1(v, graph, alpha)

    @staticmethod
    def backward(ctx, gy):
        q, k, v, alpha = ctx.saved_tensors
        graph, graph_t = ctx.graphs
        n, d = q.shape
        inv_sqrt_d = 1.0 / math.sqrt(d)
        g = gy.to(v.dtype).contiguous()
        dst, src = _slot_dst(graph), graph.blk_src
        valid = graph.blk_weight != 0
        dalpha = torch.where(valid, _rowdot(g, dst, v, src), 0.0)
        row_s = alpha.new_zeros(n).index_add_(0, dst.reshape(-1), (alpha * dalpha).reshape(-1))
        dlogit = torch.where(valid, alpha * (dalpha - row_s[dst]), 0.0)
        dq = _k1(k, graph, dlogit * inv_sqrt_d)
        # (dlogit, α) to the transposed layout in one two-wide gather
        da = torch.stack([dlogit.reshape(-1), alpha.reshape(-1)], -1)[graph.tconv_map.long()]
        da = torch.where((graph_t.blk_weight != 0)[..., None], da, 0.0)
        dk = _k1(q, graph_t, da[..., 0] * inv_sqrt_d)
        dv = _k1(g, graph_t, da[..., 1])
        return dq, dk, dv, None, None


def transformer_conv_blocked(lp, graph: Graph, graph_t: Graph, x: torch.Tensor) -> torch.Tensor:
    """One TransformerConv layer (``lp``: the ``lin_query``, ``lin_key``,
    ``lin_value``, ``lin_skip`` linears) over a blocked CSR graph and its
    blocked transpose, with the hand-written backward.  Needs
    ``graph.tconv_map`` (``prepare_graph(..., couple_transpose=True)``)."""
    if graph.tconv_map is None:
        raise ValueError(
            "transformer_conv_blocked needs graph.tconv_map: build with "
            "prepare_graph(..., couple_transpose=True)"
        )
    q, k, v = (apply_linear(lp[name], x) for name in ("lin_query", "lin_key", "lin_value"))
    agg = BlockedAttn.apply(q, k, v, graph, graph_t)
    return agg + apply_linear(lp["lin_skip"], x)
