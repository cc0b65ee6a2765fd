"""Sparse x dense aggregation (port of plnlp_tpu/ops/spmm.py).

* :func:`spmm_segment` — gather + ``index_add_`` over the CSR edge list:
  the oracle, and the path for graphs without blocked metadata.
* :func:`spmm_blocked` — the production path: the blocked scatter-matmul
  (``ops/scatter_matmul.py``, a CUDA kernel on the card) forward, and the
  same kernel over the transposed graph backward (dX = Aᵀ dY).
* a :class:`~plnlp_tpu_torch.ops.tile_spmm.HybridGraph` goes to
  ``hybrid_spmm`` (dense tiles + blocked residual, ``ops/tile_spmm.py``).
* a ``GraphParallel`` goes to ``parallel.graph_parallel.partitioned_spmm``
  (K1 on this rank's shard after the feature exchange);
* a :class:`~plnlp_tpu_torch.dense.DenseAdj` goes to :func:`spmm_dense`,
  one ``torch.matmul`` (the JAX package's ``jnp.dot``, outside Pallas).

Both support ``reduce ∈ {sum, mean}`` with torch_sparse semantics: mean
divides by the in-degree, 0 for isolated rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from plnlp_tpu_torch.dense import DenseAdj
from plnlp_tpu_torch.graph import Graph
from plnlp_tpu_torch.ops.scatter_matmul import scatter_matmul
from plnlp_tpu_torch.ops.tile_spmm import HybridGraph, hybrid_spmm

__all__ = [
    "spmm", "spmm_segment", "spmm_blocked", "spmm_dense", "blocked_sum_arrays", "SpmmBlocked",
]


def _mean_scale(graph, out: torch.Tensor) -> torch.Tensor:
    """``out`` divided by the in-degree of each row, 0 for isolated rows."""
    deg = graph.in_degrees
    scale = torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0).to(out.dtype)
    return out * scale[:, None]


def _check_reduce(reduce: str) -> None:
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce: {reduce}")


def spmm_segment(graph: Graph, x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """out[i] = reduce_{e: receivers[e]==i} edge_weight[e] * x[senders[e]]."""
    _check_reduce(reduce)
    msgs = x[graph.senders] * graph.edge_weight[:, None].to(x.dtype)
    out = x.new_zeros((graph.num_nodes, x.shape[1])).index_add_(
        0, graph.receivers, msgs
    )
    return _mean_scale(graph, out) if reduce == "mean" else out


def spmm_dense(graph: DenseAdj, x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """``adj @ x`` over the dense adjacency (row = destination)."""
    _check_reduce(reduce)
    out = torch.matmul(graph.adj.to(x.dtype), x)
    return _mean_scale(graph, out) if reduce == "mean" else out


def blocked_sum_arrays(
    x: torch.Tensor,
    blk_src: torch.Tensor,  # (nblk, B) int32
    blk_weight: torch.Tensor,  # (nblk, B) float32 (0 = padding)
    blk_local: torch.Tensor,  # (nblk, B) int32
    blk_rowptr: torch.Tensor,  # (n_rowblocks + 1,) int32
    block_rows: int,
    out_rows: int,
) -> torch.Tensor:
    """Array-level blocked weighted-sum aggregation -> (out_rows, D), in the
    argument order of plnlp_tpu's ``blocked_sum_arrays`` (with the row-block
    pointer in place of the per-sub-block row-block id)."""
    return scatter_matmul(
        x.contiguous(), blk_src, blk_local, blk_weight, blk_rowptr,
        block_rows, out_rows,
    )


def _blocked_sum(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    if graph.blk_src is None:
        raise ValueError("graph has no blocking metadata; call with_blocks()")
    return blocked_sum_arrays(
        x, graph.blk_src, graph.blk_weight, graph.blk_local, graph.blk_rowptr,
        graph.block_rows, graph.num_nodes,
    )


class SpmmBlocked(torch.autograd.Function):
    """Blocked SpMM whose backward is the same kernel over ``graph_t``."""

    @staticmethod
    def forward(ctx, x, graph: Graph, graph_t: Optional[Graph], reduce: str):
        ctx.graph, ctx.graph_t, ctx.reduce = graph, graph_t, reduce
        out = _blocked_sum(graph, x)
        return _mean_scale(graph, out) if reduce == "mean" else out

    @staticmethod
    def backward(ctx, g):
        if ctx.graph_t is None:
            raise ValueError("the blocked SpMM backward needs graph_t")
        if ctx.reduce == "mean":
            g = _mean_scale(ctx.graph, g)
        return _blocked_sum(ctx.graph_t, g), None, None, None


def spmm_blocked(
    graph: Graph, graph_t: Optional[Graph], x: torch.Tensor, reduce: str = "sum"
) -> torch.Tensor:
    """Blocked SpMM; ``graph_t`` is the blocked transpose (from
    ``prepare_graph``) and is needed only when a gradient flows to ``x``."""
    _check_reduce(reduce)
    return SpmmBlocked.apply(x, graph, graph_t, reduce)


def spmm(graph, x: torch.Tensor, reduce: str = "sum", graph_t=None) -> torch.Tensor:
    """Aggregate ``x`` over ``graph``: the dense matmul for a ``DenseAdj``,
    the hybrid operator for a ``HybridGraph`` (which carries its own
    transpose), the partitioned SpMM for a ``GraphParallel`` (``x`` is this
    rank's rows), the blocked kernel path when the graph carries blocked
    metadata, the segment path otherwise."""
    if isinstance(graph, DenseAdj):
        return spmm_dense(graph, x, reduce)
    if isinstance(graph, HybridGraph):
        return hybrid_spmm(graph, x, reduce)
    from plnlp_tpu_torch.parallel.graph_parallel import GraphParallel, partitioned_spmm

    if isinstance(graph, GraphParallel):
        return partitioned_spmm(graph, x, reduce)
    if not isinstance(graph, Graph):
        raise TypeError(f"unknown aggregation operand: {type(graph).__name__}")
    if graph.blk_src is not None:
        return spmm_blocked(graph, graph_t, x, reduce)
    return spmm_segment(graph, x, reduce)
