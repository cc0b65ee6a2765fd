"""Graph-parallel SpMM over a row-partitioned graph (port of the blocked-CSR
half of plnlp_tpu/parallel/graph_parallel.py).

Destination rows, and with them every node-feature tensor of the encoder,
are split over the mesh's ``node`` ranks in slot order: a rank holds the
``rows_per_shard`` rows of its shard (:func:`shard_node_features`).  Each
layer's aggregation runs the blocked scatter-matmul K1 on the rank's own
shard, after one of two exchanges over the ``node`` group:

* ``all_gather``: every rank's rows are gathered into a
  ``padded_nodes``-row buffer, and K1 sums the shard's in-edges over global
  source slots into its ``rows_per_shard`` output rows;
* ``halo``: an ``all_to_all_single`` of the quota-padded rows each peer
  reads and an all_gather of the hub rows (``parallel/halo.py``); K1 runs
  twice, over the shard's local edges (launched before the exchange is
  waited on, so it overlaps it) and over the remote edges into the
  exchanged buffer, and the two are summed.

The backward (dX = Aᵀ dY) runs the same body over the source-sharded
structure, so gradients land on the rank that owns the rows.  Mean scaling
divides by the shard's in-degrees.  Rows of the shard past the real nodes
(padding slots) have no edges: no K1 output reads them and their
gradients are zero.

:func:`gather_node_features` gathers the encoder's output rows of every
rank back into original node order (the predictor indexes arbitrary
nodes); its backward is a reduce-scatter.

The tiled partition (K2 on each shard) and the partitioned TransformerConv
are not ported yet (ROADMAP queue 1 item 11b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from plnlp_tpu_torch.ops.scatter_matmul import scatter_matmul
from plnlp_tpu_torch.ops.spmm import _mean_scale
from plnlp_tpu_torch.parallel.mesh import _ALL_GATHER, Mesh, all_gather_rows, gather_rows
from plnlp_tpu_torch.parallel.partition import (
    TILED_NOT_PORTED,
    PartitionedGraph,
    partition_graph,
    with_halo,
)

__all__ = [
    "GraphParallel",
    "make_graph_parallel",
    "choose_comm",
    "partitioned_spmm",
    "shard_node_features",
    "gather_node_features",
]

# The comm='auto' wire constant: the per-collective latency in equivalent
# row transfers.  The JAX package set it for the TPU's ICI; it is kept for
# parity and is not calibrated for NCCL (CLI --comm_latency_rows).
_DEFAULT_LATENCY_ROWS = 512


def _blocks_to(b: dict, device) -> dict:
    return {
        k: torch.from_numpy(np.ascontiguousarray(b[k])).to(device)
        for k in ("blk_src", "blk_weight", "blk_local", "blk_rowptr")
    }


@dataclasses.dataclass(frozen=True, eq=False)
class GraphParallel:
    """A partition, its mesh, the exchange (``'all_gather'`` or
    ``'halo'``) and this rank's shard on the mesh's device."""

    pg: PartitionedGraph
    mesh: Mesh
    comm: str
    fwd: dict  # this shard's forward blocks (tensors)
    bwd: dict
    fwd_halo: Optional[dict]  # loc/rem blocks, send_idx (S*q,), hub_idx (qh,)
    bwd_halo: Optional[dict]
    in_degrees: torch.Tensor  # (rows_per_shard,) int32, this shard's
    local_nodes: torch.Tensor  # (rows_per_shard,) int64: slot -> global position
    node_map: torch.Tensor  # (num_nodes,) int64: original node -> slot

    @property
    def num_nodes(self) -> int:
        return self.pg.num_nodes

    @property
    def rows_per_shard(self) -> int:
        return self.pg.rows_per_shard

    @property
    def device(self) -> torch.device:
        return self.in_degrees.device

    @classmethod
    def place(cls, pg: PartitionedGraph, mesh: Mesh, comm: str = "all_gather") -> "GraphParallel":
        """This rank's shard of ``pg`` on ``mesh.device``."""
        if pg.num_shards != mesh.node:
            raise ValueError(f"{pg.num_shards} shards over a mesh of node={mesh.node}")
        if comm not in ("all_gather", "halo"):
            raise ValueError(f"unknown comm: {comm!r}")
        if comm == "halo" and pg.fwd_halo is None:
            raise ValueError("comm='halo' needs a halo plan (with_halo / make_graph_parallel)")
        s, rps, dev = mesh.node_index, pg.rows_per_shard, mesh.device

        def halo(plan):
            if comm != "halo":
                return None
            return {
                "loc": _blocks_to(plan["loc"][s], dev),
                "rem": _blocks_to(plan["rem"][s], dev),
                "send_idx": torch.from_numpy(plan["send_idx"][s].reshape(-1)).long().to(dev),
                "hub_idx": torch.from_numpy(plan["hub_idx"][s]).long().to(dev),
            }

        if pg.perm_in is None:
            local_nodes = torch.arange(s * rps, (s + 1) * rps)
            node_map = torch.arange(pg.num_nodes)
        else:
            local_nodes = torch.from_numpy(pg.perm_in[s * rps:(s + 1) * rps]).long()
            node_map = torch.from_numpy(pg.node_map).long()
        return cls(
            pg=pg,
            mesh=mesh,
            comm=comm,
            fwd=_blocks_to(pg.fwd[s], dev),
            bwd=_blocks_to(pg.bwd[s], dev),
            fwd_halo=halo(pg.fwd_halo),
            bwd_halo=halo(pg.bwd_halo),
            in_degrees=torch.from_numpy(pg.local_in_degrees[s]).to(dev),
            local_nodes=local_nodes.to(dev),
            node_map=node_map.to(dev),
        )


def choose_comm(pg: PartitionedGraph, latency_rows: float = _DEFAULT_LATENCY_ROWS) -> str:
    """'halo' iff  q + qh + latency_rows < rows_per_shard  (the linear
    latency + bandwidth model of the JAX package: per layer pass the
    all-gather moves (S-1) rows_per_shard rows in S-1 messages, the halo
    (S-1)(q + qh) rows in 2(S-1)); the quotas are estimated from the
    boundary sets without building the plan."""
    from plnlp_tpu_torch.parallel.halo import estimate_halo_quotas

    S = pg.num_shards
    if S <= 1:
        return "all_gather"
    rps = pg.rows_per_shard
    qf, qhf = estimate_halo_quotas(
        [b["blk_src"] for b in pg.fwd], [b["blk_weight"] for b in pg.fwd], rps, S
    )
    qb, qhb = estimate_halo_quotas(
        [b["blk_src"] for b in pg.bwd], [b["blk_weight"] for b in pg.bwd], rps, S
    )
    halo_rows = max(qf, qb) + max(qhf, qhb)
    return "halo" if halo_rows + latency_rows < rps else "all_gather"


def make_graph_parallel(
    src,
    dst,
    weight=None,
    *,
    num_nodes: int,
    mesh: Mesh,
    block=(128, 512),
    symmetrize: bool = False,
    comm: str = "auto",
    latency_rows: float = _DEFAULT_LATENCY_ROWS,
    reorder: Optional[str] = None,
    tile: int = 0,
    order=None,
    log=None,
) -> GraphParallel:
    """Partition over the mesh's ``node`` ranks, choose the exchange and
    place this rank's shard.  Every rank runs the same host build."""
    if tile:
        raise NotImplementedError(TILED_NOT_PORTED)
    pg = partition_graph(
        src, dst, weight, num_nodes=num_nodes, num_shards=mesh.node, block=block,
        symmetrize=symmetrize, reorder=reorder, order=order,
    )
    if comm == "auto":
        comm = choose_comm(pg, latency_rows)
        if log is not None:
            log(f"partition_comm=auto -> {comm} (S={mesh.node}, rows_per_shard="
                f"{pg.rows_per_shard}, latency_rows={latency_rows})")
    if comm == "halo":
        pg = with_halo(pg)
    return GraphParallel.place(pg, mesh, comm)


def shard_node_features(x: torch.Tensor, gp: GraphParallel) -> torch.Tensor:
    """This rank's slot rows (rows_per_shard, D) of ``x`` ((num_nodes or
    padded_nodes, D) in original node order); padding slots get zero rows.
    Differentiable."""
    pad = gp.pg.padded_nodes - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x.index_select(0, gp.local_nodes.to(x.device))


def gather_node_features(y: torch.Tensor, gp: GraphParallel) -> torch.Tensor:
    """Every rank's rows of ``y`` in original node order (num_nodes, D), on
    every rank of the node group; the backward reduce-scatters the
    gradient back to the rows' owners."""
    return all_gather_rows(y, gp.mesh.node_group).index_select(0, gp.node_map)


def _k1(x: torch.Tensor, b: dict, gp: GraphParallel) -> torch.Tensor:
    return scatter_matmul(
        x.contiguous(), b["blk_src"], b["blk_local"], b["blk_weight"], b["blk_rowptr"],
        gp.pg.block_rows, gp.rows_per_shard,
    )


def _apply_halo(gp: GraphParallel, x: torch.Tensor, plan: dict) -> torch.Tensor:
    group = gp.mesh.node_group
    send = x.index_select(0, plan["send_idx"])  # (S*q, D), ordered by destination shard
    hub_rows = x.index_select(0, plan["hub_idx"])
    if group is None:
        halo, hubs, pending = send, hub_rows, ()
    else:
        halo = torch.empty_like(send)
        hubs = x.new_empty((gp.mesh.node * hub_rows.shape[0], x.shape[1]))
        pending = (
            dist.all_to_all_single(halo, send, group=group, async_op=True),
            _ALL_GATHER(hubs, hub_rows, group=group, async_op=True),
        )
    local_out = _k1(x, plan["loc"], gp)  # needs no exchanged row: overlaps it
    for work in pending:
        work.wait()
    return local_out + _k1(torch.cat([halo, hubs]), plan["rem"], gp)


def _direction(gp: GraphParallel, x: torch.Tensor, direction: str) -> torch.Tensor:
    if gp.comm == "halo":
        return _apply_halo(gp, x, gp.fwd_halo if direction == "fwd" else gp.bwd_halo)
    return _k1(gather_rows(x, gp.mesh.node_group), gp.fwd if direction == "fwd" else gp.bwd, gp)


class PartitionedSpmm(torch.autograd.Function):
    """The forward over the destination-sharded structure, the backward
    over the source-sharded one."""

    @staticmethod
    def forward(ctx, x, gp: GraphParallel, reduce: str):
        ctx.gp, ctx.reduce = gp, reduce
        y = _direction(gp, x, "fwd")
        return _mean_scale(gp, y) if reduce == "mean" else y

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce == "mean":
            g = _mean_scale(ctx.gp, g)
        return _direction(ctx.gp, g, "bwd"), None, None


def partitioned_spmm(gp: GraphParallel, x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """Row-sharded SpMM: ``x`` is this rank's (rows_per_shard, D) slot rows
    (:func:`shard_node_features`); returns its (rows_per_shard, D) output
    rows.  Collective: every rank of the node group calls it."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce: {reduce}")
    if x.shape[0] != gp.rows_per_shard:
        raise ValueError(
            f"x has {x.shape[0]} rows; a rank holds rows_per_shard={gp.rows_per_shard} "
            "(shard_node_features)"
        )
    return PartitionedSpmm.apply(x, gp, reduce)
