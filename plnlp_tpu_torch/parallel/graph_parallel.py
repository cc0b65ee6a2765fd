"""Graph-parallel SpMM and TransformerConv over a row-partitioned graph
(port of plnlp_tpu/parallel/graph_parallel.py).

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

Over a tiled partition (``partition_graph(tile>0)``) the exchange is the
all_gather, and the shard's rows are the tile kernel K2
(``ops/tile_matmul.py``) over its dense tiles plus K1 over its blocked
residual, both reading the gathered buffer: one K2 and one K1 launch a
pass (JAX's ``_apply_tiles``).

The backward (dX = Aᵀ dY) runs the same body over the source-sharded
structure (and the transposed tiles), so gradients land on the rank that
owns the rows.  Mean scaling divides by the shard's in-degrees.  Rows of
the shard past the real nodes (padding slots) have no edges: no kernel
output reads them and their gradients are zero.

:func:`partitioned_transformer_conv` is the TransformerConv over the
blocked (untiled) partition, with the hand-written backward of
``ops/transformer.py`` on K1: a destination's in-edges all lie on its
shard, so each softmax is shard-local; the per-edge scalars cross to the
source-sharded layout through ``bwd_gather_fwd`` after one all_gather.
Over a tiled partition it runs ``parallel/tile_transformer.py`` (K3-K5 on
the shard's tiles).

:func:`gather_node_features` gathers the encoder's output rows of every
rank back into original node order (the predictor indexes arbitrary
nodes); its backward is a reduce-scatter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from plnlp_tpu_torch.nn import COMPUTE_DTYPES, apply_linear
from plnlp_tpu_torch.ops.scatter_matmul import scatter_matmul
from plnlp_tpu_torch.ops.spmm import _mean_scale
from plnlp_tpu_torch.ops.tile_matmul import tile_matmul
from plnlp_tpu_torch.parallel.mesh import _ALL_GATHER, Mesh, all_gather_rows, gather_rows
from plnlp_tpu_torch.parallel.partition import PartitionedGraph, partition_graph, with_halo

__all__ = [
    "GraphParallel",
    "make_graph_parallel",
    "choose_comm",
    "partitioned_spmm",
    "partitioned_transformer_conv",
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
        for k in ("blk_src", "blk_weight", "blk_local", "blk_rowblock", "blk_rowptr")
    }


def _tiles_to(t: dict, store: str, device) -> dict:
    out = {k: torch.from_numpy(t[k]).to(device) for k in ("row", "col", "rowptr")}
    vals = torch.from_numpy(t["vals"])
    out["vals"] = (vals if store == "int8" else vals.to(COMPUTE_DTYPES[store])).to(device)
    return out


def _padded_slot_map(pg: PartitionedGraph, s: int):
    """Shard ``s``'s ``bwd_gather_fwd`` translated into the all-gathered
    layout of every shard's forward slots, each shard padded to the
    largest shard's slot count (equal sizes for the collective); and that
    count."""
    sizes = np.array([b["blk_src"].size for b in pg.fwd], np.int64)
    stride = int(sizes.max())
    starts = np.concatenate([[0], np.cumsum(sizes)])
    flat = pg.bwd_gather_fwd[s].astype(np.int64)
    owner = np.searchsorted(starts, flat, side="right") - 1
    return torch.from_numpy(owner * stride + flat - starts[owner]), stride


@dataclasses.dataclass(frozen=True, eq=False)
class GraphParallel:
    """A partition, its mesh, the exchange (``'all_gather'`` or
    ``'halo'``) and this rank's shard on the mesh's device."""

    pg: PartitionedGraph
    mesh: Mesh
    comm: str
    fwd: dict  # this shard's forward blocks (tensors; the residual when tiled)
    bwd: dict
    fwd_halo: Optional[dict]  # loc/rem blocks, send_idx (S*q,), hub_idx (qh,)
    bwd_halo: Optional[dict]
    in_degrees: torch.Tensor  # (rows_per_shard,) int32, this shard's
    local_nodes: torch.Tensor  # (rows_per_shard,) int64: slot -> global position
    node_map: torch.Tensor  # (num_nodes,) int64: original node -> slot
    # this shard's tiles (vals, row, col, rowptr), None when untiled
    tiles: Optional[dict] = None
    tiles_t: Optional[dict] = None
    # for each bwd slot, its forward slot in the all-gathered per-edge
    # scalars of every shard (each padded to slot_stride); the
    # TransformerConv's backward
    slot_map: Optional[torch.Tensor] = None
    slot_stride: int = 0

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
        if pg.tile and comm != "all_gather":
            raise ValueError("a tiled partition runs comm='all_gather' (tiles read the "
                             "whole gathered buffer)")
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
        tiles = tiles_t = None
        if pg.tile:
            # the flash kernels gather from the S * rows_per_shard rows of
            # the all-gathered buffer; checked here, once, on the host
            n_cols = pg.num_shards * rps // pg.tile
            for name, t in (("tiles", pg.tiles[s]), ("tiles_t", pg.tiles_t[s])):
                if t["col"].size and int(t["col"].max()) >= n_cols:
                    raise ValueError(f"shard {s}'s {name} reach column tile {int(t['col'].max())},"
                                     f" past the {n_cols} of the gathered buffer")
            tiles = _tiles_to(pg.tiles[s], pg.tile_store, dev)
            tiles_t = _tiles_to(pg.tiles_t[s], pg.tile_store, dev)
        slot_map, slot_stride = _padded_slot_map(pg, s)
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
            tiles=tiles,
            tiles_t=tiles_t,
            slot_map=slot_map.to(dev),
            slot_stride=slot_stride,
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
    min_fill: Optional[int] = None,
    tile_dtype: str = "float32",
    max_tile_bytes: int = 2 * 1024**3,
    order=None,
    log=None,
) -> GraphParallel:
    """Partition over the mesh's ``node`` ranks, choose the exchange and
    place this rank's shard.  Every rank runs the same host build.
    ``tile`` > 0 builds the tiled partition (``partition_graph``): its
    tiles read the whole gathered buffer, so the exchange is pinned to
    'all_gather', and the reorder defaults to 'labelprop' (community-
    contiguous slots are what make tiles dense)."""
    if tile:
        if reorder in (None, "auto"):
            reorder = "labelprop"
        if comm not in ("auto", "all_gather"):
            raise ValueError(
                "tile > 0 requires comm='all_gather' (tiles read the full gathered feature "
                f"buffer), got comm={comm!r}"
            )
        comm = "all_gather"
    pg = partition_graph(
        src, dst, weight, num_nodes=num_nodes, num_shards=mesh.node, block=block,
        symmetrize=symmetrize, reorder=reorder, tile=tile, min_fill=min_fill,
        tile_dtype=tile_dtype, max_tile_bytes=max_tile_bytes, order=order,
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


def _k1(x: torch.Tensor, b: dict, gp: GraphParallel, weight=None) -> torch.Tensor:
    """K1 over blocks ``b`` into this shard's rows, with the blocks' edge
    weights or per-call slot weights."""
    weight = b["blk_weight"] if weight is None else weight.contiguous()
    return scatter_matmul(
        x.contiguous(), b["blk_src"], b["blk_local"], weight, b["blk_rowptr"],
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


def _apply_tiles(gp: GraphParallel, x_full: torch.Tensor, blocks: dict, tiles: dict):
    """The tiled body over the gathered buffer: K2 over the shard's tiles
    plus K1 over its residual, both into its rows_per_shard rows."""
    rps = gp.rows_per_shard
    out = tile_matmul(tiles["vals"], tiles["row"], tiles["col"], tiles["rowptr"], x_full, rps)
    return out + _k1(x_full, blocks, gp)


def _direction(gp: GraphParallel, x: torch.Tensor, direction: str) -> torch.Tensor:
    if gp.comm == "halo":
        return _apply_halo(gp, x, gp.fwd_halo if direction == "fwd" else gp.bwd_halo)
    x_full = gather_rows(x.contiguous(), gp.mesh.node_group)
    blocks = gp.fwd if direction == "fwd" else gp.bwd
    if gp.tiles is not None:
        return _apply_tiles(gp, x_full, blocks, gp.tiles if direction == "fwd" else gp.tiles_t)
    return _k1(x_full, blocks, gp)


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


# ---------------------------------------------------------------------------
# The partitioned TransformerConv over blocked CSR
# ---------------------------------------------------------------------------

_TINY = torch.finfo(torch.float32).tiny


def _slot_rows(b: dict, R: int) -> torch.Tensor:
    """(nblk, B) shard-local row of each slot (padding: a row of its
    row-block)."""
    return b["blk_rowblock"][:, None].long() * R + b["blk_local"]


def _rowdot(a, ia, b, ib):
    """Σ_d a[ia] b[ib] per slot, in float32 (bf16 rows are exact in f32)."""
    return (a[ia].float() * b[ib].float()).sum(-1)


class PartitionedAttn(torch.autograd.Function):
    """agg (rows_per_shard, d) = Σ_j α_ij v_j for this shard's destination
    rows, from this rank's q, k, v rows; k and v are all-gathered inside,
    so every input gradient comes back on this rank's own rows (dk and dv
    through the source-sharded blocks), and no reduce-scatter is needed.

    Saved for the backward: this rank's q, the gathered k and v, and α
    over the shard's forward slots (the JAX version recomputes q, k, v
    from x instead).  The backward all-gathers q, g and the per-edge
    (dlogit, α), then runs K1 three times: dq over the forward blocks, dk
    and dv over the backward blocks."""

    @staticmethod
    def forward(ctx, q, k, v, gp: GraphParallel):
        group = gp.mesh.node_group
        rows, d = q.shape
        k_full = gather_rows(k.contiguous(), group)
        v_full = gather_rows(v.contiguous(), group)
        b = gp.fwd
        dst, src = _slot_rows(b, gp.pg.block_rows), b["blk_src"]
        valid = b["blk_weight"] != 0
        logits = _rowdot(q, dst, k_full, src) / math.sqrt(d)
        flat_dst = dst.reshape(-1)
        masked = torch.where(valid, logits, float("-inf")).reshape(-1)
        seg_max = logits.new_full((rows,), float("-inf")).scatter_reduce_(
            0, flat_dst, masked, "amax")
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
        ex = torch.where(valid, torch.exp(logits - seg_max[dst]), 0.0)
        seg_sum = logits.new_zeros(rows).index_add_(0, flat_dst, ex.reshape(-1))
        alpha = ex / seg_sum.clamp(min=_TINY)[dst]
        ctx.gp = gp
        ctx.save_for_backward(q, k_full, v_full, alpha)
        return _k1(v_full, b, gp, alpha)

    @staticmethod
    def backward(ctx, gy):
        q, k_full, v_full, alpha = ctx.saved_tensors
        gp = ctx.gp
        group = gp.mesh.node_group
        rows, d = q.shape
        inv_sqrt_d = 1.0 / math.sqrt(d)
        g = gy.to(v_full.dtype).contiguous()
        b, bt = gp.fwd, gp.bwd
        dst, src = _slot_rows(b, gp.pg.block_rows), b["blk_src"]
        valid = b["blk_weight"] != 0
        dalpha = torch.where(valid, _rowdot(g, dst, v_full, src), 0.0)
        row_s = alpha.new_zeros(rows).index_add_(0, dst.reshape(-1), (alpha * dalpha).reshape(-1))
        dlogit = torch.where(valid, alpha * (dalpha - row_s[dst]), 0.0)
        dq = _k1(k_full, b, gp, dlogit * inv_sqrt_d)
        # (dlogit, α) of every shard's forward slots, each shard padded to
        # the largest slot count, then read in the backward layout
        da = torch.stack([dlogit.reshape(-1), alpha.reshape(-1)], -1)
        da = torch.cat([da, da.new_zeros((gp.slot_stride - da.shape[0], 2))])
        da = gather_rows(da, group)[gp.slot_map]
        da = torch.where((bt["blk_weight"] != 0)[..., None], da, 0.0)
        q_full = gather_rows(q.contiguous(), group)
        g_full = gather_rows(g, group)
        dk = _k1(q_full, bt, gp, da[..., 0] * inv_sqrt_d)
        dv = _k1(g_full, bt, gp, da[..., 1])
        return dq, dk, dv, None


def partitioned_transformer_conv(gp: GraphParallel, lp, x: torch.Tensor) -> torch.Tensor:
    """One TransformerConv layer (``lp``: the ``lin_query``, ``lin_key``,
    ``lin_value``, ``lin_skip`` linears) over a partition: ``x`` is this
    rank's (rows_per_shard, D) slot rows, and so is the result.
    Collective: every rank of the node group calls it.  A tiled partition
    takes ``parallel/tile_transformer.partitioned_tile_transformer_conv``
    (K3-K5 on the shard's tiles, K1 on its residual), as the JAX package
    routes it.  Over a blocked one the exchange is the all_gather whatever
    ``gp.comm`` says (as the JAX package), over the forward and backward
    blocks ``GraphParallel.place`` puts on every operand.  The linears stay
    under autograd on this rank's rows, so each rank's parameter gradients
    are its partial sums, which ``parallel.sharded.reduce_gradients`` sums
    over the world."""
    if gp.tiles is not None:
        from plnlp_tpu_torch.parallel.tile_transformer import partitioned_tile_transformer_conv

        return partitioned_tile_transformer_conv(gp, lp, x)
    if x.shape[0] != gp.rows_per_shard:
        raise ValueError(
            f"x has {x.shape[0]} rows; a rank holds rows_per_shard={gp.rows_per_shard} "
            "(shard_node_features)"
        )
    q, k, v = (apply_linear(lp[name], x) for name in ("lin_query", "lin_key", "lin_value"))
    return PartitionedAttn.apply(q, k, v, gp) + apply_linear(lp["lin_skip"], x)
