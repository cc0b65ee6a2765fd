"""TransformerConv over a tiled partition (port of
plnlp_tpu/parallel/tile_transformer.py): ``--adj_backend hybrid
--num_shards W --encoder TRANSFORMER``.

Destination rows are sharded, so every row's softmax over all of its
in-edges, tile and residual, closes on the rank that owns the row once k
and v are all-gathered over the mesh's node group.  On each rank, for its
``rows_per_shard`` rows:

Forward (``tile_attn_forward``; the single-operand flash path is
``ops/tile_attention.FlashAttn``):

1. k and v of every shard are gathered; q stays on the own rows.
2. K3 over the shard's row-sorted tiles: q of the own rows, k and v of the
   gathered buffer (the kernels' two row counts), giving the tile-local
   partials (num, den, m).  A row with no tile edge, in a row tile no tile
   covers or on a shard with no tile at all, comes out (0, 0, -inf).
3. The residual's per-edge logits over the forward blocks (destination
   rows local, sources global), the flash merge ``M = max(m_t, m_res)``
   (0 where no edge), ``r = exp(m_t - M)``, and the residual's
   ``Σ exp(s - M) v`` through K1 with those per-slot weights;
   ``den = max(den, tiny)``.

Backward (hand-written; ``tile_attn_backward``): with δ = Σ_d gy·y a row,
the stats (M, den, δ), 3 floats a row, are all-gathered with q and g, so α
is recomputed from them at every edge and no per-edge scalar crosses
shards (no slot map):

* dq: K4 over the row-sorted tiles (q, g and stats own; k, v gathered),
  plus the residual over the forward blocks through K1;
* dk, dv: K5 over the transposed tiles (k, v own; q, g and stats
  gathered), plus the residual over the backward (source-sharded) blocks
  through K1 twice.

A layer launches K3 once and K1 once forward; K4, K5 once and K1 three
times backward.  The linears stay under autograd on the rank's own rows
(as ``graph_parallel.PartitionedAttn``), so input gradients land on their
owners and each rank's parameter gradients are its partial sums, which
``parallel.sharded.reduce_gradients`` sums over the world.

In bfloat16 the kernels take their bf16 entry points and K1 runs in x's
dtype; the merge, the stats and y stay float32, and y is cast to x's dtype
before the skip term.  The JAX package's CPU-mesh einsum fallbacks, its
128-lane padding of d, its packed stats layouts and its row masks are TPU
artefacts and not ported: on the CPU the kernels' plain versions run, and
the port's K3-K5 define every row.
"""

from __future__ import annotations

import math

import torch

from plnlp_tpu_torch.nn import apply_linear
from plnlp_tpu_torch.ops.flash_tiles import flash_tiles_dkv, flash_tiles_dq, flash_tiles_fwd
from plnlp_tpu_torch.parallel.graph_parallel import GraphParallel, _k1, _rowdot, _slot_rows
from plnlp_tpu_torch.parallel.mesh import gather_rows

__all__ = ["PartitionedTileAttn", "partitioned_tile_transformer_conv"]

_TINY = torch.finfo(torch.float32).tiny


def _own_rows(gp: GraphParallel, a_full: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a gathered (S * rows_per_shard, D) buffer."""
    rps = gp.rows_per_shard
    return a_full[gp.mesh.node_index * rps:(gp.mesh.node_index + 1) * rps]


def _tile_args(t: dict):
    return t["vals"], t["row"], t["col"], t["rowptr"]


def _residual_alpha(valid, logits, st):
    """α of the residual slots from their rows' stats; the mask is a select
    (a padding slot's logit has nothing to do with its row's stats)."""
    return torch.where(valid, torch.exp(logits - st[..., 0]), 0.0) / st[..., 1]


def tile_attn_forward(gp: GraphParallel, q, k_full, v_full, scale: float):
    """The shard's attention aggregation (y, M, den), float32, from q of its
    own rows and k, v of the gathered buffer."""
    num, ml = flash_tiles_fwd(*_tile_args(gp.tiles), q, k_full, v_full, scale)
    m_t, den_t = ml[:, 0], ml[:, 1]
    b = gp.fwd
    dst, src = _slot_rows(b, gp.pg.block_rows), b["blk_src"]
    valid = b["blk_weight"] != 0
    logits = _rowdot(q, dst, k_full, src) * scale
    flat_dst = dst.reshape(-1)
    m = torch.maximum(m_t, m_t.new_full(m_t.shape, float("-inf")).scatter_reduce_(
        0, flat_dst, torch.where(valid, logits, float("-inf")).reshape(-1), "amax"))
    m = torch.where(torch.isfinite(m), m, 0.0)  # isolated rows: exp(x - 0) unused
    r = torch.exp(m_t - m)  # m_t = -inf (no tile edge in the row) -> 0
    ex = torch.where(valid, torch.exp(logits - m[dst]), 0.0)
    den = (den_t * r).index_add_(0, flat_dst, ex.reshape(-1)).clamp(min=_TINY)
    num = num * r[:, None] + _k1(v_full, b, gp, ex)
    return num / den[:, None], m, den


def tile_attn_stats(gy, y, m, den, dtype):
    """The backward's row stats (rows, 3) = (M, den, δ = Σ_d gy·y), float32,
    and gy in the features' dtype for the kernels and the residual."""
    gy = gy.float()
    return (torch.stack([m, den, (gy * y).sum(-1)], 1),
            gy.to(dtype).contiguous())


def tile_attn_backward(gp: GraphParallel, q, k_full, v_full, g, stats, q_full, g_full,
                       stats_full, scale: float):
    """(dq, dk, dv) of the shard's own rows, float32, from its own q, g and
    stats and the gathered k, v, q, g and stats."""
    k, v = _own_rows(gp, k_full), _own_rows(gp, v_full)
    dq = flash_tiles_dq(*_tile_args(gp.tiles), q, k_full, v_full, g, stats, scale)
    dk, dv = flash_tiles_dkv(*_tile_args(gp.tiles_t), q_full, k, v, g_full, stats_full, scale)
    R = gp.pg.block_rows
    # residual dq over the forward blocks: destination rows local
    b = gp.fwd
    dst, src = _slot_rows(b, R), b["blk_src"]
    st = stats[dst]
    al = _residual_alpha(b["blk_weight"] != 0, _rowdot(q, dst, k_full, src) * scale, st)
    ds = al * (_rowdot(g, dst, v_full, src) - st[..., 2]) * scale
    dq = dq + _k1(k_full, b, gp, ds)
    # residual dk, dv over the backward blocks: source rows local, each
    # slot's blk_src its destination's global slot
    bt = gp.bwd
    src_l, dst_g = _slot_rows(bt, R), bt["blk_src"]
    st = stats_full[dst_g]
    al = _residual_alpha(bt["blk_weight"] != 0, _rowdot(q_full, dst_g, k, src_l) * scale, st)
    ds = al * (_rowdot(g_full, dst_g, v, src_l) - st[..., 2]) * scale
    return dq, dk + _k1(q_full, bt, gp, ds), dv + _k1(g_full, bt, gp, al)


class PartitionedTileAttn(torch.autograd.Function):
    """y (rows_per_shard, d) float32 = Σ_j α_ij v_j over this shard's
    destination rows, from this rank's q, k, v rows (k and v all-gathered
    inside).  Saved for the backward: q, the gathered k and v, M, den and
    y; the backward all-gathers q, g and the stats."""

    @staticmethod
    def forward(ctx, q, k, v, gp: GraphParallel, scale: float):
        group = gp.mesh.node_group
        q = q.contiguous()
        k_full = gather_rows(k.contiguous(), group)
        v_full = gather_rows(v.contiguous(), group)
        y, m, den = tile_attn_forward(gp, q, k_full, v_full, scale)
        ctx.gp, ctx.scale = gp, scale
        ctx.save_for_backward(q, k_full, v_full, m, den, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        q, k_full, v_full, m, den, y = ctx.saved_tensors
        gp = ctx.gp
        group = gp.mesh.node_group
        stats, g = tile_attn_stats(gy, y, m, den, q.dtype)
        q_full, g_full = gather_rows(q, group), gather_rows(g, group)
        stats_full = gather_rows(stats, group)
        dq, dk, dv = tile_attn_backward(gp, q, k_full, v_full, g, stats, q_full, g_full,
                                        stats_full, ctx.scale)
        return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), None, None


def partitioned_tile_transformer_conv(gp: GraphParallel, lp, x: torch.Tensor) -> torch.Tensor:
    """One TransformerConv layer (``lp``: the ``lin_query``, ``lin_key``,
    ``lin_value``, ``lin_skip`` linears) over a tiled partition: ``x`` is
    this rank's (rows_per_shard, D) slot rows, and so is the result.
    Collective: every rank of the node group calls it."""
    if gp.tiles is None:
        raise ValueError("partitioned_tile_transformer_conv needs a tiled partition "
                         "(partition_graph(tile > 0)); use partitioned_transformer_conv "
                         "for a blocked one")
    if x.shape[0] != gp.rows_per_shard:
        raise ValueError(
            f"x has {x.shape[0]} rows; a rank holds rows_per_shard={gp.rows_per_shard} "
            "(shard_node_features)"
        )
    q, k, v = (apply_linear(lp[name], x) for name in ("lin_query", "lin_key", "lin_value"))
    y = PartitionedTileAttn.apply(q, k, v, gp, 1.0 / math.sqrt(lp["lin_query"].out_features))
    return y.to(x.dtype) + apply_linear(lp["lin_skip"], x)
