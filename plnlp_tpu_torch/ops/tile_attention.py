"""TransformerConv over the hybrid tile operand (port of the flash path of
plnlp_tpu/ops/tile_attention.py).

Attention over a destination row is a softmax over the union of its tile
edges and its residual (per-edge) edges, so the two partial sets merge
flash-style: each set gives (m, den, num) against its own row max, and

    M   = max(m_tiles, m_res)          (0 where no edge: isolated rows)
    den = den_tiles·exp(m_tiles − M) + Σ_res exp(s − M)
    num = num_tiles·exp(m_tiles − M) + Σ_res exp(s − M)·v[src]
    y   = num / max(den, tiny)

The tile partials come from K3 (``ops/flash_tiles.flash_tiles_fwd``).  The
backward is written by hand (:class:`FlashAttn`): with δ = Σ_d gy·y per
row, K4 gives the tiles' dq and K5 the tiles' dk/dv from the global M and
den; the residual edges take the same terms through gathers and
``index_add_``.  The linears and the relabel gathers stay outside the
Function, so autograd carries them.

Adjacency values are ignored, as in the reference TransformerConv: the
tiles and residual weights act as the edge mask only.  The JAX package's
scan fallback (for hardware without its kernel) is not ported: on the CPU
the kernels' plain versions play that part.
"""

from __future__ import annotations

import math

import torch

from plnlp_tpu_torch.ops.flash_tiles import flash_tiles_dkv, flash_tiles_dq, flash_tiles_fwd
from plnlp_tpu_torch.ops.tile_spmm import HybridGraph, is_padded_operand

__all__ = ["FlashAttn", "hybrid_transformer_conv"]

_TINY = torch.finfo(torch.float32).tiny


def _res_partials(hg: HybridGraph, q, k, v, scale: float):
    """Residual per-edge softmax terms: validity mask, logits, the gathered
    sender values and the per-row max (rows follow q: num_nodes, or n_pad
    under padded-carry; edge ids are < num_nodes either way).  k and v ride
    one two-wide gather at the shared sender ids."""
    rows, d = q.shape
    m_res = q.new_full((rows,), float("-inf"))
    g = hg.res_graph
    if g is None:
        return None, None, None, m_res
    valid = g.edge_weight != 0
    kv = torch.cat([k, v], 1)[g.senders]
    k_s, v_s = kv[:, :d], kv[:, d:]
    logits = (q[g.receivers] * k_s).sum(-1) * scale
    m_res.scatter_reduce_(0, g.receivers.long(), torch.where(valid, logits, float("-inf")), "amax")
    return valid, logits, v_s, m_res


class FlashAttn(torch.autograd.Function):
    """Softmax-normalised attention aggregation y (rows, D) over the tile
    edges (K3 forward; K4, K5 backward) and the residual edges (gathers and
    ``index_add_``), with q/k/v in the operand's slot order."""

    @staticmethod
    def forward(ctx, q, k, v, hg: HybridGraph, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        num, ml = flash_tiles_fwd(hg.tile_vals, hg.tile_row, hg.tile_col, hg.tile_rowptr,
                                  q, k, v, scale)
        m_t, den_t = ml[:, 0], ml[:, 1]
        valid, logits, v_s, m_res = _res_partials(hg, q, k, v, scale)
        m = torch.maximum(m_t, m_res)
        m = torch.where(torch.isfinite(m), m, 0.0)  # isolated rows: exp(x - 0) unused
        r = torch.exp(m_t - m)  # m_t = -inf (no tile edge in the row) -> 0
        den = den_t * r
        num = num * r[:, None]
        g = hg.res_graph
        if g is not None:
            ex = torch.where(valid, torch.exp(logits - m[g.receivers]), 0.0)
            den.index_add_(0, g.receivers, ex)
            num.index_add_(0, g.receivers, v_s * ex[:, None])
        den = den.clamp(min=_TINY)
        y = num / den[:, None]
        ctx.hg, ctx.scale = hg, scale
        ctx.save_for_backward(q, k, v, m, den, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        q, k, v, m, den, y = ctx.saved_tensors
        hg, scale = ctx.hg, ctx.scale
        gy = gy.contiguous()
        delta = (gy * y).sum(-1)  # the flash trick: Σ_d gy·y per row
        stats = torch.stack([m, den, delta], 1)  # (rows, 3): M, den, δ
        dq = flash_tiles_dq(hg.tile_vals, hg.tile_row, hg.tile_col, hg.tile_rowptr,
                            q, k, v, gy, stats, scale)
        dk, dv = flash_tiles_dkv(hg.tile_vals_t, hg.tile_row_t, hg.tile_col_t,
                                 hg.tile_rowptr_t, q, k, v, gy, stats, scale)
        g, gt = hg.res_graph, hg.res_graph_t
        if g is not None:
            d = q.shape[1]
            kv = torch.cat([k, v], 1)
            qg = torch.cat([q, gy], 1)
            # dq: the residual edges in destination order (res_graph)
            kv_s = kv[g.senders]
            qg_r = qg[g.receivers]
            st = stats[g.receivers]
            logits = (qg_r[:, :d] * kv_s[:, :d]).sum(-1) * scale
            al = torch.where(g.edge_weight != 0, torch.exp(logits - st[:, 0]) / st[:, 1], 0.0)
            ds = al * ((qg_r[:, d:] * kv_s[:, d:]).sum(-1) - st[:, 2]) * scale
            dq.index_add_(0, g.receivers, ds[:, None] * kv_s[:, :d])
            # dk, dv: the same edges in source order (res_graph_t: senders =
            # destination, receivers = source)
            qg_t = qg[gt.senders]
            kv_t = kv[gt.receivers]
            st = stats[gt.senders]
            logits = (qg_t[:, :d] * kv_t[:, :d]).sum(-1) * scale
            al = torch.where(gt.edge_weight != 0, torch.exp(logits - st[:, 0]) / st[:, 1], 0.0)
            ds = al * ((qg_t[:, d:] * kv_t[:, d:]).sum(-1) - st[:, 2]) * scale
            dk.index_add_(0, gt.receivers, ds[:, None] * qg_t[:, :d])
            dv.index_add_(0, gt.receivers, al[:, None] * qg_t[:, d:])
        return dq, dk, dv, None, None


def hybrid_transformer_conv(lp, hg: HybridGraph, x: torch.Tensor) -> torch.Tensor:
    """One TransformerConv layer (``lp``: the ``lin_query``, ``lin_key``,
    ``lin_value``, ``lin_skip`` linears) over a HybridGraph.  ``x`` is
    (num_nodes, D_in) in original node ids, or (n_pad, D_in) under
    padded-carry (a perm-free operand), whose output keeps the n_pad rows:
    pad rows carry garbage that every tile and residual access masks away,
    and their cotangents are zero."""
    if not is_padded_operand(hg, x):
        x = x[: hg.num_nodes]
    xs = x if hg.perm_in is None else x.index_select(0, hg.perm_in)
    lin_q = lp["lin_query"]
    q, k, v = lin_q(xs), lp["lin_key"](xs), lp["lin_value"](xs)
    y = FlashAttn.apply(q, k, v, hg, 1.0 / math.sqrt(lin_q.out_features))
    out = y + lp["lin_skip"](xs)
    return out if hg.perm_out is None else out.index_select(0, hg.perm_out)
