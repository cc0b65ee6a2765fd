"""Hybrid dense-tile + blocked-CSR SpMM (port of plnlp_tpu/ops/tile_spmm.py).

After a locality reorder (label propagation), a community-structured graph
concentrates its edges in dense T x T tiles.  A tile with k edges is
computed as one dense product

    out[rt*T:(rt+1)*T] += A_tile @ x[ct*T:(ct+1)*T]

which reads the x tile as one contiguous block; tiles with fewer than
``min_fill`` edges stay on the blocked gather path (the residual).

* Host build, in NumPy (copied from the JAX package): ``label_prop_order``,
  ``multilevel_order``, ``estimate_hybrid`` and ``build_hybrid``, with the
  int8 tile store when exact (else the compute dtype), the
  ``max_tile_bytes`` guard and the zero-tile case.  The label-prop sweep
  runs in the native library (``native.label_prop``) when it is
  available, else in NumPy; both give the same labels.
* The operator, :class:`HybridSpmm`: the forward is the tile kernel K2
  (``ops/tile_matmul.py``) over ``tile_vals`` plus the blocked kernel K1
  over ``res_graph``; the backward (dX = Aᵀ dY) is K2 over the transposed
  tile set ``tile_vals_t`` plus K1 over ``res_graph_t``.  ``perm_in`` /
  ``perm_out`` are applied as gathers at the Function's boundary.

Layout differences from the JAX package: ``tile_rowptr`` /
``tile_rowptr_t`` (the first tile of each row tile) let a CUDA block find
its tiles; K2 zero-fills uncovered row tiles, so the operand carries no
``row_mask`` (a row tile is covered iff its ``tile_rowptr`` range is not
empty).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from plnlp_tpu_torch.graph import (
    Graph,
    _blocks_np,
    _csr_np,
    _pad_to,
    _to_graph,
    _undirected_csr_np,
)
from plnlp_tpu_torch.nn import COMPUTE_DTYPES
from plnlp_tpu_torch.ops.scatter_matmul import scatter_matmul
from plnlp_tpu_torch.ops.tile_matmul import tile_matmul

__all__ = [
    "HybridGraph",
    "HybridSpmm",
    "build_hybrid",
    "estimate_hybrid",
    "hybrid_spmm",
    "is_padded_operand",
    "tile_stats",
    "label_prop_order",
    "multilevel_order",
]


# ---------------------------------------------------------------------------
# Locality reorder (host, NumPy)
# ---------------------------------------------------------------------------


def _weighted_label_prop(ws, wd, ww, num_nodes, rounds):
    """Synchronous weighted label propagation: each round every node adopts
    the neighbor label with the largest incident edge-weight sum (ties to
    the smallest label); stops early at a fixed point."""
    labels = np.arange(num_nodes, dtype=np.int64)
    for _ in range(rounds):
        lab_s = labels[ws]
        order = np.lexsort((lab_s, wd))
        dd, ll, www = wd[order], lab_s[order], ww[order]
        change = (dd[1:] != dd[:-1]) | (ll[1:] != ll[:-1])
        starts = np.concatenate([[0], np.nonzero(change)[0] + 1])
        run_dst, run_lab = dd[starts], ll[starts]
        run_w = np.add.reduceat(www, starts)
        # per-dst argmax run: sort by (dst, weight, -label), take each
        # dst's last run (largest weight; smallest label wins ties)
        o2 = np.lexsort((-run_lab, run_w, run_dst))
        rd, rl = run_dst[o2], run_lab[o2]
        last = np.nonzero(np.concatenate([rd[1:] != rd[:-1], [True]]))[0]
        new = labels.copy()
        new[rd[last]] = rl[last]
        if np.array_equal(new, labels):
            break
        labels = new
    return labels


def _label_prop_labels(src, dst, num_nodes: int, rounds: int) -> np.ndarray:
    """Final label-prop labels: the native sweep when the library is
    available (``native.label_prop``, the same labels), NumPy otherwise."""
    from plnlp_tpu_torch import native

    if native.available():
        indptr, indices = _undirected_csr_np(
            np.asarray(src, np.int64), np.asarray(dst, np.int64), num_nodes
        )
        return native.label_prop(indptr, indices, num_nodes, rounds)
    return _label_prop_plain(src, dst, num_nodes, rounds)


def _label_prop_plain(src, dst, num_nodes: int, rounds: int) -> np.ndarray:
    """NumPy version of :func:`_label_prop_labels`."""
    s2 = np.concatenate([src, dst]).astype(np.int64)
    d2 = np.concatenate([dst, src]).astype(np.int64)
    return _weighted_label_prop(s2, d2, np.ones(len(s2), np.int64), num_nodes, rounds)


def label_prop_order(src, dst, num_nodes: int, rounds: int = 20) -> np.ndarray:
    """Community order: nodes sorted by their final label-prop label, so
    same-community nodes get contiguous ids.  ``rounds`` is a cap; the
    sweep stops at its fixed point."""
    return np.argsort(_label_prop_labels(src, dst, num_nodes, rounds), kind="stable")


def multilevel_order(
    src, dst, num_nodes: int, rounds: int = 20, coarse_rounds: int = 10
) -> np.ndarray:
    """Label-prop, then label-prop the graph of communities (edge weights =
    inter-community edge counts); nodes ordered by (coarse, fine) label."""
    lab0 = _label_prop_labels(src, dst, num_nodes, rounds)
    u0, inv0 = np.unique(lab0, return_inverse=True)
    c0 = len(u0)
    cs, cd = inv0[np.asarray(src, np.int64)], inv0[np.asarray(dst, np.int64)]
    keep = cs != cd
    if not keep.any() or c0 <= 1:
        return np.argsort(lab0, kind="stable")
    uk, cnt = np.unique(cs[keep] * c0 + cd[keep], return_counts=True)
    ws, wd = (uk // c0).astype(np.int64), (uk % c0).astype(np.int64)
    lab1 = _weighted_label_prop(
        np.concatenate([ws, wd]), np.concatenate([wd, ws]),
        np.concatenate([cnt, cnt]).astype(np.int64), c0, coarse_rounds,
    )
    return np.lexsort((lab0, lab1[inv0]))


def _community_order(reorder: str, es, ed, num_nodes: int) -> np.ndarray:
    if reorder == "multilevel":
        return multilevel_order(es, ed, num_nodes)
    return label_prop_order(es, ed, num_nodes)


# ---------------------------------------------------------------------------
# The operand and its host build
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HybridGraph:
    """Dense tiles (both directions) + blocked residual graphs.

    ``tile_vals`` (nt, T, T) holds A[rt*T+i, ct*T+j] per tile (row =
    destination), sorted by ``tile_row``; ``tile_rowptr`` (nR + 1,) gives
    each row tile's first tile.  ``*_t`` fields are the transposed set (the
    backward).  ``perm_in`` / ``perm_out`` (optional, (num_nodes,) int32):
    an internal relabel, perm_in[slot] = original id, perm_out[original id]
    = slot.  ``in_degrees`` (num_nodes,) f32: unweighted in-degrees in the
    original id space."""

    tile_vals: torch.Tensor
    tile_row: torch.Tensor  # (nt,) int32, sorted
    tile_col: torch.Tensor  # (nt,) int32
    tile_rowptr: torch.Tensor  # (nR + 1,) int32
    tile_vals_t: torch.Tensor
    tile_row_t: torch.Tensor
    tile_col_t: torch.Tensor
    tile_rowptr_t: torch.Tensor
    res_graph: Optional[Graph]
    res_graph_t: Optional[Graph]
    num_nodes: int
    tile: int
    num_tiles: int
    dense_edges: int
    res_edges: int
    in_degrees: torch.Tensor
    perm_in: Optional[torch.Tensor] = None
    perm_out: Optional[torch.Tensor] = None
    reorder: str = "none"

    def to(self, device) -> "HybridGraph":
        """The same operand with every tensor (and residual graph) moved to
        ``device``."""
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, Graph)):
                moved[f.name] = v.to(device)
        return dataclasses.replace(self, **moved)


def tile_stats(src, dst, num_nodes: int, tile: int = 512):
    """Edges per occupied (row tile, col tile): fill diagnostics."""
    n_c = _pad_to(num_nodes, tile) // tile
    key = (np.asarray(dst, np.int64) // tile) * n_c + np.asarray(src, np.int64) // tile
    return np.unique(key, return_counts=True)[1]


def _build_tiles(src, dst, w, num_nodes, tile, min_fill, max_tiles=None):
    """Split edges into the dense-tile set and the residual; (vals, row,
    col) sorted by (row tile, col tile).  ``max_tiles`` keeps only the
    densest tiles when more qualify."""
    t = tile
    n_c = _pad_to(num_nodes, t) // t
    key = (dst // t) * n_c + src // t
    uniq, counts = np.unique(key, return_counts=True)
    qual = counts >= min_fill
    if max_tiles is not None and int(qual.sum()) > max_tiles:
        top = np.argsort(-counts, kind="stable")[:max_tiles]
        qual = np.zeros(len(uniq), bool)
        qual[top] = True
    tile_keys = uniq[qual]  # sorted
    dense_mask = np.isin(key, tile_keys)
    d_src, d_dst, d_w = src[dense_mask], dst[dense_mask], w[dense_mask]
    residual = (src[~dense_mask], dst[~dense_mask], w[~dense_mask])
    nt = len(tile_keys)
    vals = np.zeros((max(nt, 1), t, t), np.float32)
    if nt:
        slot = np.searchsorted(tile_keys, key[dense_mask])
        np.add.at(vals, (slot, d_dst % t, d_src % t), d_w)
    return (
        vals, (tile_keys // n_c).astype(np.int32), (tile_keys % n_c).astype(np.int32),
        residual, int(len(d_src)),
    )


def estimate_hybrid(
    src,
    dst,
    *,
    num_nodes: int,
    tile: int = 512,
    min_fill: int = 192,
    symmetrize: bool = False,
    coalesce: bool = True,
    max_tile_bytes: int = 2 * 1024**3,
    reorder: Optional[str] = "labelprop",
) -> dict:
    """What the hybrid backend would get, without building tiles: the
    locality reorder and the tile-key histogram.  Returns ``{"coverage",
    "num_tiles", "num_edges", "order"}``; ``order`` (None without a reorder)
    can be handed to ``build_hybrid(order=...)`` so the sweep runs once."""
    csr = _csr_np(src, dst, None, num_nodes, symmetrize, coalesce)
    es = csr["senders"].astype(np.int64)
    ed = csr["receivers"].astype(np.int64)
    e = csr["num_edges"]
    order = None
    if reorder in ("labelprop", "cluster", "multilevel"):
        order = _community_order(reorder, es, ed, num_nodes)
        node_map = np.empty(num_nodes, np.int64)
        node_map[order] = np.arange(num_nodes)
        es, ed = node_map[es], node_map[ed]
    elif reorder not in (None, "none"):
        raise ValueError(f"unknown reorder mode: {reorder!r}")
    n_c = _pad_to(num_nodes, tile) // tile
    _, counts = np.unique((ed // tile) * n_c + es // tile, return_counts=True)
    qual = counts[counts >= min_fill]
    max_tiles = max(int(max_tile_bytes // (tile * tile * 4)), 1)
    if len(qual) > max_tiles:
        qual = np.sort(qual)[-max_tiles:]
    return {
        "coverage": int(qual.sum()) / max(e, 1),
        "num_tiles": int(len(qual)),
        "num_edges": int(e),
        "order": order,
    }


def _rowptr(rows: np.ndarray, n_rowtiles: int) -> np.ndarray:
    counts = np.bincount(rows, minlength=n_rowtiles)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def build_hybrid(
    src,
    dst,
    weight=None,
    *,
    num_nodes: int,
    tile: int = 512,
    min_fill: int = 192,
    block: Tuple[int, int] = (512, 512),
    symmetrize: bool = False,
    coalesce: bool = True,
    max_tile_bytes: int = 2 * 1024**3,
    dtype="float32",
    reorder: Optional[str] = None,
    order: Optional[np.ndarray] = None,
    device=None,
) -> HybridGraph:
    """Build the hybrid operand on the host and push it to ``device`` once.

    Tiles with at least ``min_fill`` edges run dense; ``max_tile_bytes``
    bounds the f32 tile store per direction by keeping the densest tiles.
    ``reorder`` ("labelprop", "multilevel") relabels internally and sets
    ``perm_in``/``perm_out``; ``order`` is a precomputed reorder
    (order[slot] = old id), e.g. from :func:`estimate_hybrid`.  Tiles are
    stored int8 when that is exact, else in ``dtype``, the compute dtype
    ("float32" or "bfloat16", rounded to nearest even), as the JAX package
    stores them; the kernel casts them to x's dtype in registers."""
    from plnlp_tpu_torch import default_device

    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"dtype must be one of {sorted(COMPUTE_DTYPES)}, got {dtype!r}")
    device = default_device(device)
    csr = _csr_np(src, dst, weight, num_nodes, symmetrize, coalesce)
    es = csr["senders"].astype(np.int64)
    ed = csr["receivers"].astype(np.int64)
    ew = csr["edge_weight"].astype(np.float32)
    in_deg = np.bincount(ed, minlength=num_nodes).astype(np.float32)

    perm_in = perm_out = None
    resolved = "none"
    if reorder in ("labelprop", "cluster", "multilevel"):
        if order is None:
            order = _community_order(reorder, es, ed, num_nodes)
        order = np.asarray(order, np.int64)
        resolved = "multilevel" if reorder == "multilevel" else "labelprop"
        node_map = np.empty(num_nodes, np.int64)
        node_map[order] = np.arange(num_nodes)
        es, ed = node_map[es], node_map[ed]
        perm_in, perm_out = order.astype(np.int32), node_map.astype(np.int32)
    elif reorder not in (None, "none"):
        raise ValueError(f"unknown reorder mode: {reorder!r}")

    max_tiles = max(int(max_tile_bytes // (tile * tile * 4)), 1)
    vals, trow, tcol, (r_src, r_dst, r_w), n_dense = _build_tiles(
        es, ed, ew, num_nodes, tile, min_fill, max_tiles=max_tiles
    )
    if len(trow) == 0:
        # no tile qualifies: the one all-zero tile gets coordinates (0, 0)
        trow = tcol = np.zeros(1, np.int32)
    # transposed set: swap coordinates, transpose each tile, re-sort by row
    order_t = np.lexsort((trow, tcol))
    vals_t = np.ascontiguousarray(vals.transpose(0, 2, 1)[order_t])
    trow_t, tcol_t = tcol[order_t], trow[order_t]

    n_r = _pad_to(num_nodes, tile) // tile
    exact = np.all(vals == np.round(vals)) and np.abs(vals).max() <= 127
    store = torch.int8 if exact else COMPUTE_DTYPES[dtype]

    res_g = res_gt = None
    if len(r_src):
        # The residual is sparse by construction (inter-community edges),
        # so its sub-blocks are at most 128 edges wide.
        res_block = (block[0], min(block[1], 128))
        res_csr = _csr_np(r_src, r_dst, r_w, num_nodes, False, False)
        res_csr_t = _csr_np(r_dst, r_src, r_w, num_nodes, False, False)
        res_g = _to_graph(res_csr, _blocks_np(res_csr, *res_block), device)
        res_gt = _to_graph(res_csr_t, _blocks_np(res_csr_t, *res_block), device)

    def _t(a, dt=None):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t if dt is None else t.to(dt)).to(device)

    return HybridGraph(
        tile_vals=_t(vals, store),
        tile_row=_t(trow.astype(np.int32)),
        tile_col=_t(tcol.astype(np.int32)),
        tile_rowptr=_t(_rowptr(trow, n_r)),
        tile_vals_t=_t(vals_t, store),
        tile_row_t=_t(trow_t.astype(np.int32)),
        tile_col_t=_t(tcol_t.astype(np.int32)),
        tile_rowptr_t=_t(_rowptr(trow_t, n_r)),
        res_graph=res_g,
        res_graph_t=res_gt,
        num_nodes=num_nodes,
        tile=tile,
        num_tiles=int(len(trow)),
        dense_edges=n_dense,
        res_edges=int(len(r_src)),
        in_degrees=_t(in_deg),
        perm_in=_t(perm_in),
        perm_out=_t(perm_out),
        reorder=resolved,
    )


# ---------------------------------------------------------------------------
# The operator
# ---------------------------------------------------------------------------


def is_padded_operand(hg: HybridGraph, x: torch.Tensor) -> bool:
    """True iff ``x`` rides the padded-carry protocol: a perm-free operand
    and exactly num_nodes rounded up to the tile size rows (strictly more
    than num_nodes).  The one predicate the encoder stack and the operator
    share."""
    return (
        hg.perm_in is None
        and x.shape[0] != hg.num_nodes
        and x.shape[0] == _pad_to(hg.num_nodes, hg.tile)
    )


def _hybrid_dir(hg: HybridGraph, x: torch.Tensor, direction: str) -> torch.Tensor:
    """One aggregation direction; output rows follow x's rows (num_nodes,
    or n_pad under padded-carry, pad rows zero: pad sources have no
    edges)."""
    if direction == "fwd":
        vals, trow, tcol, ptr, res = (
            hg.tile_vals, hg.tile_row, hg.tile_col, hg.tile_rowptr, hg.res_graph,
        )
    else:
        vals, trow, tcol, ptr, res = (
            hg.tile_vals_t, hg.tile_row_t, hg.tile_col_t, hg.tile_rowptr_t, hg.res_graph_t,
        )
    x = x.contiguous()
    out = tile_matmul(vals, trow, tcol, ptr, x, x.shape[0])
    if res is not None:
        n = hg.num_nodes
        out[:n] += scatter_matmul(
            x, res.blk_src, res.blk_local, res.blk_weight, res.blk_rowptr,
            res.block_rows, n,
        )
    return out


class HybridSpmm(torch.autograd.Function):
    """Sum aggregation over a :class:`HybridGraph`: tiles + residual
    forward, the transposed tiles + transposed residual backward.  With a
    relabel P (x_slots = P x) the forward is y = Pᵀ A_s P x, so dX =
    Pᵀ A_sᵀ P dY: the same pair of gathers in both directions."""

    @staticmethod
    def forward(ctx, x, hg: HybridGraph):
        ctx.hg = hg
        if hg.perm_in is not None:
            x = x.index_select(0, hg.perm_in)
        y = _hybrid_dir(hg, x, "fwd")
        return y if hg.perm_out is None else y.index_select(0, hg.perm_out)

    @staticmethod
    def backward(ctx, g):
        hg = ctx.hg
        if hg.perm_in is not None:
            g = g.index_select(0, hg.perm_in)
        dx = _hybrid_dir(hg, g, "bwd")
        if hg.perm_out is not None:
            dx = dx.index_select(0, hg.perm_out)
        return dx, None


def hybrid_spmm(hg: HybridGraph, x: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """Sum or mean aggregation over the hybrid operand.  ``x`` is
    (num_nodes, D), or, for a perm-free operand, (n_pad, D) with n_pad =
    num_nodes rounded up to the tile size: then the output keeps n_pad rows
    (pad rows zero), so an encoder stack pads once and slices once."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce: {reduce}")
    if not is_padded_operand(hg, x):
        x = x[: hg.num_nodes]
    out = HybridSpmm.apply(x, hg)
    if reduce == "mean":
        deg = hg.in_degrees
        scale = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)
        if out.shape[0] != scale.shape[0]:
            scale = torch.cat([scale, scale.new_zeros(out.shape[0] - scale.shape[0])])
        out = out * scale[:, None].to(out.dtype)
    return out
