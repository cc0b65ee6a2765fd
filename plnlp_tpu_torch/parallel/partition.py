"""Graph partitioning for the multi-device SpMM (port of
plnlp_tpu/parallel/partition.py, host NumPy, ``tile=0``).

Destination rows are split into ``num_shards`` equal-capacity SLOT ranges
(padded to a multiple of block_rows), one per rank of the mesh's ``node``
axis.  Each shard owns:

* forward structure: its rows' in-edges, blocked for the scatter-matmul K1
  (``blk_src`` holds GLOBAL slot ids of the sources, destinations are
  shard-local rows);
* backward structure: the same edges grouped by SOURCE shard, blocked over
  shard-local source rows with global destination slot ids in ``blk_src``,
  so dX = Aᵀ dY has the forward's compute shape and one body serves both.

The blocks are in the port's layout (``graph._blocks_np``: no residue pad,
with ``blk_rowptr``), one unpadded structure per shard: a rank holds its
own shard only, so the JAX package's padding of every shard to the largest
sub-block count (a uniform leading axis for ``shard_map``) is not needed.

``reorder`` chooses the node -> slot assignment: ``'edges'`` (equal-edge
contiguous ranges over the id order), ``'degree'`` (serpentine deal by
in-degree), ``'bfs'`` (BFS order, then equal-edge ranges), ``'labelprop'``
/ ``'multilevel'`` (community order, then equal-edge ranges) and
``'auto'`` (``'degree'`` when the naive split's edge imbalance exceeds
1.25, else the identity).  A non-identity assignment is carried as two
padded-length permutations (``perm_in``: slot -> global position,
``perm_out``: global position -> slot).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from plnlp_tpu_torch.graph import _blocks_np, _csr_np, _pad_to, _undirected_csr_np

__all__ = ["PartitionedGraph", "partition_graph", "with_halo", "assign_slots"]

TILED_NOT_PORTED = (
    "the tiled partition (tile > 0: K2's dense tiles on each shard) is not ported yet "
    "(ROADMAP queue 1 item 11b, the next slice)"
)


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Per-shard blocked metadata (host NumPy) of a row-partitioned graph."""

    # one block dict (graph._blocks_np layout) per shard
    fwd: Tuple[dict, ...]  # blk_src GLOBAL source slots, rows shard-local
    bwd: Tuple[dict, ...]  # blk_src GLOBAL destination slots, source rows shard-local
    # per shard, for each bwd slot: the flat index (into the concatenation of
    # every shard's fwd slots, in shard order) of the same edge; 0 at padding
    bwd_gather_fwd: Tuple[np.ndarray, ...]
    local_in_degrees: np.ndarray  # (S, rows_per_shard) int32, unweighted
    num_nodes: int
    num_shards: int
    rows_per_shard: int
    block_rows: int
    block_edges: int
    # halo-exchange plans (parallel.halo.build_halo_plan), None until with_halo
    fwd_halo: Optional[dict] = None
    bwd_halo: Optional[dict] = None
    halo_quota: int = 0  # q: per-peer non-hub boundary rows
    halo_hubs: int = 0  # qh: per-owner replicated hub rows
    # node -> slot relayout, None = identity; (padded_nodes,) int32,
    # mutually inverse
    perm_in: Optional[np.ndarray] = None  # slot -> global position
    perm_out: Optional[np.ndarray] = None  # global position -> slot
    reorder: str = "none"
    shard_edges: Tuple[int, ...] = ()  # real edges per shard (forward)
    shard_nblk: Tuple[int, ...] = ()  # forward sub-blocks per shard

    @property
    def padded_nodes(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def node_map(self) -> Optional[np.ndarray]:
        """Original node id -> slot ((num_nodes,) int32), None = identity."""
        return None if self.perm_out is None else self.perm_out[: self.num_nodes]


def with_halo(pg: PartitionedGraph, hub_k: Optional[int] = None) -> PartitionedGraph:
    """Attach the halo-exchange plans of both directions (host-side).
    ``hub_k``: rows read remotely by at least hub_k shards are replicated
    through an all_gather (default max(3, S//2+1)); see parallel.halo."""
    from plnlp_tpu_torch.parallel.halo import build_halo_plan

    def build(blocks):
        return build_halo_plan(
            [b["blk_src"] for b in blocks],
            [b["blk_weight"] for b in blocks],
            [b["blk_local"] for b in blocks],
            [b["blk_rowblock"] for b in blocks],
            pg.rows_per_shard, pg.num_shards, pg.block_rows, pg.block_edges, hub_k=hub_k,
        )

    f_plan, qf, qhf = build(pg.fwd)
    b_plan, qb, qhb = build(pg.bwd)
    return dataclasses.replace(
        pg, fwd_halo=f_plan, bwd_halo=b_plan, halo_quota=max(qf, qb), halo_hubs=max(qhf, qhb)
    )


def _shard_csr(src, dst_local, w, rows: int) -> dict:
    """A shard's CSR over its local destination rows, built by hand (the
    sources are GLOBAL ids, past ``rows``)."""
    order = np.lexsort((src, dst_local))
    s, dl, ww = src[order], dst_local[order], w[order]
    indptr = np.zeros(rows + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(dl, minlength=rows))
    return {
        "senders": s.astype(np.int32),
        "receivers": dl.astype(np.int32),
        "edge_weight": ww.astype(np.float32),
        "indptr": indptr.astype(np.int32),
        "num_nodes": rows,
        "num_edges": int(len(s)),
    }


def _shard_blocks(src, dst, w, num_shards: int, rows_per_shard: int, R: int, B: int):
    """Group edges by destination shard; per-shard blocked metadata with
    shard-local rows and GLOBAL source ids, unpadded."""
    blocks = []
    for s in range(num_shards):
        lo_row = s * rows_per_shard
        sel = (dst >= lo_row) & (dst < lo_row + rows_per_shard)
        blocks.append(
            _blocks_np(_shard_csr(src[sel], dst[sel] - lo_row, w[sel], rows_per_shard), R, B)
        )
    return tuple(blocks), tuple(int(b["blk_src"].shape[0]) for b in blocks)


def _bwd_gather_fwd_np(fwd, bwd, rows_per_shard: int, R: int):
    """Flat fwd-slot index of each bwd slot's edge (host-side, vectorized).
    Both structures hold the real edge set once; matching the two key-sorted
    slot lists pairs every bwd slot with the fwd slot of the same (src, dst)
    edge, duplicates too (the k-th with the k-th)."""
    S = len(fwd)
    stride = np.int64(S) * rows_per_shard

    def slots(blocks, key_of):
        keys, valid = [], []
        for s, b in enumerate(blocks):
            row = (s * rows_per_shard + b["blk_rowblock"][:, None].astype(np.int64) * R
                   + b["blk_local"])
            keys.append(key_of(row, b["blk_src"].astype(np.int64)).reshape(-1))
            valid.append(b["blk_weight"].reshape(-1) != 0)
        return np.concatenate(keys), np.concatenate(valid)

    keys_f, valid_f = slots(fwd, lambda dst, src: dst * stride + src)
    keys_b, valid_b = slots(bwd, lambda src, dst: dst * stride + src)
    kf, kb = keys_f[valid_f], keys_b[valid_b]
    if kf.shape != kb.shape:
        raise ValueError("fwd/bwd edge counts diverged")
    ff = np.nonzero(valid_f)[0]
    out = np.zeros(keys_b.size, np.int64)
    out[np.nonzero(valid_b)[0][np.argsort(kb, kind="stable")]] = ff[np.argsort(kf, kind="stable")]
    sizes = np.cumsum([0] + [b["blk_src"].size for b in bwd])
    return tuple(
        out[sizes[s]:sizes[s + 1]].reshape(bwd[s]["blk_src"].shape).astype(np.int32)
        for s in range(S)
    )


# ---------------------------------------------------------------------------
# Node -> slot assignment (load balance / locality)
# ---------------------------------------------------------------------------


def _bfs_order(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Level-synchronous BFS order over the undirected edge set, seeded per
    component at the highest-degree unvisited node: the native library's
    ``bfs_order`` when it is available, NumPy otherwise (the same order)."""
    from plnlp_tpu_torch import native

    indptr, d2 = _undirected_csr_np(src, dst, num_nodes)
    seeds = np.argsort(-np.diff(indptr), kind="stable")
    if native.available():
        return native.bfs_order(indptr, d2, num_nodes, seeds)
    return _bfs_order_plain(indptr, d2, num_nodes, seeds)


def _bfs_order_plain(indptr, d2, num_nodes: int, seeds) -> np.ndarray:
    """NumPy frontier expansion of :func:`_bfs_order`."""
    visited = np.zeros(num_nodes, bool)
    order = np.empty(num_nodes, np.int64)
    pos = 0
    si = 0
    while pos < num_nodes:
        while si < num_nodes and visited[seeds[si]]:
            si += 1
        frontier = seeds[si : si + 1]
        visited[frontier] = True
        while len(frontier):
            order[pos : pos + len(frontier)] = frontier
            pos += len(frontier)
            starts = indptr[frontier]
            counts = indptr[frontier + 1] - starts
            total = int(counts.sum())
            if total == 0:
                break
            # flat neighbor gather: repeat(start) + intra-run offsets
            offs = np.arange(total) - np.repeat(
                np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
            )
            nbr = np.unique(d2[np.repeat(starts, counts) + offs])
            nbr = nbr[~visited[nbr]]
            visited[nbr] = True
            frontier = nbr
    return order


def _equal_edge_bounds(deg_ordered: np.ndarray, num_shards: int, cap: int) -> np.ndarray:
    """Cut an ordered node list into ``num_shards`` contiguous ranges of
    ~equal total degree, each at most ``cap`` nodes: each cut targets an
    equal share of the REMAINING edges, clamped so every later shard can
    still fit its nodes under ``cap``."""
    n = len(deg_ordered)
    if num_shards * cap < n:
        raise ValueError("cap too small for the node count")
    cum = np.concatenate([[0], np.cumsum(deg_ordered, dtype=np.int64)])
    bounds = np.zeros(num_shards + 1, np.int64)
    bounds[num_shards] = n
    for s in range(1, num_shards):
        prev = bounds[s - 1]
        remaining = num_shards - s + 1
        target = cum[prev] + (cum[n] - cum[prev]) / remaining
        j = int(np.searchsorted(cum, target))
        lo = max(prev, n - (num_shards - s) * cap)
        hi = min(prev + cap, n)
        bounds[s] = min(max(j, lo), hi)
    return bounds


def assign_slots(
    es: np.ndarray,
    ed: np.ndarray,
    num_nodes: int,
    num_shards: int,
    R: int,
    reorder: Optional[str],
    cap_factor: float = 1.5,
    order=None,
):
    """Node -> slot assignment: (node_map or None, rows_per_shard,
    resolved mode), ``node_map[g] = slot``; None is the identity layout."""
    legacy_rps = _pad_to(_pad_to(num_nodes, num_shards) // num_shards, R)
    # one shard keeps the identity, except under the community reorders
    if reorder in (None, "none") or (
        num_shards <= 1 and reorder not in ("labelprop", "multilevel")
    ):
        return None, legacy_rps, "none"
    deg = np.bincount(ed, minlength=num_nodes).astype(np.int64)

    if reorder == "auto":
        shard_of = np.minimum(np.arange(num_nodes) // legacy_rps, num_shards - 1)
        per = np.bincount(shard_of, weights=deg, minlength=num_shards)
        if per.max() / max(per.mean(), 1.0) <= 1.25:
            return None, legacy_rps, "none"
        reorder = "degree"

    if reorder == "degree":
        # serpentine deal by descending degree: round r hands nodes to
        # shards 0..S-1 (even r) or S-1..0 (odd r)
        order = np.argsort(-deg, kind="stable")
        n, S = num_nodes, num_shards
        pos_in_order = np.arange(n)
        rnd, lane = pos_in_order // S, pos_in_order % S
        shard = np.where(rnd % 2 == 0, lane, S - 1 - lane)
        rows_per_shard = _pad_to(-(-n // S), R)
        offset = np.zeros(n, np.int64)
        for s in range(S):
            sel = shard == s
            offset[sel] = np.arange(int(sel.sum()))
        node_map = np.empty(n, np.int64)
        node_map[order] = shard * rows_per_shard + offset
        return node_map.astype(np.int32), rows_per_shard, "degree"

    if reorder == "bfs":
        order = _bfs_order(es, ed, num_nodes)
    elif reorder in ("labelprop", "multilevel"):
        if order is None:
            from plnlp_tpu_torch.ops.tile_spmm import label_prop_order, multilevel_order

            fn = multilevel_order if reorder == "multilevel" else label_prop_order
            order = fn(es, ed, num_nodes)
    elif reorder == "edges":
        order = np.arange(num_nodes, dtype=np.int64)
    else:
        raise ValueError(f"unknown reorder mode: {reorder!r}")
    cap = max(int(cap_factor * -(-num_nodes // num_shards)), 1)
    bounds = _equal_edge_bounds(deg[order], num_shards, cap)
    rows_per_shard = _pad_to(max(int(np.diff(bounds).max()), 1), R)
    node_map = np.empty(num_nodes, np.int64)
    for s in range(num_shards):
        lo, hi = bounds[s], bounds[s + 1]
        node_map[order[lo:hi]] = s * rows_per_shard + np.arange(hi - lo)
    return node_map.astype(np.int32), rows_per_shard, reorder


def _perms_from_node_map(node_map: np.ndarray, padded: int):
    """(perm_in, perm_out): mutually inverse padded-length permutations;
    global positions >= num_nodes (x's zero padding rows) fill the
    unoccupied slots."""
    occupied = np.zeros(padded, bool)
    occupied[node_map] = True
    perm_out = np.concatenate([node_map.astype(np.int64), np.nonzero(~occupied)[0]])
    perm_in = np.empty(padded, np.int64)
    perm_in[perm_out] = np.arange(padded)
    return perm_in.astype(np.int32), perm_out.astype(np.int32)


def partition_graph(
    src,
    dst,
    weight=None,
    *,
    num_nodes: int,
    num_shards: int,
    block: Tuple[int, int] = (128, 512),
    symmetrize: bool = False,
    coalesce: bool = True,
    reorder: Optional[str] = None,
    cap_factor: float = 1.5,
    tile: int = 0,
    order=None,
) -> PartitionedGraph:
    """Partition the edge list over ``num_shards`` destination-row shards
    (``tile`` > 0, the tiled partition, raises: not ported yet)."""
    if tile:
        raise NotImplementedError(TILED_NOT_PORTED)
    R, B = block
    csr = _csr_np(src, dst, weight, num_nodes, symmetrize, coalesce)
    es = csr["senders"].astype(np.int64)
    ed = csr["receivers"].astype(np.int64)
    ew = csr["edge_weight"]

    node_map, rows_per_shard, resolved = assign_slots(
        es, ed, num_nodes, num_shards, R, reorder, cap_factor, order=order
    )
    perm_in = perm_out = None
    if node_map is not None:
        es = node_map[es].astype(np.int64)
        ed = node_map[ed].astype(np.int64)
        perm_in, perm_out = _perms_from_node_map(node_map, num_shards * rows_per_shard)

    deg = np.bincount(ed, minlength=num_shards * rows_per_shard).astype(np.int32)
    shard_edges = tuple(
        int(c) for c in np.bincount(ed // rows_per_shard, minlength=num_shards)
    )
    fwd, fwd_nblk = _shard_blocks(es, ed, ew, num_shards, rows_per_shard, R, B)
    # backward: the same edges grouped by SOURCE shard
    bwd, _ = _shard_blocks(ed, es, ew, num_shards, rows_per_shard, R, B)
    return PartitionedGraph(
        fwd=fwd,
        bwd=bwd,
        bwd_gather_fwd=_bwd_gather_fwd_np(fwd, bwd, rows_per_shard, R),
        local_in_degrees=deg.reshape(num_shards, rows_per_shard),
        num_nodes=num_nodes,
        num_shards=num_shards,
        rows_per_shard=rows_per_shard,
        block_rows=R,
        block_edges=B,
        perm_in=perm_in,
        perm_out=perm_out,
        reorder=resolved,
        shard_edges=shard_edges,
        shard_nblk=fwd_nblk,
    )
