"""Graph container and host-side preprocessing (port of plnlp_tpu/graph.py).

All surgery (coalesce, symmetrize, self-loops, normalizations, CSR and
blocking) runs once in NumPy on the host; the finished arrays are pushed to
the device once and never read back on the hot path.

Differences from the JAX package, all layout rather than semantics:

* No edge padding: PyTorch has no static-shape requirement, so ``senders``
  / ``receivers`` / ``edge_weight`` hold exactly the ``num_edges`` real
  edges.
* No ``_align_blocks``: the trailing all-padding sub-block the TPU path
  appends to dodge a slow gather length is not added.
* One extra field, ``blk_rowptr`` ``(n_rowblocks + 1,)`` int32: the first
  sub-block of each row-block, so a CUDA block finds its own edge range
  without the TPU kernel's grid-order carry.

So ``tconv_map`` (``prepare_graph(couple_transpose=True)``) names other
slots than the JAX package's array: it is the same pairing over this
layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from plnlp_tpu_torch.profiling import span

__all__ = [
    "Graph",
    "build_graph",
    "prepare_graph",
    "transpose_graph",
    "coalesce_edges",
    "to_undirected_edges",
    "add_self_loop_edges",
    "gcn_normalize_edges",
    "row_normalize_edges",
    "with_blocks",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """CSR-ordered edge set; ``senders[e] -> receivers[e]``, sorted by
    (receiver, sender).  The ``blk_*`` fields are the blocked-SpMM metadata
    consumed by ``ops.spmm`` (None until blocked)."""

    senders: torch.Tensor  # [E] int32, source node per edge
    receivers: torch.Tensor  # [E] int32, destination node per edge (sorted)
    edge_weight: torch.Tensor  # [E] float32
    indptr: torch.Tensor  # [N + 1] int32 over receivers
    num_nodes: int
    num_edges: int
    max_degree: int = 0  # bounds the serving neighbor window

    blk_src: Optional[torch.Tensor] = None  # [nblk, B] int32
    blk_weight: Optional[torch.Tensor] = None  # [nblk, B] float32 (0 = pad)
    blk_local: Optional[torch.Tensor] = None  # [nblk, B] int32, dst - rb*R
    blk_rowblock: Optional[torch.Tensor] = None  # [nblk] int32, sorted
    blk_rowptr: Optional[torch.Tensor] = None  # [n_rowblocks + 1] int32
    block_rows: int = 0  # R: rows per row-block
    block_edges: int = 0  # B: edges per sub-block
    # [nblk_t, B] int32 on the forward graph: for each slot of the
    # transposed graph, the flat forward slot of the same edge (0 at
    # padding); the blocked TransformerConv's backward (ops/transformer.py)
    tconv_map: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.senders.device

    @property
    def in_degrees(self) -> torch.Tensor:
        """Number of real in-edges per destination row."""
        return self.indptr[1:] - self.indptr[:-1]

    def to(self, device) -> "Graph":
        """The same graph with every tensor moved to ``device``."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


# ---------------------------------------------------------------------------
# Host-side (NumPy) edge-list transforms
# ---------------------------------------------------------------------------


def coalesce_edges(
    src: np.ndarray,
    dst: np.ndarray,
    weight: Optional[np.ndarray],
    num_nodes: int,
    reduce: str = "add",
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Sort edges by (dst, src) and merge duplicates (reduce: add|max|min|mean).
    ``add`` runs in the native library when it is available (the same
    bits: ``native.coalesce_add``), the NumPy version otherwise."""
    from plnlp_tpu_torch import native

    if reduce == "add" and native.available():
        return native.coalesce_add(src, dst, weight, num_nodes)
    return _coalesce_plain(src, dst, weight, num_nodes, reduce)


def _coalesce_plain(src, dst, weight, num_nodes: int, reduce: str = "add"):
    """NumPy version of :func:`coalesce_edges`: float64 sums in stable
    (dst, src) order, rounded to float32 once."""
    src = np.asarray(src).astype(np.int64)
    dst = np.asarray(dst).astype(np.int64)
    key = dst * int(num_nodes) + src
    order = np.argsort(key, kind="stable")
    key = key[order]
    uniq_key, inverse = np.unique(key, return_inverse=True)
    new_dst = uniq_key // num_nodes
    new_src = uniq_key % num_nodes
    if weight is None:
        return new_src, new_dst, None
    w = np.asarray(weight).astype(np.float64)[order]
    if reduce in ("add", "mean"):
        new_w = np.zeros(len(uniq_key), dtype=np.float64)
        np.add.at(new_w, inverse, w)
        if reduce == "mean":
            new_w /= np.bincount(inverse, minlength=len(uniq_key))
    elif reduce == "max":
        new_w = np.full(len(uniq_key), -np.inf)
        np.maximum.at(new_w, inverse, w)
    elif reduce == "min":
        new_w = np.full(len(uniq_key), np.inf)
        np.minimum.at(new_w, inverse, w)
    else:
        raise ValueError(f"unknown reduce: {reduce}")
    return new_src, new_dst, new_w.astype(np.float32)


def to_undirected_edges(src, dst, weight, num_nodes: int, reduce: str = "add"):
    """Both directions + coalesce (PyG to_undirected)."""
    src, dst = np.asarray(src), np.asarray(dst)
    w2 = None if weight is None else np.concatenate([np.asarray(weight)] * 2)
    return coalesce_edges(
        np.concatenate([src, dst]), np.concatenate([dst, src]), w2, num_nodes,
        reduce=reduce,
    )


def add_self_loop_edges(src, dst, weight, num_nodes: int, fill_value: float = 1.0):
    """Insert/overwrite diagonal entries (torch_sparse set_diag): existing
    (i, i) edges are replaced by ``fill_value``."""
    src = np.asarray(src).astype(np.int64)
    dst = np.asarray(dst).astype(np.int64)
    off_diag = src != dst
    loops = np.arange(num_nodes, dtype=np.int64)
    new_src = np.concatenate([src[off_diag], loops])
    new_dst = np.concatenate([dst[off_diag], loops])
    new_w = None
    if weight is not None:
        w = np.asarray(weight).astype(np.float32)[off_diag]
        new_w = np.concatenate([w, np.full(num_nodes, fill_value, np.float32)])
    return coalesce_edges(new_src, new_dst, new_w, num_nodes)


def gcn_normalize_edges(src, dst, weight, num_nodes: int):
    """``D^-1/2 (A + I) D^-1/2`` with self-loops set to 1 (GCN)."""
    if weight is None:
        weight = np.ones(len(np.asarray(src)), dtype=np.float32)
    src, dst, w = add_self_loop_edges(src, dst, weight, num_nodes, fill_value=1.0)
    deg = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(deg, dst, w.astype(np.float64))
    with np.errstate(divide="ignore"):
        dinv = np.power(deg, -0.5)
    dinv[np.isinf(dinv)] = 0.0
    return src, dst, (dinv[dst] * w * dinv[src]).astype(np.float32)


def row_normalize_edges(src, dst, weight, num_nodes: int):
    """Row normalization ``D^-1 A`` without self-loops (WSAGE)."""
    src, dst = np.asarray(src), np.asarray(dst)
    if weight is None:
        weight = np.ones(len(src), dtype=np.float32)
    w = np.asarray(weight).astype(np.float64)
    deg = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(deg, dst, w)
    with np.errstate(divide="ignore"):
        dinv = np.power(deg, -1.0)
    dinv[np.isinf(dinv)] = 0.0
    return src, dst, (dinv[dst] * w).astype(np.float32)


# ---------------------------------------------------------------------------
# Graph construction
# ---------------------------------------------------------------------------


def _undirected_csr_np(src, dst, num_nodes: int):
    """(indptr, indices) over the undirected edge set (host-side)."""
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    order_e = np.argsort(s2, kind="stable")
    s2, d2 = s2[order_e], d2[order_e]
    indptr = np.zeros(num_nodes + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(s2, minlength=num_nodes))
    return indptr, d2


def _pad_to(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple``."""
    return ((n + multiple - 1) // multiple) * multiple


def _csr_np(src, dst, weight, num_nodes: int, symmetrize: bool, coalesce: bool):
    """All-NumPy CSR assembly; returns a dict of host arrays."""
    src = np.asarray(src).astype(np.int64)
    dst = np.asarray(dst).astype(np.int64)
    if weight is not None:
        weight = np.asarray(weight).astype(np.float32)
    if symmetrize:
        src, dst, weight = to_undirected_edges(src, dst, weight, num_nodes)
    elif coalesce:
        src, dst, weight = coalesce_edges(src, dst, weight, num_nodes)
    else:
        order = np.argsort(dst * int(num_nodes) + src, kind="stable")
        src, dst = src[order], dst[order]
        if weight is not None:
            weight = weight[order]
    if weight is None:
        weight = np.ones(len(src), dtype=np.float32)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    return {
        "senders": src.astype(np.int32),
        "receivers": dst.astype(np.int32),
        "edge_weight": weight.astype(np.float32),
        "indptr": indptr.astype(np.int32),
        "num_nodes": int(num_nodes),
        "num_edges": int(len(src)),
        "max_degree": int(np.diff(indptr).max()) if num_nodes else 0,
    }


def _blocks_np(csr, block_rows: int, block_edges: int):
    """Blocked metadata: edges grouped by destination row-block
    ``dst // R``, each group cut into sub-blocks of ``B`` edges
    (weight-0 padded).  Every row-block gets at least one sub-block, so
    the metadata names every output row-block.  Runs in the native library
    when it is available (``native.blocks_build``, the same arrays)."""
    from plnlp_tpu_torch import native

    if native.available():
        return native.blocks_build(
            csr["senders"], csr["receivers"], csr["edge_weight"], csr["indptr"],
            csr["num_nodes"], int(block_rows), int(block_edges),
        )
    return _blocks_plain(csr, block_rows, block_edges)


def _blocks_plain(csr, block_rows: int, block_edges: int):
    """NumPy version of :func:`_blocks_np`."""
    R, B = int(block_rows), int(block_edges)
    n = csr["num_nodes"]
    e = csr["num_edges"]
    indptr = csr["indptr"].astype(np.int64)
    n_rowblocks = -(-n // R)
    bounds = indptr[np.minimum(np.arange(n_rowblocks + 1) * R, n)]
    cnts = np.diff(bounds)
    nbs = np.maximum((cnts + B - 1) // B, 1)
    nblk = int(nbs.sum())
    blk_rowptr = np.concatenate([[0], np.cumsum(nbs)])
    edge_rb = np.repeat(np.arange(n_rowblocks), cnts)
    edge_off = np.arange(e) - np.repeat(bounds[:-1], cnts)
    slot = blk_rowptr[edge_rb] * B + edge_off

    blk_src = np.zeros(nblk * B, np.int32)
    blk_w = np.zeros(nblk * B, np.float32)
    blk_local = np.zeros(nblk * B, np.int32)
    blk_src[slot] = csr["senders"]
    blk_w[slot] = csr["edge_weight"]
    blk_local[slot] = csr["receivers"].astype(np.int64) - edge_rb * R
    return {
        "blk_src": blk_src.reshape(nblk, B),
        "blk_weight": blk_w.reshape(nblk, B),
        "blk_local": blk_local.reshape(nblk, B),
        "blk_rowblock": np.repeat(np.arange(n_rowblocks), nbs).astype(np.int32),
        "blk_rowptr": blk_rowptr.astype(np.int32),
        "block_rows": R,
        "block_edges": B,
    }


_BLOCK_ARRAYS = ("blk_src", "blk_weight", "blk_local", "blk_rowblock", "blk_rowptr")
_CSR_ARRAYS = ("senders", "receivers", "edge_weight", "indptr")


def _tconv_map_np(blocks, blocks_t, R: int, R_t: int) -> np.ndarray:
    """Flat forward-slot index of each transposed-structure slot's edge.

    Both blocked structures hold the real edge set once; matching the two
    key-sorted slot lists element-wise pairs every transposed slot with the
    forward slot of the same (src, dst) edge (duplicate edges too:
    identical key multisets pair k-th with k-th).  Padding slots point at
    0 and are masked by ``blk_weight == 0``.
    """
    stride = np.int64(1) << 31
    f_dst = blocks["blk_rowblock"][:, None].astype(np.int64) * R + blocks["blk_local"]
    keys_f = (f_dst * stride + blocks["blk_src"]).reshape(-1)
    valid_f = blocks["blk_weight"].reshape(-1) != 0
    t_rows = blocks_t["blk_rowblock"][:, None].astype(np.int64) * R_t + blocks_t["blk_local"]
    keys_t = (blocks_t["blk_src"].astype(np.int64) * stride + t_rows).reshape(-1)
    valid_t = blocks_t["blk_weight"].reshape(-1) != 0
    kf, kt = keys_f[valid_f], keys_t[valid_t]
    if kf.shape != kt.shape:
        raise ValueError("the graph and its transpose hold different edge counts")
    ff = np.nonzero(valid_f)[0]
    out = np.zeros(keys_t.size, np.int64)
    out[np.nonzero(valid_t)[0][np.argsort(kt, kind="stable")]] = ff[np.argsort(kf, kind="stable")]
    return out.reshape(blocks_t["blk_src"].shape).astype(np.int32)


def _to_graph(csr, blocks, device) -> Graph:
    """One host-to-device push of every array."""
    fields = {k: torch.from_numpy(csr[k]).to(device) for k in _CSR_ARRAYS}
    fields.update(
        num_nodes=csr["num_nodes"],
        num_edges=csr["num_edges"],
        max_degree=csr["max_degree"],
    )
    if blocks is not None:
        fields.update({k: torch.from_numpy(blocks[k]).to(device) for k in _BLOCK_ARRAYS})
        fields.update(block_rows=blocks["block_rows"], block_edges=blocks["block_edges"])
    return Graph(**fields)


def build_graph(
    src,
    dst,
    weight=None,
    *,
    num_nodes: int,
    symmetrize: bool = False,
    coalesce: bool = True,
    block: Optional[Tuple[int, int]] = None,
    device=None,
) -> Graph:
    """A CSR-ordered :class:`Graph` from a COO edge list; ``block=(R, B)``
    attaches blocked-SpMM metadata in the same host pass."""
    from plnlp_tpu_torch import default_device

    device = default_device(device)
    csr = _csr_np(src, dst, weight, num_nodes, symmetrize, coalesce)
    blocks = _blocks_np(csr, *block) if block is not None else None
    return _to_graph(csr, blocks, device)


def prepare_graph(
    src,
    dst,
    weight=None,
    *,
    num_nodes: int,
    symmetrize: bool = False,
    coalesce: bool = True,
    block: Optional[Tuple[int, int]] = (512, 512),
    couple_transpose: bool = False,
    device=None,
) -> Tuple[Graph, Graph]:
    """(graph, transposed graph), both blocked, built on the host and pushed
    to the device once each.  The transpose carries the backward of the
    blocked SpMM.  ``couple_transpose=True`` also attaches
    ``graph.tconv_map``, the slot pairing the blocked TransformerConv's
    backward needs (two host sorts of the edge list)."""
    from plnlp_tpu_torch import default_device

    if couple_transpose and block is None:
        raise ValueError(
            "couple_transpose=True needs blocked metadata (block=(R, B)): the tconv slot "
            "map pairs block slots between the two graphs"
        )
    device = default_device(device)
    with span("graph.prepare_graph"):
        with span("graph.csr"):
            csr = _csr_np(src, dst, weight, num_nodes, symmetrize, coalesce)
        e = csr["num_edges"]
        with span("graph.csr_t"):
            csr_t = _csr_np(
                csr["receivers"][:e], csr["senders"][:e], csr["edge_weight"][:e],
                num_nodes, False, False,
            )
        blocks = blocks_t = tmap = None
        if block is not None:
            with span("graph.blocks"):
                blocks, blocks_t = _blocks_np(csr, *block), _blocks_np(csr_t, *block)
            if couple_transpose:
                tmap = _tconv_map_np(blocks, blocks_t, block[0], block[0])
        with span("graph.upload"):
            g = _to_graph(csr, blocks, device)
            if tmap is not None:
                g = dataclasses.replace(g, tconv_map=torch.from_numpy(tmap).to(device))
            return g, _to_graph(csr_t, blocks_t, device)


def transpose_graph(graph: Graph) -> Graph:
    """Aᵀ: senders and receivers swapped and re-sorted into CSR order, on
    ``graph``'s device and blocked as ``graph`` is.  Reads the edge list
    back to the host; :func:`prepare_graph` builds both at once."""
    e = graph.num_edges
    src, dst, w = (getattr(graph, k)[:e].cpu().numpy() for k in _CSR_ARRAYS[:3])
    block = (graph.block_rows, graph.block_edges) if graph.block_rows else None
    return build_graph(dst, src, w, num_nodes=graph.num_nodes, coalesce=False, block=block,
                       device=graph.device)


def with_blocks(graph: Graph, block_rows: int = 256, block_edges: int = 512) -> Graph:
    """Attach blocked-SpMM metadata to an existing graph (reads its CSR
    arrays back to the host; prefer ``build_graph(block=...)``)."""
    csr = {k: getattr(graph, k).cpu().numpy() for k in _CSR_ARRAYS}
    csr.update(num_nodes=graph.num_nodes, num_edges=graph.num_edges)
    blocks = _blocks_np(csr, block_rows, block_edges)
    return dataclasses.replace(
        graph,
        **{k: torch.from_numpy(blocks[k]).to(graph.device) for k in _BLOCK_ARRAYS},
        block_rows=blocks["block_rows"],
        block_edges=blocks["block_edges"],
        tconv_map=None,  # pairs the old layout's slots
    )
