"""Dense-adjacency operand for small graphs (port of plnlp_tpu/dense.py).

For a graph like ogbl-ddi (4,267 nodes, ~1M edges, mean degree ~500) the
N x N adjacency is ~70 MB, and one dense ``adj @ x`` (a plain matmul, as
the JAX package computes it outside any Pallas kernel) beats a sparse
gather/scatter.  ``DenseAdj`` is an aggregation operand for every encoder:
``ops.spmm.spmm`` and the TRANSFORMER encoder accept it beside a CSR
:class:`~plnlp_tpu_torch.graph.Graph` and a ``HybridGraph``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from plnlp_tpu_torch.graph import Graph, _csr_np

__all__ = ["DenseAdj", "to_dense", "prepare_dense"]


@dataclasses.dataclass(frozen=True)
class DenseAdj:
    """Row = destination (the convention of ``Graph``): out = adj @ x."""

    adj: torch.Tensor  # (N, N) float32
    in_degrees: torch.Tensor  # (N,) int32, unweighted in-edge counts
    num_nodes: int

    @property
    def device(self) -> torch.device:
        return self.adj.device

    def to(self, device) -> "DenseAdj":
        return dataclasses.replace(
            self, adj=self.adj.to(device), in_degrees=self.in_degrees.to(device)
        )


def _dense_np(csr) -> Tuple[np.ndarray, np.ndarray]:
    """(adj, in_degrees) on the host: the native library's ``densify`` when
    it is available, the NumPy version otherwise (the same bits)."""
    from plnlp_tpu_torch import native

    if native.available():
        return native.densify(csr["senders"], csr["receivers"], csr["edge_weight"],
                              csr["num_nodes"])
    return _dense_plain(csr)


def _dense_plain(csr) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy version of :func:`_dense_np`.  One ``bincount`` over the flat
    cell index: each cell's weights summed in float64 in edge order, then
    rounded to float32 once (``np.add.at``, which the JAX package falls
    back to, takes ~40 s at 2M edges)."""
    n = csr["num_nodes"]
    recv = csr["receivers"].astype(np.int64)
    send = csr["senders"].astype(np.int64)
    cells = np.bincount(recv * n + send, csr["edge_weight"], minlength=n * n)
    deg = np.bincount(recv, minlength=n).astype(np.int32)
    return cells.astype(np.float32).reshape(n, n), deg


def to_dense(graph: Graph) -> DenseAdj:
    """Densify an existing Graph on its device (no host readback)."""
    n = graph.num_nodes
    a = torch.zeros((n, n), dtype=torch.float32, device=graph.device)
    a.index_put_(
        (graph.receivers.long(), graph.senders.long()), graph.edge_weight, accumulate=True
    )
    return DenseAdj(adj=a, in_degrees=graph.in_degrees, num_nodes=n)


def prepare_dense(
    src,
    dst,
    weight=None,
    *,
    num_nodes: int,
    symmetrize: bool = False,
    coalesce: bool = True,
    device=None,
) -> DenseAdj:
    """Host-side COO -> DenseAdj with one host-to-device push."""
    from plnlp_tpu_torch import default_device

    device = default_device(device)
    a, deg = _dense_np(_csr_np(src, dst, weight, num_nodes, symmetrize, coalesce))
    return DenseAdj(
        adj=torch.from_numpy(a).to(device),
        in_degrees=torch.from_numpy(deg).to(device),
        num_nodes=num_nodes,
    )
