"""Uniform random walks over a CSR graph (port of plnlp_tpu/ops/walk.py).

The reference draws them with torch_cluster's ``random_walk`` for its
per-epoch pair augmentation (reference main.py:9,242).  A step is one
gather and one uniform draw per walker, on the graph's device, from the
caller's ``torch.Generator``.

Semantics of torch_cluster: a walker at a node without out-edges stays
where it is, and the result is an (S, L+1) matrix whose first column is
the start nodes.
"""

from __future__ import annotations

import torch

from plnlp_tpu_torch.graph import Graph

__all__ = ["random_walk"]

# draws are taken modulo the degree; the bias is below degree / 2**62
_DRAW_HIGH = 2**62


def random_walk(
    graph: Graph, start, walk_length: int, gen: torch.Generator
) -> torch.Tensor:
    """Walk ``walk_length`` uniform steps from each node in ``start``.

    Reads the CSR-over-receivers layout: the neighbors of node v are
    ``senders[indptr[v]:indptr[v+1]]`` (in- and out-neighborhoods coincide
    on the symmetric adjacencies the reference walks, main.py:228-233).
    ``gen`` lies on the graph's device."""
    dev = graph.device
    cur = torch.as_tensor(start, device=dev).long()
    indptr, senders = graph.indptr.long(), graph.senders.long()
    last = max(graph.num_edges - 1, 0)
    cols = [cur]
    for _ in range(int(walk_length)):
        lo = indptr[cur]
        deg = indptr[cur + 1] - lo
        r = torch.randint(0, _DRAW_HIGH, cur.shape, generator=gen, device=dev) % deg.clamp(min=1)
        nxt = senders[(lo + r).clamp(max=last)] if graph.num_edges else cur
        cur = torch.where(deg > 0, nxt, cur)
        cols.append(cur)
    return torch.stack(cols, dim=1)
