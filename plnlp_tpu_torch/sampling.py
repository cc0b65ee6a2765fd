"""Negative edge samplers (port of plnlp_tpu/sampling.py).

Every sampler draws from the ``torch.Generator`` it is handed, on the
generator's device, and returns int64 ``(num_pos, num_neg, 2)``.  The JAX
package draws from ``jax.random``, so the two never give the same pairs:
they agree in what they guarantee (shapes, no self-loops, no true edge
while non-edges exist, the perm-copy structure), not bit for bit.

Membership is an exact binary search: a graph's CSR is sorted by
(receiver, sender), so the int64 keys ``receiver * N + sender`` are sorted
and ``torch.searchsorted`` finds a queried pair's key or its insertion
point.
"""

from __future__ import annotations

import numpy as np
import torch

from plnlp_tpu_torch.graph import Graph

__all__ = [
    "edges_exist",
    "global_neg_sample",
    "global_perm_neg_sample",
    "local_neg_sample",
    "local_dist_neg_sample",
    "sample_perm_copy",
    "degree_unigram_table",
]

_REJECTION_ROUNDS = 4


def edges_exist(graph: Graph, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """True where (src, dst) is a real edge of ``graph``."""
    if graph.num_edges == 0:
        return torch.zeros(src.shape, dtype=torch.bool, device=src.device)
    n = graph.num_nodes
    keys = graph.receivers.long() * n + graph.senders.long()
    query = dst.long() * n + src.long()
    idx = torch.searchsorted(keys, query).clamp(max=graph.num_edges - 1)
    return keys[idx] == query


def _randint(gen: torch.Generator, high: int, shape) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=gen, device=gen.device)


def _sample_non_edges(gen: torch.Generator, graph: Graph, count: int) -> torch.Tensor:
    """(count, 2) uniform (src, dst) pairs avoiding real edges and self-loops.

    A fixed number of rejection rounds, then an exact pass: a pair that
    still collides is replaced by a random good pair of the same batch (a
    duplicate negative, the reference's own fallback); only when every
    pair collides (no non-edge exists) does a candidate pass through."""
    n = graph.num_nodes
    src, dst = _randint(gen, n, (2, count))
    for _ in range(_REJECTION_ROUNDS):
        bad = edges_exist(graph, src, dst) | (src == dst)
        cand = _randint(gen, n, (2, count))
        src = torch.where(bad, cand[0], src)
        dst = torch.where(bad, cand[1], dst)
    bad = edges_exist(graph, src, dst) | (src == dst)
    donor = _randint(gen, count, (count,))
    first_good = torch.argmin(bad.to(torch.uint8))  # 0 if all good or all bad
    donor = torch.where(bad[donor], first_good, donor)
    idx = torch.where(bad & ~bad[donor], donor, torch.arange(count, device=src.device))
    return torch.stack([src[idx], dst[idx]], dim=-1)


def global_neg_sample(
    gen: torch.Generator, graph: Graph, num_samples: int, num_neg: int
) -> torch.Tensor:
    """num_samples * num_neg global non-edges as (P, num_neg, 2)."""
    pairs = _sample_non_edges(gen, graph, num_samples * num_neg)
    return pairs.reshape(num_samples, num_neg, 2)


def sample_perm_copy(gen: torch.Generator, pairs: torch.Tensor, num_neg: int) -> torch.Tensor:
    """Keep the pool and append (num_neg - 1) whole-pool shuffles (the same
    permutation for src and dst, so copies re-shuffle existing pairs), then
    flat-reshape to (P, num_neg, 2)."""
    p = pairs.shape[0]
    chunks = [pairs]
    for _ in range(num_neg - 1):
        perm = torch.randperm(p, generator=gen, device=gen.device)
        chunks.append(pairs[perm.to(pairs.device)])
    return torch.cat(chunks, dim=0).reshape(p, num_neg, 2)


def global_perm_neg_sample(
    gen: torch.Generator, graph: Graph, num_samples: int, num_neg: int
) -> torch.Tensor:
    """One P-sized global pool, permute-copied num_neg times."""
    pool = _sample_non_edges(gen, graph, num_samples)
    return sample_perm_copy(gen, pool, num_neg)


def degree_unigram_table(
    graph: Graph, power: float = 0.75, table_size: int = 1_000_000
) -> torch.Tensor:
    """Degree^power unigram sampling table (word2vec style), built on the
    host; degrees count a self-loop, as the reference's set_diag does."""
    deg = graph.in_degrees.cpu().numpy().astype(np.float64) + 1.0
    p = deg**power
    cum = np.cumsum(p / p.sum())
    grid = (np.arange(table_size) + 0.5) / table_size
    table = np.minimum(np.searchsorted(cum, grid), graph.num_nodes - 1)
    return torch.from_numpy(table.astype(np.int64)).to(graph.device)


def _sources(gen, pos_edges, num_neg, random_src):
    p = pos_edges.shape[0]
    if random_src:
        side = _randint(gen, 2, (p,)).to(pos_edges.device)
        src = pos_edges[torch.arange(p, device=pos_edges.device), side]
    else:
        src = pos_edges[:, 0]
    return src.repeat_interleave(num_neg)


def local_dist_neg_sample(
    gen: torch.Generator,
    pos_edges: torch.Tensor,
    neg_table: torch.Tensor,
    num_neg: int,
    random_src: bool = True,
) -> torch.Tensor:
    """Degree-biased local sampler: a positive's endpoint as the source,
    destinations drawn from the unigram table."""
    p = pos_edges.shape[0]
    src = _sources(gen, pos_edges, num_neg, random_src)
    slot = _randint(gen, neg_table.shape[0], (num_neg * p,)).to(neg_table.device)
    dst = neg_table[slot].to(pos_edges.dtype)
    return torch.stack([src, dst], dim=-1).reshape(p, num_neg, 2)


def local_neg_sample(
    gen: torch.Generator,
    pos_edges: torch.Tensor,
    num_nodes: int,
    num_neg: int,
    random_src: bool = False,
) -> torch.Tensor:
    """The positive's source (or a random endpoint) with uniform random
    destinations; true edges are NOT excluded (as in the reference)."""
    p = pos_edges.shape[0]
    src = _sources(gen, pos_edges, num_neg, random_src)
    dst = _randint(gen, num_nodes, (num_neg * p,)).to(pos_edges.device, pos_edges.dtype)
    return torch.stack([src, dst], dim=-1).reshape(p, num_neg, 2)
