"""The device mesh over ``torch.distributed`` (port of
plnlp_tpu/parallel/mesh.py).

One process per card.  The world of ``data * node`` ranks is laid out as
the JAX package's mesh array, ``reshape(data, node)``: rank
``r = d * node + n`` has data index ``d`` and node index ``n``.

* ``node`` — the graph axis: the node index is the shard of the partition
  (``parallel/partition.py``) whose destination rows, embedding rows and
  blocked structure the rank holds.  ``node_group`` is this rank's data
  replica: the ``node`` ranks with its data index, over which features are
  exchanged.
* ``data`` — the pair-batch axis.  ``data_group`` holds the ranks with this
  rank's node index, which hold the same rows: their embedding gradients
  are summed over it, and evaluation chunks split over it.

Where the JAX package places arrays with shardings and lets XLA insert the
collectives, the port's placement helpers hand each rank its part
(``shard_params``: its rows of the table; ``shard_batch``: its slice of a
batch) and the collectives are explicit (``all_gather_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "Mesh", "make_mesh", "shard_params", "shard_batch",
    "all_gather_rows", "world_size",
]

_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, node) mesh and its two subgroups
    (None where a group would hold this rank alone)."""

    data: int
    node: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    node_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def world_size(self) -> int:
        return self.data * self.node

    @property
    def data_index(self) -> int:
        return self.rank // self.node

    @property
    def node_index(self) -> int:
        return self.rank % self.node

    def check(self) -> "Mesh":
        """Raise unless the process group is the world this mesh describes."""
        if self.world_size != world_size() or (dist.is_initialized() and self.rank != dist.get_rank()):
            raise ValueError(
                f"mesh (data={self.data}, node={self.node}, rank {self.rank}) does not match "
                f"the world: {world_size()} rank(s)"
                + (f", this is rank {dist.get_rank()}" if dist.is_initialized() else "")
            )
        return self


def make_mesh(data: int = 1, node: int = 1, device=None) -> Mesh:
    """The (data, node) mesh over the default process group, whose world
    must be ``data * node`` ranks (one rank needs no process group).
    ``device`` defaults to the current card under NCCL, else the CPU."""
    n = data * node
    if n != world_size():
        raise ValueError(
            f"a ({data}, {node}) mesh needs {n} ranks, the process group has {world_size()}"
            + ("" if dist.is_initialized() else " (none is initialized: launch with torchrun)")
        )
    rank, node_group, data_group = 0, None, None
    if dist.is_initialized():
        rank = dist.get_rank()
        # every rank creates every group, in the same order
        for d in range(data):
            ranks = [d * node + k for k in range(node)]
            g = dist.new_group(ranks) if node > 1 else None
            if rank in ranks:
                node_group = g
        for k in range(node):
            ranks = [d * node + k for d in range(data)]
            g = dist.new_group(ranks) if data > 1 else None
            if rank in ranks:
                data_group = g
    if device is None:
        nccl = dist.is_initialized() and dist.get_backend() == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return Mesh(data, node, rank, torch.device(device), node_group, data_group)


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked along rows, in group rank
    order; no autograd."""
    if group is None:
        return x
    out = x.new_empty((_group_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x.contiguous(), group=group)
    return out


class _AllGatherRows(torch.autograd.Function):
    """all_gather forward, reduce-scatter (sum) backward: right where every
    rank's loss is a distinct share of the global loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((g.shape[0] // _group_size(ctx.group),) + tuple(g.shape[1:]))
        _REDUCE_SCATTER(out, g.contiguous(), group=ctx.group)
        return out, None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all_gather of rows over ``group`` (identity alone)."""
    return x if group is None else _AllGatherRows.apply(x, group)


def shard_params(model, graph) -> None:
    """A rank takes its rows of the embedding table: over a
    ``GraphParallel`` the model keeps only this rank's slot rows
    (``Model.place_rows``); otherwise the table stays whole."""
    from plnlp_tpu_torch.parallel.graph_parallel import GraphParallel

    if isinstance(graph, GraphParallel):
        model.place_rows(graph)


def shard_batch(batch, mesh: Mesh):
    """This rank's slice of the leading axis of a tensor (or of each tensor
    of a tuple): the ``rank``-th of ``world_size`` contiguous near-equal
    shares, as training splits pair batches."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    q, r = divmod(batch.shape[0], mesh.world_size)
    lo = mesh.rank * q + min(mesh.rank, r)
    return batch[lo:lo + q + (mesh.rank < r)]
