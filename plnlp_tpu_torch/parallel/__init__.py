"""The multi-device runtime over ``torch.distributed`` (port of
plnlp_tpu/parallel, the blocked-CSR half): one process per card, a
(data, node) mesh, the graph partition and halo plans, the graph-parallel
SpMM on K1, and the sharded training state."""

from plnlp_tpu_torch.parallel.graph_parallel import (
    GraphParallel,
    gather_node_features,
    make_graph_parallel,
    partitioned_spmm,
    shard_node_features,
)
from plnlp_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    shard_batch,
    shard_params,
)
from plnlp_tpu_torch.parallel.partition import PartitionedGraph, partition_graph

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_params",
    "shard_batch",
    "GraphParallel",
    "make_graph_parallel",
    "partitioned_spmm",
    "shard_node_features",
    "gather_node_features",
    "PartitionedGraph",
    "partition_graph",
]
