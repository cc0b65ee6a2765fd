"""plnlp_tpu_torch — the PyTorch/CUDA port of plnlp_tpu for one NVIDIA H100.

Same module layout as ``plnlp_tpu`` (graph, ops/spmm, models, training,
serve, metrics); the hot aggregations run hand-written CUDA kernels
(``csrc/``: the blocked scatter-matmul, the dense-tile matmul and the
block-sparse flash attention).  Imports torch, numpy and the stdlib only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of quietly running on the CPU.  Everything
computes in float32 with TF32 off, so results compare with the JAX package
at float32 tolerances.
"""

from __future__ import annotations

import torch

# float32 means float32: no TF32 rounding in matmuls or convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; raises when CUDA is asked for
    (explicitly or by default) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "plnlp_tpu_torch runs on CUDA by default and no GPU is present; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


from plnlp_tpu_torch.dense import DenseAdj, prepare_dense, to_dense  # noqa: E402
from plnlp_tpu_torch.graph import (  # noqa: E402
    Graph,
    build_graph,
    prepare_graph,
    transpose_graph,
    with_blocks,
)

__version__ = "0.1.0"

__all__ = [
    "DenseAdj",
    "prepare_dense",
    "to_dense",
    "Graph",
    "build_graph",
    "prepare_graph",
    "transpose_graph",
    "with_blocks",
    "default_device",
    "__version__",
]
