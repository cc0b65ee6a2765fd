from plnlp_tpu_torch.ops.spmm import (
    SpmmBlocked,
    blocked_sum_arrays,
    spmm,
    spmm_blocked,
    spmm_dense,
    spmm_segment,
)

__all__ = [
    "spmm",
    "spmm_segment",
    "spmm_blocked",
    "spmm_dense",
    "blocked_sum_arrays",
    "SpmmBlocked",
]
