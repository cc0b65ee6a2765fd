"""Blocked-CSR weighted scatter-matmul: the CUDA kernel and its plain version.

Replaces the TPU kernel ``plnlp_tpu/ops/pallas_spmm.py::_kernel``.  For
every edge slot e of the sub-blocks of row-block rb:

    out[rb * R + blk_local[e]] += blk_weight[e] * x[blk_src[e]]

with output rows no edge reaches equal to zero, for x and out in float32 or
bfloat16.  In bfloat16 it is the TPU kernel's function with bf16 feats:
each weight rounded to bf16, the products summed in f32, each output row
rounded to bf16 once.  The CUDA kernel
(``csrc/scatter_matmul.cu``, whose header note gives its design and bound)
cuts the destination-sorted slot array into equal runs, one warp each, so a
hub row-block no longer serializes; rows that cross runs are summed in a
second pass in a fixed order, so the result is the same on every launch.
It fuses the gather ``x[blk_src]`` that the JAX path materializes.  Its
wrapper :func:`scatter_matmul` launches it for CUDA tensors (``out`` from
``torch.zeros``, the carries in scratch from ``torch.empty``) and uses
:func:`scatter_matmul_reference` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["scatter_matmul", "scatter_matmul_reference"]

# Kernel launches since the count was last set to 0 (read by chip_smoke.py
# to show that the main path ran through the kernel): LAUNCHES for float32
# x, LAUNCHES_BF16 for bfloat16 x.
LAUNCHES = 0
LAUNCHES_BF16 = 0

_ENTRY = {torch.float32: "plnlp_scatter_matmul_f32", torch.bfloat16: "plnlp_scatter_matmul_bf16"}

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def scatter_matmul_reference(
    x, blk_src, blk_local, blk_weight, blk_rowptr, block_rows: int, out_rows: int
) -> torch.Tensor:
    """Plain PyTorch version: weight-masked ``index_add_`` over
    ``rowblock * R + local``, row-block rb taking the sub-blocks
    ``[blk_rowptr[rb], blk_rowptr[rb + 1])`` as the kernel does.  The
    weights are rounded to x's dtype, the sums taken in float32 and the
    result rounded to x's dtype once (a no-op for float32 x)."""
    counts = (blk_rowptr[1:] - blk_rowptr[:-1]).long()
    total = int(counts.sum())
    rowblock = torch.repeat_interleave(
        torch.arange(len(counts), device=x.device), counts, output_size=total
    )
    # index of each selected sub-block: its row-block's start + its rank
    first = torch.cumsum(counts, 0) - counts
    sub = torch.repeat_interleave(
        blk_rowptr[:-1].long() - first, counts, output_size=total
    ) + torch.arange(total, device=x.device)
    dst = (rowblock[:, None] * block_rows + blk_local[sub]).reshape(-1)
    w = blk_weight[sub].reshape(-1, 1).to(x.dtype).float()
    msgs = x[blk_src[sub].reshape(-1)].float() * w
    out = msgs.new_zeros((len(counts) * block_rows, x.shape[1]))
    return out.index_add_(0, dst, msgs)[:out_rows].to(x.dtype)


def _check(x, blk_src, blk_local, blk_weight, blk_rowptr, block_rows, out_rows):
    tensors = {
        "x": x, "blk_src": blk_src, "blk_local": blk_local,
        "blk_weight": blk_weight, "blk_rowptr": blk_rowptr,
    }
    want = {
        "blk_src": torch.int32, "blk_local": torch.int32,
        "blk_weight": torch.float32, "blk_rowptr": torch.int32,
    }
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if name in want and t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or blk_src.dim() != 2:
        raise ValueError("x and blk_src must be 2-D")
    if blk_local.shape != blk_src.shape or blk_weight.shape != blk_src.shape:
        raise ValueError("blk_src, blk_local and blk_weight must share (nblk, B)")
    n_rowblocks = -(-out_rows // block_rows)
    if blk_rowptr.shape != (n_rowblocks + 1,):
        raise ValueError(
            f"blk_rowptr must have ceil(out_rows / R) + 1 = {n_rowblocks + 1} "
            f"entries, got {tuple(blk_rowptr.shape)}"
        )


def scatter_matmul(
    x: torch.Tensor,  # (n_src, D) float32 or bfloat16 source features
    blk_src: torch.Tensor,  # (nblk, B) int32 source row per edge slot
    blk_local: torch.Tensor,  # (nblk, B) int32 destination row within row-block
    blk_weight: torch.Tensor,  # (nblk, B) float32 edge weight (0 = padding)
    blk_rowptr: torch.Tensor,  # (n_rowblocks + 1,) int32 first sub-block per row-block
    block_rows: int,
    out_rows: int,
) -> torch.Tensor:
    """Returns (out_rows, D) in x's dtype.  CUDA tensors launch the kernel
    of x's dtype on the current stream (never the other one, never through
    a cast); CPU tensors take :func:`scatter_matmul_reference`.  The kernel
    takes the live slots (weight != 0) in the order ``graph.py`` lays them
    out: destination rows non-decreasing from slot to slot."""
    global LAUNCHES, LAUNCHES_BF16
    _check(x, blk_src, blk_local, blk_weight, blk_rowptr, block_rows, out_rows)
    if x.device.type == "cpu":
        return scatter_matmul_reference(
            x, blk_src, blk_local, blk_weight, blk_rowptr, block_rows, out_rows
        )
    if x.device.type != "cuda":
        raise ValueError(f"scatter_matmul runs on cuda or cpu, not {x.device}")
    from plnlp_tpu_torch import _build

    lib = _build.load("scatter_matmul")
    fn = getattr(lib, _ENTRY[x.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    nblk, block_edges = blk_src.shape
    d = x.shape[1]
    out = torch.zeros((out_rows, d), dtype=x.dtype, device=x.device)
    run_slots = lib.plnlp_scatter_matmul_run_slots()
    n_runs = -(-nblk * block_edges // run_slots)
    if out_rows == 0 or d == 0 or n_runs == 0:
        return out
    carry = torch.empty((2 * n_runs, d), dtype=torch.float32, device=x.device)
    run_rows = torch.empty(2 * n_runs, dtype=torch.int32, device=x.device)
    # 16 bytes of x's elements per vector load: 4 f32 or 8 bf16
    vec = d % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), blk_src.data_ptr(), blk_local.data_ptr(),
            blk_weight.data_ptr(), blk_rowptr.data_ptr(), out.data_ptr(),
            carry.data_ptr(), run_rows.data_ptr(), blk_rowptr.shape[0] - 1,
            out_rows, block_rows, nblk, block_edges, d, int(vec), stream,
        )
    _build.check(lib, err, f"scatter_matmul launch ({x.dtype}, R={block_rows}, D={d})")
    if x.dtype == torch.bfloat16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return out
