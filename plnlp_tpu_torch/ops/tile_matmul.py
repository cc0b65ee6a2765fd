"""Block-sparse dense-tile matmul: the CUDA kernel and its plain version.

Replaces the TPU kernel ``plnlp_tpu/ops/pallas_tiles.py::_kernel``.  With
``vals`` (nt, T, T) sorted by row tile and x cut into (T, D) tiles:

    out[tile_row[i]] += vals[i] @ x_tiles[tile_col[i]]

with ``vals`` cast to x's dtype before the product, accumulated in f32 and
rounded to x's dtype once (x float32 or bfloat16), and row tiles that no
tile reaches equal to zero (the TPU kernel leaves them undefined; its
callers mask them with ``row_mask``).
Rows of x past its end read as zero, so x may have num_nodes rows or
num_nodes rounded up to T.  The CUDA kernel (``csrc/tile_matmul.cu``, whose
header note gives its design and bound) gives each output row to one warp,
which reads the row of each of its row tile's tiles once, compacts the
nonzeros and gathers only their rows of x: the tiles are ~1% full, so it
does the nonzeros' work and not the dense product's.  A zero of ``vals`` is
skipped, never multiplied, so unlike the plain version's ``bmm`` it turns
no ``0 * inf`` into NaN (no caller feeds non-finite x).  Its wrapper
:func:`tile_matmul` launches it for CUDA tensors and uses
:func:`tile_matmul_reference` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["tile_matmul", "tile_matmul_reference"]

# Kernel launches since the count was last set to 0 (read by chip_smoke.py
# to show that the main path ran through the kernel): LAUNCHES for float32
# x, LAUNCHES_BF16 for bfloat16 x.
LAUNCHES = 0
LAUNCHES_BF16 = 0

_ENTRY = {torch.float32: "plnlp_tile_matmul_f32", torch.bfloat16: "plnlp_tile_matmul_bf16"}
_VALS_KIND = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p
]


def tile_matmul_reference(
    vals, tile_row, tile_col, x, n_rowtiles: int, out_rows: int
) -> torch.Tensor:
    """Plain PyTorch version: one ``bmm`` over the gathered x tiles, then
    ``index_add_`` of the products into their row tiles, in float32 with
    ``vals`` cast to x's dtype first; the result is rounded to x's dtype
    once (a no-op for float32 x)."""
    t = vals.shape[1]
    d = x.shape[1]
    n_pad = -(-x.shape[0] // t) * t
    if n_pad != x.shape[0]:
        x = torch.cat([x, x.new_zeros((n_pad - x.shape[0], d))])
    x_tiles = x.reshape(n_pad // t, t, d)
    part = torch.bmm(vals.to(x.dtype).float(), x_tiles[tile_col.long()].float())
    out = part.new_zeros((n_rowtiles, t, d)).index_add_(0, tile_row.long(), part)
    return out.reshape(n_rowtiles * t, d)[:out_rows].to(x.dtype)


def _check(vals, tile_row, tile_col, tile_rowptr, x, out_rows):
    for name, t in (("tile_row", tile_row), ("tile_col", tile_col), ("tile_rowptr", tile_rowptr),
                    ("vals", vals), ("x", x)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name.startswith("tile_") and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if vals.dtype not in _VALS_KIND:
        raise TypeError(f"vals must be int8, float32 or bfloat16, got {vals.dtype}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if vals.dim() != 3 or vals.shape[1] != vals.shape[2]:
        raise ValueError(f"vals must be (nt, T, T), got {tuple(vals.shape)}")
    if vals.shape[1] % 16:
        raise ValueError(f"the tile size must be a multiple of 16, got {vals.shape[1]}")
    if tile_row.shape != (vals.shape[0],) or tile_col.shape != (vals.shape[0],):
        raise ValueError("tile_row and tile_col must have one entry per tile")
    if x.dim() != 2:
        raise ValueError("x must be 2-D")
    if out_rows > (tile_rowptr.shape[0] - 1) * vals.shape[1]:
        raise ValueError(f"out_rows {out_rows} exceeds the row tiles of tile_rowptr")


def tile_matmul(
    vals: torch.Tensor,  # (nt, T, T) int8, float32 or bfloat16, sorted by row tile
    tile_row: torch.Tensor,  # (nt,) int32 row tile per tile, sorted
    tile_col: torch.Tensor,  # (nt,) int32 column tile per tile
    tile_rowptr: torch.Tensor,  # (n_rowtiles + 1,) int32 first tile per row tile
    x: torch.Tensor,  # (n_x, D) float32 or bfloat16
    out_rows: int,
) -> torch.Tensor:
    """Returns (out_rows, D) in x's dtype.  CUDA tensors launch the kernel
    of x's dtype on the current stream (never the other one, never through
    a cast); CPU tensors take :func:`tile_matmul_reference`."""
    global LAUNCHES, LAUNCHES_BF16
    _check(vals, tile_row, tile_col, tile_rowptr, x, out_rows)
    n_rowtiles = tile_rowptr.shape[0] - 1
    if x.device.type == "cpu":
        return tile_matmul_reference(vals, tile_row, tile_col, x, n_rowtiles, out_rows)
    if x.device.type != "cuda":
        raise ValueError(f"tile_matmul runs on cuda or cpu, not {x.device}")
    if vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")
    from plnlp_tpu_torch import _build

    lib = _build.load("tile_matmul")
    fn = getattr(lib, _ENTRY[x.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    d = x.shape[1]
    out = torch.empty((out_rows, d), dtype=x.dtype, device=x.device)
    if out_rows == 0 or d == 0:
        return out
    t = vals.shape[1]
    # 16 bytes of x's elements per vector load: 4 f32 or 8 bf16
    vec = d % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            vals.data_ptr(), _VALS_KIND[vals.dtype], tile_col.data_ptr(),
            tile_rowptr.data_ptr(), x.data_ptr(), out.data_ptr(),
            n_rowtiles, t, x.shape[0], out_rows, d, int(vec), stream,
        )
    _build.check(lib, err, f"tile_matmul launch ({vals.dtype} tiles, {x.dtype} x, T={t}, D={d})")
    if x.dtype == torch.bfloat16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return out
