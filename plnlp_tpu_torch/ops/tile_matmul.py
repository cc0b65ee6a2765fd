"""Block-sparse dense-tile matmul: the CUDA kernel and its plain version.

Replaces the TPU kernel ``plnlp_tpu/ops/pallas_tiles.py::_kernel``.  With
``vals`` (nt, T, T) sorted by row tile and x cut into (T, D) tiles:

    out[tile_row[i]] += vals[i] @ x_tiles[tile_col[i]]

accumulated in f32, with row tiles that no tile reaches equal to zero (the
TPU kernel leaves them undefined; its callers mask them with ``row_mask``).
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
# to show that the main path ran through the kernel).
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p
]


def tile_matmul_reference(
    vals, tile_row, tile_col, x, n_rowtiles: int, out_rows: int
) -> torch.Tensor:
    """Plain PyTorch version: one ``bmm`` over the gathered x tiles, then
    ``index_add_`` of the products into their row tiles."""
    t = vals.shape[1]
    d = x.shape[1]
    n_pad = -(-x.shape[0] // t) * t
    if n_pad != x.shape[0]:
        x = torch.cat([x, x.new_zeros((n_pad - x.shape[0], d))])
    x_tiles = x.reshape(n_pad // t, t, d)
    part = torch.bmm(vals.to(x.dtype), x_tiles[tile_col.long()])
    out = x.new_zeros((n_rowtiles, t, d)).index_add_(0, tile_row.long(), part)
    return out.reshape(n_rowtiles * t, d)[:out_rows]


def _check(vals, tile_row, tile_col, tile_rowptr, x, out_rows):
    for name, t in (("tile_row", tile_row), ("tile_col", tile_col), ("tile_rowptr", tile_rowptr),
                    ("vals", vals), ("x", x)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name.startswith("tile_") and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if vals.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"vals must be int8 or float32, got {vals.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
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
    vals: torch.Tensor,  # (nt, T, T) int8 or float32, sorted by row tile
    tile_row: torch.Tensor,  # (nt,) int32 row tile per tile, sorted
    tile_col: torch.Tensor,  # (nt,) int32 column tile per tile
    tile_rowptr: torch.Tensor,  # (n_rowtiles + 1,) int32 first tile per row tile
    x: torch.Tensor,  # (n_x, D) float32
    out_rows: int,
) -> torch.Tensor:
    """Returns (out_rows, D).  CUDA tensors launch the kernel on the current
    stream; CPU tensors take :func:`tile_matmul_reference`."""
    global LAUNCHES
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
    fn = lib.plnlp_tile_matmul_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    d = x.shape[1]
    out = torch.empty((out_rows, d), dtype=torch.float32, device=x.device)
    if out_rows == 0 or d == 0:
        return out
    t = vals.shape[1]
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            vals.data_ptr(), int(vals.dtype == torch.int8), tile_col.data_ptr(),
            tile_rowptr.data_ptr(), x.data_ptr(), out.data_ptr(),
            n_rowtiles, t, x.shape[0], out_rows, d, int(vec), stream,
        )
    _build.check(lib, err, f"tile_matmul launch (T={t}, D={d})")
    LAUNCHES += 1
    return out
