"""ctypes bindings for the native host library ``csrc/graphcore.cpp``.

The one-time host preprocessing (coalesce, blocking, densify, the
label-propagation and BFS reorders) in C++ with OpenMP.  Each function
gives the bits of the NumPy version it replaces, which stays in the port as
the plain version (``graph._coalesce_plain``, ``graph._blocks_plain``,
``dense._dense_plain``, ``ops/tile_spmm._label_prop_plain``,
``parallel/partition._bfs_order_plain``).

The library is built at first use with ``g++ -O3 -march=native -fopenmp``
into ``build/plnlp_tpu_torch/libgraphcore-<hash>.so`` under the repository
root; the hash covers the source, the flags and the instruction set the
compiler resolves ``-march=native`` to, so a library built for another CPU
is never loaded.  Without ``g++`` the callers run the NumPy versions (one
warning says so, and :func:`available` is False); a build that fails with
``g++`` present raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "get_lib",
    "available",
    "coalesce_add",
    "build_indptr",
    "densify",
    "blocks_build",
    "label_prop",
    "bfs_order",
]

SRC = Path(__file__).resolve().parent / "csrc" / "graphcore.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "plnlp_tpu_torch"
FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _target(gxx: str) -> Path:
    # what -march=native means on this host (the cc1 line lists it)
    probe = subprocess.run(
        [gxx, "-march=native", "-E", "-v", "-x", "c++", os.devnull],
        capture_output=True, text=True, timeout=60,
    )
    arch = [line for line in probe.stderr.splitlines() if "cc1" in line]
    digest = hashlib.sha1(SRC.read_bytes())
    digest.update(" ".join(FLAGS + arch).encode())
    return BUILD_DIR / f"libgraphcore-{digest.hexdigest()[:12]}.so"


def _build(gxx: str) -> Path:
    target = _target(gxx)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one process builds; the others started with it (test workers, ranks)
    # wait for the lock and load its library
    with open(BUILD_DIR / "graphcore.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return target
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run(
            [gxx, *FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True, timeout=300
        )
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{r.stderr}")
        os.replace(tmp, target)  # atomic: a reader never sees a partial file
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.coalesce_add.restype = i64
    lib.coalesce_add.argtypes = [_I64, _I64, vp, i64, i64, _I64, _I64, _F32]
    lib.build_indptr.restype = None
    lib.build_indptr.argtypes = [_I64, i64, i64, _I32]
    lib.densify.restype = None
    lib.densify.argtypes = [_I64, _I64, vp, i64, i64, _F32, _I32]
    lib.blocks_count.restype = i64
    lib.blocks_count.argtypes = [_I32, i64, i64, i64]
    lib.blocks_fill.restype = None
    lib.blocks_fill.argtypes = [_I64, _I64, vp, _I32, i64, i64, i64, _I32, _F32, _I32, _I32]
    lib.label_prop.restype = i64
    lib.label_prop.argtypes = [_I32, _I32, i64, i64, _I64]
    lib.bfs_order.restype = None
    lib.bfs_order.argtypes = [_I32, _I32, i64, _I64, _I64]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None when there is no
    ``g++`` (warned once)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        gxx = shutil.which("g++")
        if gxx is None:
            warnings.warn(
                "g++ not found: host preprocessing runs the NumPy versions of "
                "csrc/graphcore.cpp (slower, same results)",
                stacklevel=3,
            )
            return None
        _lib = _bind(ctypes.CDLL(str(_build(gxx))))
        return _lib


def available() -> bool:
    """Whether the native library runs (False: the NumPy versions do)."""
    return get_lib() is not None


def _need() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native graphcore library is not available (no g++)")
    return lib


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def coalesce_add(
    src: np.ndarray, dst: np.ndarray, w: Optional[np.ndarray], num_nodes: int
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Edges sorted by (dst, src) with duplicates merged, weights summed in
    float64 in input order and rounded to float32 once; the weight is None
    when ``w`` is."""
    lib = _need()
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    wd = None if w is None else np.ascontiguousarray(w, np.float64)
    e = len(src)
    out_src = np.empty(e, np.int64)
    out_dst = np.empty(e, np.int64)
    out_w = np.empty(e, np.float32)
    m = lib.coalesce_add(src, dst, _ptr(wd), e, num_nodes, out_src, out_dst, out_w)
    return out_src[:m].copy(), out_dst[:m].copy(), None if w is None else out_w[:m].copy()


def build_indptr(dst_sorted: np.ndarray, num_nodes: int) -> np.ndarray:
    """int32 CSR row pointers over ascending destinations."""
    lib = _need()
    dst_sorted = np.ascontiguousarray(dst_sorted, np.int64)
    indptr = np.empty(num_nodes + 1, np.int32)
    lib.build_indptr(dst_sorted, len(dst_sorted), num_nodes, indptr)
    return indptr


def densify(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(adj (N, N) float32, in-degrees int32) from edges sorted by dst;
    each cell summed in float64 and rounded once."""
    lib = _need()
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    if len(dst) > 1 and (np.diff(dst) < 0).any():
        raise ValueError("densify needs edges sorted by destination")
    w = np.ascontiguousarray(w, np.float32)
    a = np.zeros((num_nodes, num_nodes), np.float32)
    deg = np.zeros(num_nodes, np.int32)
    lib.densify(src, dst, _ptr(w), len(src), num_nodes, a, deg)
    return a, deg


def blocks_build(
    senders: np.ndarray,
    receivers: np.ndarray,
    w: np.ndarray,
    indptr: np.ndarray,
    num_nodes: int,
    R: int,
    B: int,
) -> dict:
    """The blocked metadata of ``graph._blocks_plain`` (edges sorted by
    dst), in the port's layout: no residue pad, with ``blk_rowptr``."""
    lib = _need()
    senders = np.ascontiguousarray(senders, np.int64)
    receivers = np.ascontiguousarray(receivers, np.int64)
    w = np.ascontiguousarray(w, np.float32)
    indptr = np.ascontiguousarray(indptr, np.int32)
    nblk = int(lib.blocks_count(indptr, num_nodes, R, B))
    blk_src = np.zeros(nblk * B, np.int32)
    blk_w = np.zeros(nblk * B, np.float32)
    blk_local = np.zeros(nblk * B, np.int32)
    blk_rowblock = np.zeros(nblk, np.int32)
    lib.blocks_fill(
        senders, receivers, _ptr(w), indptr, num_nodes, R, B,
        blk_src, blk_w, blk_local, blk_rowblock,
    )
    n_rowblocks = -(-num_nodes // R)
    bounds = indptr.astype(np.int64)[np.minimum(np.arange(n_rowblocks + 1) * R, num_nodes)]
    nbs = np.maximum((np.diff(bounds) + B - 1) // B, 1)
    return {
        "blk_src": blk_src.reshape(nblk, B),
        "blk_weight": blk_w.reshape(nblk, B),
        "blk_local": blk_local.reshape(nblk, B),
        "blk_rowblock": blk_rowblock,
        "blk_rowptr": np.concatenate([[0], np.cumsum(nbs)]).astype(np.int32),
        "block_rows": R,
        "block_edges": B,
    }


def label_prop(
    indptr: np.ndarray, indices: np.ndarray, num_nodes: int, rounds: int
) -> np.ndarray:
    """Final labels of synchronous label propagation over an undirected
    CSR (mode of the neighbor labels, ties to the smallest; stops at a
    fixed point)."""
    lib = _need()
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    labels = np.arange(num_nodes, dtype=np.int64)
    lib.label_prop(indptr, indices, num_nodes, rounds, labels)
    return labels


def bfs_order(
    indptr: np.ndarray, indices: np.ndarray, num_nodes: int, seeds: np.ndarray
) -> np.ndarray:
    """Level-synchronous BFS order over an undirected CSR (each level the
    sorted unique unvisited neighbors; components seeded in ``seeds``'
    order)."""
    lib = _need()
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    seeds = np.ascontiguousarray(seeds, np.int64)
    order = np.empty(num_nodes, np.int64)
    lib.bfs_order(indptr, indices, num_nodes, seeds, order)
    return order
