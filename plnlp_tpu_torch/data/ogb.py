"""Loader for on-disk OGB link-prediction datasets (port of
plnlp_tpu/data/ogb.py).

Replaces ogb.linkproppred.PygLinkPropPredDataset + get_edge_split (reference
main.py:74,95) by reading the published OGB directory layout directly:

    <root>/<ogbl_name>/
        raw/edge.csv.gz                 (E rows: "src,dst")
        raw/num-node-list.csv.gz        (single integer)
        raw/node-feat.csv.gz            (optional, N rows of floats)
        raw/edge_weight.csv.gz          (optional)
        raw/edge_year.csv.gz            (optional)
        split/<split_type>/{train,valid,test}.pt   (torch-pickled dicts)

The ``.pt`` split files are read by a restricted reader
(``_load_pt_without_torch``): torch.save archives of plain tensors are
rebuilt as NumPy arrays straight from the zip, with every other pickle
constructor blocked — no arbitrary-code-execution surface, and torch is
not imported for it.  torch.load(weights_only=True) is the fallback for
exotic archives; the unsafe weights_only=False path never runs unless the
user opts in with PLNLP_UNSAFE_PT_LOAD=1 (it executes code embedded in the
pickle).  There is NO download path — OGB data must already be on
disk (zero-egress environment); otherwise use ``synthetic:*`` datasets.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Optional

import numpy as np

__all__ = ["load_ogb_dataset"]

_METRIC = {
    "ogbl-ddi": "hits",
    "ogbl-collab": "hits",
    "ogbl-ppa": "hits",
    "ogbl-citation2": "mrr",
    "ogbl-wikikg2": "mrr",
}

_DIRECTED = {"ogbl-citation2", "ogbl-wikikg2"}


def _read_csv_gz(path: str, dtype) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    try:
        # pandas parses citation2's 30M-row edge file in seconds where
        # np.loadtxt takes minutes.
        import pandas as pd

        return pd.read_csv(path, header=None, dtype=dtype).to_numpy()
    except ImportError:
        with gzip.open(path, "rt") as f:
            return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def _to_numpy(obj):
    """Recursively convert torch tensors inside split dicts to numpy."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


# --- torch-free .pt reader -------------------------------------------------
#
# OGB split files are torch.save archives (zip with data.pkl + one raw file
# per storage) holding plain int64/float tensors in dicts.  Unpickling them
# with torch.load(weights_only=False) executes arbitrary code from the file;
# this restricted reader rebuilds the tensors as NumPy arrays directly from
# the zip, allowing ONLY the handful of constructors a tensor archive needs.

_STORAGE_DTYPES = {
    "DoubleStorage": np.float64,
    "FloatStorage": np.float32,
    "HalfStorage": np.float16,
    "BFloat16Storage": None,  # no numpy dtype; rejected below
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}


class _StorageTag:
    """Stand-in for torch.<T>Storage classes during restricted unpickling."""

    def __init__(self, dtype):
        self.dtype = dtype


def _rebuild_tensor_v2(
    storage, storage_offset, size, stride, requires_grad, backward_hooks,
    metadata=None,
):
    """NumPy twin of torch._utils._rebuild_tensor_v2: view the flat storage
    at (offset, size, stride) in ELEMENTS, then copy to a contiguous array.

    shape/stride/offset come straight from the (untrusted) pickle, and
    as_strided performs NO bounds checking — every element the view can
    touch is validated against the storage length first, else a crafted
    file reads arbitrary process memory."""
    import pickle

    storage_offset = int(storage_offset)
    size = tuple(int(s) for s in size)
    stride = tuple(int(s) for s in stride)
    if (
        storage_offset < 0
        or len(stride) != len(size)
        or any(s < 0 for s in size)
        or any(st < 0 for st in stride)
    ):
        raise pickle.UnpicklingError(
            f"tensor metadata out of bounds: offset={storage_offset} "
            f"size={size} stride={stride}"
        )
    if not size:
        if storage_offset >= len(storage):
            raise pickle.UnpicklingError(
                f"scalar offset {storage_offset} beyond storage "
                f"({len(storage)} elements)"
            )
        return storage[storage_offset].copy()
    if any(s == 0 for s in size):
        return np.empty(size, dtype=storage.dtype)
    last = storage_offset + sum((s - 1) * st for s, st in zip(size, stride))
    if last >= len(storage):
        raise pickle.UnpicklingError(
            f"tensor view reaches element {last} of a {len(storage)}-element "
            f"storage (offset={storage_offset} size={size} stride={stride})"
        )
    itemsize = storage.dtype.itemsize
    view = np.lib.stride_tricks.as_strided(
        storage[storage_offset:],
        shape=size,
        strides=tuple(s * itemsize for s in stride),
    )
    return np.ascontiguousarray(view)


def _load_pt_without_torch(path: str):
    """Read a torch.save zip archive of plain tensors into NumPy without
    importing torch and without executing pickled code.  Raises
    pickle.UnpicklingError on anything beyond dict/list/tensor content."""
    import pickle
    import zipfile

    _ALLOWED = {
        ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
        ("collections", "OrderedDict"): dict,
    }

    with zipfile.ZipFile(path) as zf:
        pkl_name = next(
            n for n in zf.namelist() if n.split("/")[-1] == "data.pkl"
        )
        prefix = pkl_name[: -len("data.pkl")]

        class _Restricted(pickle.Unpickler):
            def find_class(self, module, name):
                if (module, name) in _ALLOWED:
                    return _ALLOWED[(module, name)]
                if module == "torch" and name in _STORAGE_DTYPES:
                    dt = _STORAGE_DTYPES[name]
                    if dt is None:
                        raise pickle.UnpicklingError(
                            f"unsupported storage dtype {name}"
                        )
                    return _StorageTag(dt)
                raise pickle.UnpicklingError(
                    f"blocked unpickle of {module}.{name} — OGB split "
                    f"files contain only plain tensors; refusing "
                    f"arbitrary constructors"
                )

            def persistent_load(self, pid):
                # ('storage', <storage tag>, key, location, numel)
                if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
                    raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
                tag, key, _location, numel = pid[1], pid[2], pid[3], pid[4]
                if not isinstance(tag, _StorageTag):
                    raise pickle.UnpicklingError(
                        f"unexpected storage type {tag!r}"
                    )
                raw = zf.read(f"{prefix}data/{key}")
                numel = int(numel)
                if numel < 0 or len(raw) < numel * np.dtype(tag.dtype).itemsize:
                    raise pickle.UnpicklingError(
                        f"storage '{key}' claims {numel} elements but the "
                        f"archive member holds {len(raw)} bytes"
                    )
                return np.frombuffer(raw, dtype=tag.dtype)[:numel]

        with zf.open(pkl_name) as f:
            return _Restricted(f).load()


def _load_split_file(path: str):
    """Torch-free reader first; torch.load(weights_only=True) as the safe
    fallback.  The unsafe weights_only=False path (arbitrary code execution
    on untrusted files) is REFUSED unless PLNLP_UNSAFE_PT_LOAD=1 — and even
    then it warns loudly."""
    try:
        return _load_pt_without_torch(path)
    except FileNotFoundError:
        raise  # not a parse problem — don't hide it behind torch fallbacks
    except Exception as e:
        torch_free_err = e
    import warnings

    import torch

    try:
        return _to_numpy(torch.load(path, map_location="cpu", weights_only=True))
    except Exception as safe_err:
        # weights_only=False executes arbitrary code embedded in the pickle.
        # Never run it implicitly: an attacker only needs to craft a file
        # both safe readers reject to reach it.  Explicit opt-in only.
        if os.environ.get("PLNLP_UNSAFE_PT_LOAD") != "1":
            raise RuntimeError(
                f"{path}: torch-free reader failed ({torch_free_err!r}) and "
                f"torch.load(weights_only=True) rejected the file "
                f"({safe_err!r}). Refusing weights_only=False, which would "
                f"EXECUTE code embedded in the pickle. If you trust this "
                f"file, set PLNLP_UNSAFE_PT_LOAD=1 to allow it."
            ) from safe_err
        warnings.warn(
            f"{path}: both safe readers rejected the file; "
            f"PLNLP_UNSAFE_PT_LOAD=1 is set, loading with "
            f"weights_only=False — this EXECUTES code embedded in the pickle",
            stacklevel=2,
        )
        return _to_numpy(
            torch.load(path, map_location="cpu", weights_only=False)
        )


def _load_split(split_dir: str) -> Dict:
    out = {}
    for name in ("train", "valid", "test"):
        path = os.path.join(split_dir, f"{name}.pt")
        out[name] = _load_split_file(path)
    return out


def load_ogb_dataset(name: str, root: str = "dataset") -> Dict:
    dir_name = name.replace("-", "_")
    base = os.path.join(root, dir_name)
    if not os.path.isdir(base):
        raise FileNotFoundError(
            f"OGB dataset directory not found: {base}. This environment has "
            f"no network access — place the extracted OGB dataset there, or "
            f"use a synthetic dataset (--data_name synthetic:hits)."
        )
    raw = os.path.join(base, "raw")
    edge = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64)
    if edge is None:
        raise FileNotFoundError(f"missing {raw}/edge.csv.gz")
    edge_index = edge.T  # (2, E)
    nn_list = _read_csv_gz(os.path.join(raw, "num-node-list.csv.gz"), np.int64)
    num_nodes = int(nn_list.ravel()[0]) if nn_list is not None else int(edge.max()) + 1
    node_feat = _read_csv_gz(os.path.join(raw, "node-feat.csv.gz"), np.float32)
    ew = _read_csv_gz(os.path.join(raw, "edge_weight.csv.gz"), np.float32)
    edge_weight = ew.ravel().astype(np.float32) if ew is not None else None
    ey = _read_csv_gz(os.path.join(raw, "edge_year.csv.gz"), np.int64)
    edge_year = ey.ravel() if ey is not None else None

    split_root = os.path.join(base, "split")
    # sorted: os.listdir order is filesystem-dependent; a directory with
    # more than one split type must resolve identically on every machine.
    split_types = (
        sorted(os.listdir(split_root)) if os.path.isdir(split_root) else []
    )
    if not split_types:
        raise FileNotFoundError(f"missing split dir under {base}")
    split_edge = _load_split(os.path.join(split_root, split_types[0]))

    return {
        "name": name,
        "num_nodes": num_nodes,
        "node_feat": node_feat,
        "edge_index": edge_index,
        "edge_weight": edge_weight,
        "edge_year": edge_year,
        "split_edge": split_edge,
        "eval_metric": _METRIC.get(name, "hits"),
        "directed": name in _DIRECTED,
    }
