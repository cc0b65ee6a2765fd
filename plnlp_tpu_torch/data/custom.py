"""User-supplied link-prediction datasets in a single ``.npz`` file (port
of plnlp_tpu/data/custom.py; the same file format).

The reference is hard-wired to OGB's ``PygLinkPropPredDataset``
(reference main.py:74-95) — there is no way to train it on a graph that
is not one of the published OGB downloads.  Production deployments have
their own graphs, so this module defines a portable one-file format and
the save/load pair around it; ``load_dataset`` (and therefore the CLI)
accepts ``npz:<path>`` anywhere an OGB name is accepted::

    save_npz_dataset("mygraph.npz", num_nodes=n, split_edge=splits)
    # then:  python -m plnlp_tpu_torch --data_name npz:mygraph.npz --eval_metric hits ...

File layout (all arrays NumPy, nothing torch-pickled — unlike OGB's
``.pt`` split files this is safe to load from untrusted sources):

* ``split/<split>/<field>`` — the split dicts, flattened by key.  Hits
  layout: ``train/edge`` (T,2), ``valid/edge``, ``valid/edge_neg``,
  ``test/edge``, ``test/edge_neg`` (reference utils.py:7-27).  MRR
  layout: ``source_node``/``target_node``/``target_node_neg`` per split
  (reference utils.py:28-41).  Extra fields (``weight``, ``year``) pass
  through untouched, so the collab-style year filter and
  val-edges-as-input surgery work on custom data too.
* ``edge_index`` (2, E) — message-passing adjacency.  Optional: derived
  from the train split when absent (the OGB convention for ddi/collab).
* ``num_nodes`` scalar; optional (max node id + 1 when absent).
* ``node_feat`` (N, F) float, ``edge_weight`` (E,), ``edge_year`` (E,)
  — optional, same meaning as the OGB raw files.
* ``eval_metric`` (str), ``directed`` (bool) — optional metadata;
  ``directed=True`` symmetrizes the adjacency in dataset surgery
  exactly like citation2 (reference main.py:109-110).

NOTE: the CLI's ``--eval_metric`` flag defaults to ``'hits'`` (reference
flag parity), so an ``mrr`` dataset must still be run with
``--eval_metric mrr`` — the stored metadata does not override an
explicit-or-default flag value; the CLI warns loudly on a mismatch.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

__all__ = ["save_npz_dataset", "load_npz_dataset", "export_npz_dataset"]

_SPLITS = ("train", "valid", "test")

# Split fields that hold node ids — validated against num_nodes at save
# time, so a bad negative pool fails when the file is written, not later
# as an index error (or, in the JAX package, a silently clipped gather).
_ID_FIELDS = ("edge", "edge_neg", "source_node", "target_node", "target_node_neg")


def _validate_ids(split: str, field: str, v: np.ndarray, num_nodes: int):
    """Check an id-bearing split array and return it cast to int64."""
    if not np.issubdtype(np.asarray(v).dtype, np.integer):
        raise ValueError(
            f"split_edge['{split}']['{field}'] must hold integer node ids, "
            f"got dtype {np.asarray(v).dtype}"
        )
    v = np.asarray(v, np.int64)
    if v.size:
        lo, hi = int(v.min()), int(v.max())
        if lo < 0 or hi >= num_nodes:
            raise ValueError(
                f"split_edge['{split}']['{field}'] references node ids in "
                f"[{lo}, {hi}] outside [0, num_nodes={num_nodes})"
            )
    return v


def _require(split_edge: Dict, split: str, field: str):
    if field not in split_edge.get(split, {}):
        raise ValueError(
            f"split_edge['{split}'] is missing '{field}' — hits datasets "
            f"need edge/edge_neg per eval split, mrr datasets need "
            f"source_node/target_node/target_node_neg (reference "
            f"utils.py:7-41)"
        )


def save_npz_dataset(
    path: str,
    *,
    num_nodes: int,
    split_edge: Dict[str, Dict[str, np.ndarray]],
    edge_index: Optional[np.ndarray] = None,
    node_feat: Optional[np.ndarray] = None,
    edge_weight: Optional[np.ndarray] = None,
    edge_year: Optional[np.ndarray] = None,
    eval_metric: str = "hits",
    directed: bool = False,
) -> str:
    """Validate and write a dataset ``.npz``; returns ``path``.

    ``split_edge`` uses the OGB split-dict shapes the rest of the
    pipeline already understands (both the hits and the mrr layout).
    When ``edge_index`` is omitted it is derived from the train split —
    the OGB convention where raw/edge.csv IS the train edge list.
    """
    if eval_metric not in ("hits", "mrr"):
        raise ValueError(f"eval_metric must be 'hits' or 'mrr', got {eval_metric!r}")
    mrr = eval_metric == "mrr"
    if mrr:
        for s in _SPLITS:
            _require(split_edge, s, "source_node")
            _require(split_edge, s, "target_node")
            if s != "train":
                _require(split_edge, s, "target_node_neg")
    else:
        for s in _SPLITS:
            _require(split_edge, s, "edge")
            if s != "train":
                _require(split_edge, s, "edge_neg")

    if edge_index is None:
        tr = split_edge["train"]
        if mrr:
            edge_index = np.stack(
                [np.asarray(tr["source_node"]), np.asarray(tr["target_node"])]
            )
        else:
            edge_index = np.asarray(tr["edge"]).T
    edge_index = np.asarray(edge_index, np.int64)
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f"edge_index must be (2, E), got {edge_index.shape}")
    if edge_index.size and int(edge_index.max()) >= num_nodes:
        raise ValueError(
            f"edge_index references node {int(edge_index.max())} but "
            f"num_nodes={num_nodes}"
        )

    arrays: Dict[str, np.ndarray] = {
        "num_nodes": np.int64(num_nodes),
        "edge_index": edge_index,
        "eval_metric": np.str_(eval_metric),
        "directed": np.bool_(directed),
    }
    if node_feat is not None:
        arrays["node_feat"] = np.asarray(node_feat, np.float32)
    if edge_weight is not None:
        arrays["edge_weight"] = np.asarray(edge_weight, np.float32).reshape(-1)
    if edge_year is not None:
        arrays["edge_year"] = np.asarray(edge_year, np.int64).reshape(-1)
    for s, fields in split_edge.items():
        for f, v in fields.items():
            v = np.asarray(v)
            if f in _ID_FIELDS:
                v = _validate_ids(s, f, v, num_nodes)
            arrays[f"split/{s}/{f}"] = v
    np.savez_compressed(path, **arrays)
    return path


def export_npz_dataset(ds: Dict, path: str) -> str:
    """Convert any loaded dataset dict (``load_ogb_dataset``,
    ``make_synthetic_dataset``, ...) into one ``.npz`` file.

    Useful for shipping OGB data to production pods as a single
    torch-pickle-free artifact: the OGB layout's ``split/*.pt`` files
    require ``torch.load(weights_only=False)`` — arbitrary code execution
    on untrusted files — while the ``.npz`` holds plain arrays only.
    """
    return save_npz_dataset(
        path,
        num_nodes=int(ds["num_nodes"]),
        split_edge=ds["split_edge"],
        edge_index=ds["edge_index"],
        node_feat=ds.get("node_feat"),
        edge_weight=ds.get("edge_weight"),
        edge_year=ds.get("edge_year"),
        eval_metric=ds.get("eval_metric", "hits"),
        directed=bool(ds.get("directed", False)),
    )


def load_npz_dataset(path: str) -> Dict:
    """Read an ``.npz`` written by :func:`save_npz_dataset` into the
    standard dataset dict (same contract as ``load_ogb_dataset``)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"custom dataset file not found: {path}")
    with np.load(path, allow_pickle=False) as z:
        split_edge: Dict[str, Dict[str, np.ndarray]] = {}
        out: Dict = {
            "name": f"npz:{os.path.basename(path)}",
            "node_feat": None,
            "edge_weight": None,
            "edge_year": None,
            "split_edge": split_edge,
            "eval_metric": "hits",
            "directed": False,
        }
        for key in z.files:
            if key.startswith("split/"):
                _, s, f = key.split("/", 2)
                split_edge.setdefault(s, {})[f] = z[key]
            elif key == "num_nodes":
                out["num_nodes"] = int(z[key])
            elif key == "eval_metric":
                out["eval_metric"] = str(z[key])
            elif key == "directed":
                out["directed"] = bool(z[key])
            else:  # edge_index / node_feat / edge_weight / edge_year
                out[key] = z[key]
    if "edge_index" not in out:
        raise ValueError(f"{path} has no edge_index — not a dataset file?")
    if "num_nodes" not in out:
        out["num_nodes"] = int(out["edge_index"].max()) + 1 if out[
            "edge_index"
        ].size else 0
    return out


def _main(argv=None):  # python -m plnlp_tpu_torch.data.custom <data_name> <out.npz>
    """Operator one-liner: convert any --data_name spec (OGB dir name,
    synthetic:* spec) into a portable .npz, e.g.

        python -m plnlp_tpu_torch.data.custom ogbl-collab collab.npz --root dataset
    """
    import argparse

    from plnlp_tpu_torch.data import load_dataset

    p = argparse.ArgumentParser(
        prog="plnlp_tpu_torch.data.custom",
        description="Convert a dataset spec into one portable .npz file",
    )
    p.add_argument("data_name", help="OGB name, synthetic:* spec, or npz:<path>")
    p.add_argument("out", help="output .npz path")
    p.add_argument("--root", default="dataset", help="OGB data root dir")
    a = p.parse_args(argv)
    ds = load_dataset(a.data_name, a.root)
    out = export_npz_dataset(ds, a.out)
    print(
        f"wrote {out}: num_nodes={ds['num_nodes']} "
        f"edges={ds['edge_index'].shape[1]} metric={ds['eval_metric']}"
    )
    return out


if __name__ == "__main__":  # pragma: no cover — exercised via subprocess test
    _main()
