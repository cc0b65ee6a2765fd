"""Dataset loading (port of plnlp_tpu/data): synthetic generators, the
``.npz`` format for user graphs and the OGB directory reader."""

from plnlp_tpu_torch.data.custom import (
    export_npz_dataset,
    load_npz_dataset,
    save_npz_dataset,
)
from plnlp_tpu_torch.data.ogb import load_ogb_dataset
from plnlp_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = [
    "load_ogb_dataset",
    "make_synthetic_dataset",
    "load_npz_dataset",
    "save_npz_dataset",
    "export_npz_dataset",
    "load_dataset",
]


def load_dataset(name: str, root: str = "dataset"):
    """Dispatch: ``synthetic:<kind>[:k=v,...]`` specs, ``npz:<path>``
    user-supplied files (see ``data/custom.py``), or an OGB dataset dir.

    Spec examples: ``synthetic:hits``, ``synthetic:mrr``,
    ``synthetic:hits:num_nodes=50000,num_edges=500000,seed=1``,
    ``npz:/data/mygraph.npz``.
    """
    if name.startswith("npz:"):
        return load_npz_dataset(name[len("npz:"):])
    if name.endswith(".npz"):
        return load_npz_dataset(name)
    if name.startswith("synthetic"):
        parts = name.split(":")
        kind = parts[1] if len(parts) > 1 and parts[1] else "hits"
        kwargs = {}
        if len(parts) > 2 and parts[2]:
            for kv in parts[2].split(","):
                k, _, v = kv.partition("=")
                kwargs[k.strip()] = int(v)
        return make_synthetic_dataset(kind, **kwargs)
    return load_ogb_dataset(name, root)
