"""A cell's inputs, made on the device from ``--seed``.

A frozen copy of the recipe of ``plnlp_tpu_torch/data/synthetic.py``
(endpoints drawn with probability proportional to rank^-alpha, the drawn
edges shuffled and split into train, valid and test, uniform evaluation
negatives, uniform weights in [0.5, 1.5), uniform years, standard-normal
node features), rewritten in PyTorch so that it runs on the card in a few
large calls.  Its counts come from the configuration's ``dataset`` section.
The same seed gives the same inputs on the same device.

Both layouts of the OGB split dict are made: ``hits`` ({edge, edge_neg},
as ogbl-collab) and ``mrr`` ({source_node, target_node, target_node_neg},
as ogbl-citation2).  Every array is a torch tensor on ``device``;
``to_numpy`` gives the host copy in the shape the port's loaders return.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# 64-bit seed space; a separate stream for each use of one seed
_MASK = 2**63 - 1


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for ``stream`` of ``seed``: the same pair
    gives the same draws; streams of one seed do not overlap in use."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def _power_law_endpoints(gen, num_nodes: int, count: int, alpha: float, device):
    ranks = torch.arange(1, num_nodes + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow(-alpha), 0)
    u = torch.rand(count, generator=gen, dtype=torch.float64, device=device) * cdf[-1]
    return torch.searchsorted(cdf, u, right=True).clamp_(max=num_nodes - 1)


def make(dataset: Dict, seed: int, device) -> Dict:
    """The split dict and its graph, on ``device``, drawn from ``seed``."""
    gen = generator(device, seed, 1)
    n = int(dataset["num_nodes"])
    n_train, n_valid, n_test = (int(dataset[k]) for k in ("num_train", "num_valid", "num_test"))
    total = n_train + n_valid + n_test
    # endpoints drawn in one call; self loops dropped as the recipe drops them
    draw = total + total // 50 + 1024
    ends = _power_law_endpoints(gen, n, 2 * draw, float(dataset["alpha"]), device)
    src, dst = ends[:draw], ends[draw:]
    keep = torch.nonzero(src != dst).squeeze(1)
    if keep.numel() < total:
        raise RuntimeError(f"{keep.numel()} edges without self loops, {total} needed")
    keep = keep[:total]
    order = torch.randperm(total, generator=gen, device=device)
    src, dst = src[keep][order], dst[keep][order]
    tr = torch.stack([src[:n_train], dst[:n_train]], 1)
    va = torch.stack([src[n_train:n_train + n_valid], dst[n_train:n_train + n_valid]], 1)
    te = torch.stack([src[n_train + n_valid:], dst[n_train + n_valid:]], 1)

    out = {"num_nodes": n, "layout": dataset["layout"], "node_feat": None}
    if dataset["layout"] == "mrr":
        k = int(dataset["neg_per_source"])
        out["split_edge"] = {
            "train": {"source_node": tr[:, 0], "target_node": tr[:, 1]},
            **{
                name: {
                    "source_node": e[:, 0],
                    "target_node": e[:, 1],
                    "target_node_neg": torch.randint(
                        0, n, (e.shape[0], k), generator=gen, device=device
                    ),
                }
                for name, e in (("valid", va), ("test", te))
            },
        }
    else:
        m = int(dataset["num_neg_eval"])
        out["split_edge"] = {
            "train": {"edge": tr},
            "valid": {"edge": va, "edge_neg": torch.randint(0, n, (m, 2), generator=gen, device=device)},
            "test": {"edge": te, "edge_neg": torch.randint(0, n, (m, 2), generator=gen, device=device)},
        }
        if dataset.get("weighted"):
            out["split_edge"]["train"]["weight"] = (
                torch.rand(n_train, generator=gen, device=device) + 0.5
            )
        if dataset.get("years"):
            lo, hi = dataset["years"]
            out["split_edge"]["train"]["year"] = torch.randint(
                lo, hi + 1, (n_train,), generator=gen, device=device
            )
    if dataset.get("node_feats"):
        out["node_feat"] = torch.randn(
            (n, int(dataset["node_feats"])), generator=gen, device=device
        )
    return out


def to_numpy(inputs: Dict, directed: bool) -> Dict:
    """The host copy in the port's dataset-dict shape (``data/``'s loaders):
    ``num_nodes``, ``node_feat``, ``edge_index`` (the train edges as drawn),
    ``edge_weight``, ``split_edge``, ``directed``."""
    split = {
        name: {k: v.cpu().numpy() for k, v in part.items()}
        for name, part in inputs["split_edge"].items()
    }
    tr = split["train"]
    if "edge" in tr:
        edge_index = tr["edge"].T.copy()
    else:
        edge_index = np.stack([tr["source_node"], tr["target_node"]])
    return {
        "name": f"h100_bench-{inputs['layout']}",
        "num_nodes": inputs["num_nodes"],
        "node_feat": None,  # stays on the device: the model reads it there
        "edge_index": edge_index,
        "edge_weight": tr.get("weight"),
        "split_edge": split,
        "eval_metric": inputs["layout"],
        "directed": directed,
    }


def stream_seed(seed: int, stream: int) -> int:
    """The integer seed of ``stream`` of ``seed`` (what ``generator`` uses)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9) & _MASK


def weights(shapes, seed: int, device) -> Dict:
    """Parameters by name, drawn on ``device`` in one call each: uniform in
    +-sqrt(6 / (fan_in + fan_out)) for a matrix (xavier), +-1/sqrt(n) for a
    vector of n."""
    gen = generator(device, seed, 2)
    out = {}
    for name, shape in shapes:
        bound = (6.0 / (shape[0] + shape[1])) ** 0.5 if len(shape) == 2 else shape[0] ** -0.5
        out[name] = torch.empty(shape, device=device).uniform_(-bound, bound, generator=gen)
    return out
