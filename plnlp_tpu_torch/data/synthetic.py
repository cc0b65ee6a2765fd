"""Synthetic link-prediction datasets in the OGB split-dict shape.

Used by tests and benchmarks (no network access on the build machines, so the
real OGB downloads may be absent).  Mirrors both OGB split formats that the
reference handles (plnlp/utils.py:7-41):

* ``hits``  — {'edge', 'edge_neg'} splits (like ogbl-ddi / ogbl-collab)
* ``mrr``   — {'source_node', 'target_node', 'target_node_neg'} splits
              (like ogbl-citation2; negatives per source)

Graphs are drawn from a degree-skewed configuration model so SpMM load
imbalance resembles real power-law graphs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["make_synthetic_dataset", "make_skewed_graph"]


def make_skewed_graph(
    rng: np.random.Generator, num_nodes: int, num_edges: int, alpha: float = 0.8
):
    """Edge list with power-law-ish degree skew (endpoint prob ∝ rank^-α)."""
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    p = ranks**-alpha
    p /= p.sum()
    src = rng.choice(num_nodes, size=num_edges, p=p)
    dst = rng.choice(num_nodes, size=num_edges, p=p)
    keep = src != dst
    return src[keep], dst[keep]


def make_sbm_graph(
    rng: np.random.Generator,
    num_nodes: int,
    num_edges: int,
    num_communities: int = 50,
    inter_frac: float = 0.05,
):
    """Stochastic-block-model edge list: most edges intra-community.

    Unlike a pure random graph (where held-out edges are statistically
    indistinguishable from sampled negatives, so eval hits decay as the
    model memorizes), SBM link structure is LEARNABLE — embeddings that
    cluster by community generalize to the held-out split.  Use for
    meaningful accuracy trajectories on synthetic data.
    """
    comm = rng.integers(0, num_communities, num_nodes)
    members = [np.nonzero(comm == c)[0] for c in range(num_communities)]
    sizes = np.array([len(m) for m in members], dtype=np.float64)
    # communities drawn ∝ size² (pair count) for intra edges
    p = np.where(sizes > 1, sizes**2, 0.0)
    p /= p.sum()
    n_intra = int(num_edges * (1 - inter_frac))
    cs = rng.choice(num_communities, size=n_intra, p=p)
    src = np.empty(num_edges, np.int64)
    dst = np.empty(num_edges, np.int64)
    for c in range(num_communities):
        sel = np.nonzero(cs == c)[0]
        if len(sel) == 0:
            continue
        m = members[c]
        src[sel] = m[rng.integers(0, len(m), len(sel))]
        dst[sel] = m[rng.integers(0, len(m), len(sel))]
    n_inter = num_edges - n_intra
    src[n_intra:] = rng.integers(0, num_nodes, n_inter)
    dst[n_intra:] = rng.integers(0, num_nodes, n_inter)
    keep = src != dst
    return src[keep], dst[keep]


def make_synthetic_dataset(
    kind: str = "hits",
    num_nodes: int = 2000,
    num_edges: int = 20000,
    num_node_feats: int = 0,
    num_valid: int = 1000,
    num_test: int = 1000,
    num_neg_eval: int = 2000,
    neg_per_source: int = 50,
    seed: int = 0,
    weighted: bool = False,
    with_year: bool = False,
    num_communities: int = 50,
) -> Dict:
    rng = np.random.default_rng(seed)
    if kind.endswith("-sbm") or kind == "sbm":
        # num_communities controls the community SCALE (nodes/community =
        # num_nodes/num_communities) — the knob that decides whether the
        # dense-tile hybrid backend has tiles to find (see ops/tile_spmm.py);
        # reachable from the CLI spec: synthetic:hits-sbm:...,num_communities=800
        src, dst = make_sbm_graph(
            rng, num_nodes, num_edges, num_communities=num_communities
        )
        kind = "mrr" if kind.startswith("mrr") else "hits"
    else:
        src, dst = make_skewed_graph(rng, num_nodes, num_edges)
    e = len(src)
    order = rng.permutation(e)
    src, dst = src[order], dst[order]
    n_val, n_test = min(num_valid, e // 4), min(num_test, e // 4)
    n_train = e - n_val - n_test

    tr = np.stack([src[:n_train], dst[:n_train]], axis=1).astype(np.int64)
    va = np.stack(
        [src[n_train : n_train + n_val], dst[n_train : n_train + n_val]], axis=1
    ).astype(np.int64)
    te = np.stack([src[n_train + n_val :], dst[n_train + n_val :]], axis=1).astype(
        np.int64
    )

    node_feat: Optional[np.ndarray] = None
    if num_node_feats:
        node_feat = rng.standard_normal((num_nodes, num_node_feats)).astype(
            np.float32
        )

    if kind == "mrr":
        split_edge = {
            "train": {"source_node": tr[:, 0], "target_node": tr[:, 1]},
            "valid": {
                "source_node": va[:, 0],
                "target_node": va[:, 1],
                "target_node_neg": rng.integers(
                    0, num_nodes, (len(va), neg_per_source)
                ).astype(np.int64),
            },
            "test": {
                "source_node": te[:, 0],
                "target_node": te[:, 1],
                "target_node_neg": rng.integers(
                    0, num_nodes, (len(te), neg_per_source)
                ).astype(np.int64),
            },
        }
        eval_metric = "mrr"
    else:
        split_edge = {
            "train": {"edge": tr},
            "valid": {
                "edge": va,
                "edge_neg": rng.integers(0, num_nodes, (num_neg_eval, 2)).astype(
                    np.int64
                ),
            },
            "test": {
                "edge": te,
                "edge_neg": rng.integers(0, num_nodes, (num_neg_eval, 2)).astype(
                    np.int64
                ),
            },
        }
        eval_metric = "hits"

    if weighted and kind != "mrr":
        split_edge["train"]["weight"] = (
            rng.random(n_train).astype(np.float32) + 0.5
        )
    if with_year and kind != "mrr":
        split_edge["train"]["year"] = rng.integers(
            2000, 2020, n_train
        ).astype(np.int64)

    # Graph edges = train edges (like OGB: the adjacency is the train graph).
    return {
        "name": f"synthetic-{kind}",
        "num_nodes": num_nodes,
        "node_feat": node_feat,
        "edge_index": tr.T.copy(),  # (2, P) directed as stored
        "edge_weight": split_edge["train"].get("weight"),
        "split_edge": split_edge,
        "eval_metric": eval_metric,
        "directed": kind == "mrr",  # citation2-style graphs are directed
    }
