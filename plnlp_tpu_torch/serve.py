"""Serving: score link candidates from a model (port of plnlp_tpu/serve.py).

The full-graph encode runs once when the :class:`Scorer` is built; queries
after it are chunked predictor calls on the cached node representations.
``mesh`` splits query scoring over its data axis, as evaluation does; over
a ``GraphParallel`` every rank encodes its rows and holds the gathered h.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from plnlp_tpu_torch.dense import DenseAdj
from plnlp_tpu_torch.graph import Graph
from plnlp_tpu_torch.models.predictors import (
    grid_factorizable,
    grid_scores_left,
    grid_transform_right,
)
from plnlp_tpu_torch.training import Model

__all__ = ["Scorer"]


class Scorer:
    """Frozen-model pair scorer over a cached full-graph encoding.

    ``graph``/``graph_t``/``node_feats`` must match what the model was
    trained with.  ``exclude_edges=True`` filters out the edges of
    ``exclude_graph``, a CSR :class:`Graph` or a ``DenseAdj`` that defaults
    to ``graph``; over a ``HybridGraph`` or a ``GraphParallel`` pass the
    replicated CSR twin (the sampler's graph).  ``mesh`` (collective: every
    rank calls) splits ``score`` and the pairwise ranking over its data
    axis.
    """

    # Upper bound on the S×C pair grid scored per pass (sources are chunked
    # to stay under it): 8M pairs = 32 MB of f32 scores.
    _MAX_GRID_PAIRS = 8 * 1024 * 1024

    def __init__(self, model: Model, graph, graph_t=None, node_feats=None,
                 exclude_graph: Optional[Graph] = None, mesh=None):
        self.model = model
        self.mesh = mesh
        self.exclude_graph = exclude_graph if exclude_graph is not None else graph
        self.h = model.encode(graph, graph_t, node_feats)

    @classmethod
    def from_checkpoint(
        cls,
        model: Model,
        checkpoint_dir: str,
        graph,
        graph_t=None,
        node_feats=None,
        step: Optional[int] = None,
        exclude_graph=None,
        mesh=None,
    ) -> "Scorer":
        """Load the latest (or ``step``) checkpoint the trainer saved (the
        CLI's ``--checkpoint_dir``) into ``model`` (a row-sharded table takes
        this rank's rows) and build a scorer."""
        from plnlp_tpu_torch.checkpoint import CheckpointManager
        from plnlp_tpu_torch.parallel.sharded import load_full_state

        state, _, _ = CheckpointManager(checkpoint_dir).restore(step, device=model.device)
        load_full_state(model, None, state)
        return cls(model, graph, graph_t, node_feats, exclude_graph=exclude_graph, mesh=mesh)

    def score(self, pairs) -> np.ndarray:
        """Scores for (M, 2) int node pairs; -1 = unseen-node mean row."""
        pairs = torch.as_tensor(np.asarray(pairs, np.int64), device=self.h.device)
        return self.model.batch_predict(self.h, pairs, mesh=self.mesh).cpu().numpy()

    def rank_candidates(
        self,
        src: int,
        candidates: Optional[np.ndarray] = None,
        k: int = 10,
        exclude_edges: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k candidates for ``src`` (default: every node), sorted by
        descending score; ``exclude_edges=True`` drops known neighbors."""
        ids, scores = self.rank_candidates_batch(
            [src], candidates, k, exclude_edges=exclude_edges
        )
        return ids[0], scores[0]

    def _neighbor_mask(self, candidates: np.ndarray):
        """``mask(srcs, scores)`` setting known-edge candidate columns of
        ``scores`` (S, C) to -inf, from ``exclude_graph``'s CSR: the senders
        of each source's in-edges (its neighbors on a symmetric graph)."""
        g = self.exclude_graph
        n = self.model.num_nodes
        c = len(candidates)
        identity = c == n and np.array_equal(candidates, np.arange(n))
        if isinstance(g, DenseAdj):
            cand = None if identity else torch.as_tensor(candidates, device=g.device)

            def mask_dense(srcs, scores):
                rows = g.adj[srcs]
                if cand is not None:
                    rows = rows[:, cand]
                return scores.masked_fill(rows != 0, float("-inf"))

            return mask_dense
        if not isinstance(g, Graph):
            raise ValueError(
                f"exclude_edges needs a CSR Graph or a DenseAdj to read known edges "
                f"from; got {type(g).__name__}: pass exclude_graph= to Scorer (e.g. "
                f"the CSR twin of a HybridGraph or a GraphParallel)"
            )
        cand_pos = None
        if not identity:
            # node id -> column in the candidate list; c for non-candidates
            pos = np.full(n, c, np.int64)
            pos[candidates] = np.arange(c)
            cand_pos = torch.as_tensor(pos, device=g.device)
        md = max(int(g.max_degree), 1)
        offs = torch.arange(md, device=g.device)
        indptr = g.indptr.long()

        def mask(srcs, scores):
            lo = indptr[srcs]
            deg = indptr[srcs + 1] - lo
            idx = (lo[:, None] + offs[None, :]).clamp(max=max(g.num_edges - 1, 0))
            nbr = g.senders[idx].long() if g.num_edges else idx
            col = nbr if cand_pos is None else cand_pos[nbr]
            # window slots past the degree go to the spare column c
            col = torch.where(offs[None, :] < deg[:, None], col, c)
            padded = torch.cat([scores, scores.new_zeros(scores.shape[0], 1)], 1)
            padded.scatter_(1, col, float("-inf"))
            return padded[:, :c]

        return mask

    def rank_candidates_batch(
        self,
        srcs,
        candidates: Optional[np.ndarray] = None,
        k: int = 10,
        exclude_edges: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k candidates for many sources: (node_ids, scores), both
        (S, k), rows sorted by descending score.  The S×C grid is built and
        ranked on the device in source chunks of at most
        ``_MAX_GRID_PAIRS`` pairs; only the (S, k) results come back.

        Factorizable predictors (DOT/BIL/MLPDOT/MLPBIL) transform the
        candidates once and score each chunk with one matmul; MLP/MLPCAT
        score the explicit pair grid, and so does every predictor under a
        mesh with a data axis (the grid's pairs split over it).
        """
        dev = self.h.device
        srcs = np.asarray(srcs, np.int64).reshape(-1)
        if candidates is None:
            candidates = np.arange(self.model.num_nodes, dtype=np.int64)
        candidates = np.asarray(candidates, np.int64)
        s, c = len(srcs), len(candidates)
        k = min(k, c)
        mask = self._neighbor_mask(candidates) if exclude_edges else None
        cand_d = torch.as_tensor(candidates, device=dev)
        per = max(1, self._MAX_GRID_PAIRS // max(c, 1))
        pred = self.model.predictor
        data_sharded = self.mesh is not None and self.mesh.data > 1
        factorized = grid_factorizable(pred.name) and not data_sharded
        ids_out, scores_out = [], []
        with torch.no_grad():
            right = grid_transform_right(pred, self.h[cand_d]) if factorized else None
            for lo in range(0, s, per):
                srcs_d = torch.as_tensor(srcs[lo : lo + per], device=dev)
                if factorized:
                    scores = grid_scores_left(pred, self.h[srcs_d], right)
                else:
                    sc = srcs_d.shape[0]
                    pairs = torch.stack(
                        [srcs_d.repeat_interleave(c), cand_d.repeat(sc)], dim=1
                    )
                    scores = self.model.batch_predict(self.h, pairs, mesh=self.mesh).reshape(sc, c)
                scores = scores.float()
                if mask is not None:
                    scores = mask(srcs_d, scores)
                top, idx = torch.topk(scores, k, dim=1)
                ids_out.append(cand_d[idx].cpu().numpy())
                scores_out.append(top.cpu().numpy())
        return np.concatenate(ids_out), np.concatenate(scores_out)
