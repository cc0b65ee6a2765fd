"""Model assembly and evaluation (port of the serving half of
plnlp_tpu/training.py).

``Model`` is an ``nn.Module`` holding the embedding table, the encoder and
the predictor, with the JAX package's input-layer sizing.  ``encode`` runs
the full-graph encoder once and appends the mean row (index -1 resolves to
it); ``batch_predict`` scores pairs in chunks; ``test`` is the eval loop.
The optimizer, losses, samplers and the train step are the next slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from plnlp_tpu_torch import default_device
from plnlp_tpu_torch.metrics import evaluate_hits, evaluate_mrr
from plnlp_tpu_torch.models import Encoder, Predictor
from plnlp_tpu_torch.nn import xavier_uniform

__all__ = ["ModelConfig", "Model"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The model/optimization surface of the reference CLI; same fields and
    defaults as plnlp_tpu's.  Only float32 ``compute_dtype`` is ported."""

    encoder: str = "SAGE"
    predictor: str = "MLP"
    optimizer: str = "Adam"
    loss_func: str = "AUC"
    neg_sampler: str = "global"
    gnn_num_layers: int = 2
    mlp_num_layers: int = 2
    emb_hidden_channels: int = 256
    gnn_hidden_channels: int = 256
    mlp_hidden_channels: int = 256
    dropout: float = 0.0
    grad_clip_norm: float = 2.0
    lr: float = 1e-3
    num_neg: int = 1
    batch_size: int = 64 * 1024
    use_node_feats: bool = False
    train_node_emb: bool = True
    eval_batch_size: Optional[int] = None  # defaults to batch_size
    compute_dtype: str = "float32"
    remat: bool = False


class Model(nn.Module):
    """Embedding table + encoder + predictor (reference BaseModel).

    Parameters are drawn from a CPU ``torch.Generator`` seeded with ``seed``
    and then moved to ``device`` (``cuda`` unless ``device="cpu"``).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        num_nodes: int,
        num_node_feats: int = 0,
        pretrain_emb: Optional[np.ndarray] = None,
        *,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype} is not ported yet (float32 "
                "only; bf16 is ROADMAP queue 1 item 3)"
            )
        self.cfg = cfg
        self.num_nodes = num_nodes
        self.num_node_feats = num_node_feats
        self.pretrain_emb = pretrain_emb

        # Input layer sizing — reference create_input_layer: with node feats
        # a fresh trainable table is added when train_node_emb, else a
        # frozen pretrained one if given; without node feats a pretrained
        # table wins over a fresh one whenever given.
        self.use_emb = False
        self.use_pretrained = False
        emb_dim = 0
        if cfg.use_node_feats:
            input_dim = num_node_feats
            if cfg.train_node_emb:
                self.use_emb = True
                emb_dim = cfg.emb_hidden_channels
            elif pretrain_emb is not None:
                self.use_emb = self.use_pretrained = True
                emb_dim = pretrain_emb.shape[1]
            input_dim += emb_dim
        else:
            self.use_emb = True
            if pretrain_emb is not None:
                self.use_pretrained = True
                emb_dim = pretrain_emb.shape[1]
            else:
                emb_dim = cfg.emb_hidden_channels
            input_dim = emb_dim
        self.emb_dim = emb_dim
        self.input_dim = input_dim
        self.emb_trainable = self.use_emb and not self.use_pretrained
        self.init_params(seed, default_device(device))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def init_params(self, seed: int, device=None) -> "Model":
        """Fresh parameters (reference param_init): xavier-uniform embedding,
        torch-default resets elsewhere.  Draw order: embedding, encoder,
        predictor."""
        device = self.device if device is None else device
        gen = torch.Generator().manual_seed(seed)
        cfg = self.cfg
        self.emb = None
        if self.use_emb:
            if self.use_pretrained:
                table = torch.as_tensor(np.asarray(self.pretrain_emb, np.float32))
            else:
                table = xavier_uniform(gen, (self.num_nodes, self.emb_dim))
            self.emb = nn.Parameter(table, requires_grad=self.emb_trainable)
        self.encoder = Encoder(
            gen, cfg.encoder, self.input_dim, cfg.gnn_hidden_channels, cfg.gnn_num_layers
        )
        self.predictor = Predictor(
            gen, cfg.predictor, cfg.mlp_hidden_channels, cfg.mlp_num_layers
        )
        return self.to(device)

    def _input_feat(self, node_feats):
        """emb ⊕ raw features (reference create_input_feat)."""
        if self.cfg.use_node_feats:
            if node_feats is None:
                raise ValueError("use_node_feats=True needs node_feats")
            node_feats = torch.as_tensor(node_feats, dtype=torch.float32, device=self.device)
            if self.use_emb:
                return torch.cat([self.emb, node_feats], dim=-1)
            return node_feats
        return self.emb

    @torch.no_grad()
    def encode(self, graph, graph_t=None, node_feats=None) -> torch.Tensor:
        """(N + 1, D) node representations in eval mode; row N is the mean
        row that index -1 resolves to (reference model.py:191-194)."""
        h = self.encoder(graph, self._input_feat(node_feats), graph_t=graph_t)
        return torch.cat([h, h.mean(0, keepdim=True)], dim=0)

    @torch.no_grad()
    def batch_predict(self, h: torch.Tensor, edges) -> torch.Tensor:
        """Scores for (M, 2) pairs in chunks of ``eval_batch_size or
        batch_size``; returns an (M,) float32 tensor on ``h``'s device."""
        edges = torch.as_tensor(edges, device=h.device).long()
        bs = self.cfg.eval_batch_size or self.cfg.batch_size
        n = self.num_nodes
        out = []
        for chunk in edges.split(bs):
            e = torch.where(chunk < 0, n, chunk)
            out.append(self.predictor(h[e[:, 0]], h[e[:, 1]]).reshape(-1))
        if not out:
            return torch.zeros(0, device=h.device)
        return torch.cat(out).float()

    def test(
        self,
        graph,
        graph_t,
        node_feats,
        split_edges: Dict[str, Dict[str, object]],
        eval_metric: str = "hits",
    ):
        """Reference BaseModel.test: encode once, score valid/test pos+neg
        pairs, Hits@K or MRR."""
        h = self.encode(graph, graph_t, node_feats)
        preds = {
            split: {kind: self.batch_predict(h, split_edges[split][kind]) for kind in ("pos", "neg")}
            for split in ("valid", "test")
        }
        if eval_metric == "mrr":
            return evaluate_mrr(
                preds["valid"]["pos"],
                preds["valid"]["neg"].reshape(preds["valid"]["pos"].shape[0], -1),
                preds["test"]["pos"],
                preds["test"]["neg"].reshape(preds["test"]["pos"].shape[0], -1),
            )
        return evaluate_hits(
            preds["valid"]["pos"], preds["valid"]["neg"],
            preds["test"]["pos"], preds["test"]["neg"],
        )
