"""Model assembly, training and evaluation (port of plnlp_tpu/training.py).

``Model`` is an ``nn.Module`` holding the embedding table, the encoder and
the predictor, with the JAX package's input-layer sizing.

* Training: ``make_optimizer`` (torch.optim Adam / AdamW / SGD with the
  settings the JAX package writes its optimizers to), ``train_step`` (one
  full-graph forward, the fused predictor call over pos ⊕ neg pairs, the
  loss, per-group clipping with the embedding excluded, one optimizer step
  at the given lr) and ``train_epoch`` (negatives, shuffle, the masked
  static last batch, the count-weighted mean loss).  Randomness comes from
  the explicit ``torch.Generator`` the caller hands in.
* Evaluation: ``encode`` runs the full-graph encoder once and appends the
  mean row (index -1 resolves to it); ``batch_predict`` scores pairs in
  chunks; ``test`` is the eval loop.
* ``compute_dtype`` ("float32" or "bfloat16"): the input features are cast
  to it, so the encoder and the predictor run in it at training; the
  parameters, their gradients, the clipping and the optimizer state stay
  float32, the loss is taken in float32, and ``encode`` casts h to float32,
  so evaluation, serving and ranking score in float32, as the JAX package
  does.
* Under a mesh (``parallel/``): over a ``GraphParallel`` the model holds
  only this rank's slot rows of the embedding table (``place_rows``) and
  the encoder runs on them; its output is gathered into original node
  order for the predictor.  ``train_step(mesh=)`` takes the global pair
  batch and trains on this rank's share of it (split over the whole
  world), with its loss a distinct share of the global loss, so the
  gradients summed over the ranks that hold each parameter
  (``parallel/sharded.reduce_gradients``) are the single-device ones.
  Every rank draws the same negatives and shuffle from the same seed.
  ``batch_predict``/``test`` with ``mesh`` split pair chunks over the data
  axis with the full h on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from plnlp_tpu_torch import default_device
from plnlp_tpu_torch.losses import MEAN_LOSSES, calculate_loss
from plnlp_tpu_torch.metrics import evaluate_hits, evaluate_mrr
from plnlp_tpu_torch.models import Encoder, Predictor
from plnlp_tpu_torch.nn import COMPUTE_DTYPES, xavier_uniform
from plnlp_tpu_torch.ops.tile_spmm import HybridGraph
from plnlp_tpu_torch.parallel.graph_parallel import (
    GraphParallel,
    gather_node_features,
    shard_node_features,
)
from plnlp_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_batch
from plnlp_tpu_torch.profiling import span
from plnlp_tpu_torch.sampling import (
    global_neg_sample,
    global_perm_neg_sample,
    local_neg_sample,
)

__all__ = ["ModelConfig", "Model", "adjust_lr"]

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The model/optimization surface of the reference CLI; same fields and
    defaults as plnlp_tpu's."""

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
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {cfg.compute_dtype!r}"
            )
        self.cfg = cfg
        self.compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
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
        # the GraphParallel whose slot rows of the table this rank holds
        self.row_placement: Optional[GraphParallel] = None
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
            if self.row_placement is not None:
                table = shard_node_features(table, self.row_placement)
            self.emb = nn.Parameter(table, requires_grad=self.emb_trainable)
        self.encoder = Encoder(
            gen, cfg.encoder, self.input_dim, cfg.gnn_hidden_channels, cfg.gnn_num_layers
        )
        self.predictor = Predictor(
            gen, cfg.predictor, cfg.mlp_hidden_channels, cfg.mlp_num_layers
        )
        return self.to(device)

    def place_rows(self, gp: GraphParallel) -> "Model":
        """Keep only this rank's slot rows of the embedding table (drawn
        whole, so every shard count starts from the same table); the
        optimizer is made after this.  ``init_params`` keeps the
        placement."""
        if self.row_placement is not None:
            raise ValueError("the table is already row-sharded")
        self.row_placement = gp
        if self.emb is not None:
            self.emb = nn.Parameter(
                shard_node_features(self.emb.detach(), gp).contiguous(),
                requires_grad=self.emb_trainable,
            )
        return self

    def param_count(self) -> int:
        """Total parameter count, frozen embeddings included (the
        reference's para_list accounting), with the table counted at
        num_nodes rows whatever rows this rank holds."""
        rest = sum(p.numel() for p in self.parameters() if p is not self.emb)
        if self.emb is None:
            return rest
        rows = self.emb.shape[0] if self.row_placement is None else self.num_nodes
        return rest + rows * self.emb.shape[1]

    def _check_operand(self, graph) -> None:
        if isinstance(graph, GraphParallel) and graph is not self.row_placement:
            raise ValueError(
                "over a GraphParallel the model holds this rank's rows: call "
                "parallel.shard_params(model, graph) (Model.place_rows) first"
            )

    def _resolve_mesh(self, graph, mesh):
        """The mesh of this call: the one given, else the GraphParallel's;
        it must describe the process group's world."""
        if mesh is None:
            mesh = graph.mesh if isinstance(graph, GraphParallel) else None
        elif isinstance(graph, GraphParallel) and graph.mesh is not mesh:
            raise ValueError("mesh= differs from the GraphParallel operand's mesh")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.Mesh, got {type(mesh).__name__}")
            mesh.check()
        return mesh

    def _node_rows(self, graph, graph_t, x, **kw) -> torch.Tensor:
        """The encoder's output in original node order (N, D): over a
        GraphParallel this rank's rows are encoded and gathered."""
        self._check_operand(graph)
        h = self.encoder(graph, x, graph_t, **kw)
        return gather_node_features(h, graph) if isinstance(graph, GraphParallel) else h

    # -- training -----------------------------------------------------------

    def make_optimizer(self) -> torch.optim.Optimizer:
        """The optimizer over every trainable parameter (a frozen pretrained
        table is left out, so no step moves it), with torch.optim's
        semantics as the JAX package writes them: Adam betas (0.9, 0.999),
        eps 1e-8; AdamW the same with weight decay 0.01; SGD momentum 0.9,
        nesterov, weight decay 1e-5.  ``train_step`` sets the lr."""
        params = [p for p in self.parameters() if p.requires_grad]
        name = self.cfg.optimizer.lower()
        lr = self.cfg.lr
        if name == "adamw":
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
        if name == "sgd":
            return torch.optim.SGD(params, lr=lr, momentum=0.9, nesterov=True, weight_decay=1e-5)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def loss(self, graph, graph_t, node_feats, pos, neg, margin, mask, gen=None) -> torch.Tensor:
        """Train-mode forward and loss for one pair batch: the full-graph
        encode and ONE predictor call over pos ⊕ neg pairs in the compute
        dtype; the loss in f32."""
        cfg = self.cfg
        h = self._node_rows(
            graph, graph_t, self._input_feat(node_feats).to(self.compute_dtype),
            dropout=cfg.dropout, train=True, gen=gen, remat=cfg.remat,
        )
        b = pos.shape[0]
        pairs = torch.cat([pos, neg.reshape(-1, 2)])
        out = self.predictor(
            h[pairs[:, 0]], h[pairs[:, 1]], dropout=cfg.dropout, train=True, gen=gen
        )
        out = out.reshape(out.shape[0], -1).float()
        return calculate_loss(
            cfg.loss_func, out[:b], out[b:], cfg.num_neg, margin=margin, mask=mask
        )

    def train_step(
        self, opt, graph, graph_t, node_feats, pos, neg, margin, mask, lr: float, gen=None,
        mesh=None,
    ) -> torch.Tensor:
        """One optimizer step on one pair batch; returns the (detached) loss.
        The encoder and predictor gradients are clipped each to global norm
        ``grad_clip_norm`` (the embedding is not clipped), as the reference
        does.  With a mesh of more than one rank the batch is the global one:
        this rank trains on its share, and the loss returned is the global
        loss on every rank."""
        mesh = self._resolve_mesh(graph, mesh)
        opt.zero_grad(set_to_none=True)
        single = mesh is None or mesh.world_size == 1
        with span("train.forward"):
            if single:
                loss = self.loss(graph, graph_t, node_feats, pos, neg, margin, mask, gen)
            else:
                loss = self._loss_share(
                    mesh, graph, graph_t, node_feats, pos, neg, margin, mask, gen
                )
        with span("train.backward"):
            loss.backward()
            if not single:
                from plnlp_tpu_torch.parallel.sharded import reduce_gradients

                reduce_gradients(self, mesh)
                loss = loss.detach()
                torch.distributed.all_reduce(loss)
        if self.cfg.grad_clip_norm >= 0:
            with span("train.clip"):
                for group in (self.encoder, self.predictor):
                    _clip_group(list(group.parameters()), self.cfg.grad_clip_norm)
        with span("train.optim"):
            for g in opt.param_groups:
                g["lr"] = lr
            opt.step()
        return loss.detach()

    def _loss_share(self, mesh, graph, graph_t, node_feats, pos, neg, margin, mask, gen):
        """This rank's share of the global batch's loss: its slice of the
        batch (split over the world); a mean loss is rescaled from its own
        count of valid pairs to the global count."""
        if mask is None:
            mask = torch.ones(pos.shape[0], device=pos.device)
        pos_r, neg_r, mask_r = shard_batch((pos, neg, mask), mesh)
        margin_r = None if margin is None else shard_batch(margin, mesh)
        loss = self.loss(graph, graph_t, node_feats, pos_r, neg_r, margin_r, mask_r, gen)
        if self.cfg.loss_func in MEAN_LOSSES:
            loss = loss * (mask_r.sum().clamp(min=1.0) / mask.sum().clamp(min=1.0))
        return loss

    def sample_negatives(self, gen: torch.Generator, graph, pos_edges: torch.Tensor):
        """(P, num_neg, 2) negatives by sampler name; any name but local
        and global is global-perm, as in the reference."""
        cfg = self.cfg
        p = pos_edges.shape[0]
        if cfg.neg_sampler == "local":
            return local_neg_sample(gen, pos_edges, self.num_nodes, cfg.num_neg)
        if isinstance(graph, (HybridGraph, GraphParallel)):
            raise ValueError("global samplers need the plain CSR twin: pass sample_graph")
        if cfg.neg_sampler == "global":
            return global_neg_sample(gen, graph, p, cfg.num_neg)
        return global_perm_neg_sample(gen, graph, p, cfg.num_neg)

    def train_epoch(
        self,
        opt,
        graph,
        graph_t,
        node_feats,
        pos_edges,
        weights,
        gen: torch.Generator,
        lr: float,
        sample_graph=None,
        num_pos: Optional[int] = None,
        pos_mask=None,
        mesh=None,
    ) -> float:
        """One epoch; returns the mean loss over the real positives.

        ``pos_edges`` may be capacity-padded, with ``num_pos`` the real
        count; ``pos_mask`` invalidates further entries.  ``weights`` are
        per-pair margins (margin losses), or None.  ``sample_graph`` is the
        edge set the negative sampler excludes (default ``graph``).  The
        last batch takes the last ``batch_size`` entries and masks the ones
        the previous batch already took.  ``gen`` lies on the model's
        device.  ``mesh`` (default: a GraphParallel's own) splits each batch
        over its ranks; every rank must pass a generator with the same seed,
        so that all draw the same negatives and shuffle."""
        with span("train.epoch"):
            mesh = self._resolve_mesh(graph, mesh)
            cfg = self.cfg
            dev = self.device
            pos_edges = torch.as_tensor(pos_edges, device=dev).long()
            p_cap = pos_edges.shape[0]
            p_real = num_pos if num_pos is not None else p_cap
            use_margin = weights is not None
            sg = sample_graph if sample_graph is not None else graph
            with span("train.sample"):
                neg_edges = self.sample_negatives(gen, sg, pos_edges)

            with span("train.shuffle"):
                # shuffle the real positives; a padded tail stays at the end, masked
                perm = torch.randperm(p_real, generator=gen, device=gen.device).to(dev)
                if p_cap > p_real:
                    perm = torch.cat([perm, torch.arange(p_real, p_cap, device=dev)])
                pos_edges, neg_edges = pos_edges[perm], neg_edges[perm]
                valid = (torch.arange(p_cap, device=dev) < p_real).float()
                if pos_mask is not None:
                    valid = valid * torch.as_tensor(pos_mask, device=dev)[perm].float()
                if use_margin:
                    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)[perm]

            b = min(cfg.batch_size, p_cap)
            drop_gen = gen
            if mesh is not None and mesh.world_size > 1:
                if b % mesh.world_size:
                    import warnings

                    warnings.warn(
                        f"batch_size {b} is not divisible by the mesh's {mesh.world_size} "
                        "ranks: pair batches split into uneven shares",
                        stacklevel=2,
                    )
                if cfg.dropout > 0:
                    # each rank its own dropout masks; the shared generator keeps
                    # drawing the same negatives and shuffles on every rank
                    seed = int(torch.randint(2**62, (1,), generator=gen, device=gen.device))
                    drop_gen = torch.Generator(device=gen.device).manual_seed(seed + mesh.rank)
            losses, counts = [], []
            for i in range(max(1, math.ceil(p_real / b))):
                with span("train.step"):
                    lo = fresh_lo = i * b
                    if min(lo + b, p_cap) - lo < b:
                        lo = p_cap - b
                    mask = valid[lo : lo + b]
                    if fresh_lo > lo:
                        mask = mask * (torch.arange(lo, lo + b, device=dev) >= fresh_lo)
                    loss = self.train_step(
                        opt, graph, graph_t, node_feats,
                        pos_edges[lo : lo + b], neg_edges[lo : lo + b],
                        weights[lo : lo + b] if use_margin else None, mask, lr, drop_gen,
                        **({} if mesh is None else {"mesh": mesh}),
                    )
                    # loss and count stay on the device: one sync per epoch
                    losses.append(loss)
                    counts.append(mask.sum())
            with span("train.sync"):
                losses, counts = torch.stack(losses), torch.stack(counts)
                return float((losses * counts).sum()) / max(float(counts.sum()), 1.0)

    # -- evaluation ---------------------------------------------------------

    def _input_feat(self, node_feats):
        """emb ⊕ raw features (reference create_input_feat)."""
        if self.cfg.use_node_feats:
            if node_feats is None:
                raise ValueError("use_node_feats=True needs node_feats")
            node_feats = torch.as_tensor(node_feats, dtype=torch.float32, device=self.device)
            if self.row_placement is not None:
                node_feats = shard_node_features(node_feats, self.row_placement)
            if self.use_emb:
                return torch.cat([self.emb, node_feats], dim=-1)
            return node_feats
        return self.emb

    @torch.no_grad()
    def encode(self, graph, graph_t=None, node_feats=None) -> torch.Tensor:
        """(N + 1, D) float32 node representations in eval mode (the encoder
        runs in the compute dtype); row N is the mean row that index -1
        resolves to (reference model.py:191-194)."""
        x = self._input_feat(node_feats).to(self.compute_dtype)
        h = self._node_rows(graph, graph_t, x).float()  # metrics rank in f32
        return torch.cat([h, h.mean(0, keepdim=True)], dim=0)

    @torch.no_grad()
    def batch_predict(self, h: torch.Tensor, edges, mesh=None) -> torch.Tensor:
        """Scores for (M, 2) pairs in chunks of ``eval_batch_size or
        batch_size``; returns an (M,) float32 tensor on ``h``'s device.
        With ``mesh``, the pairs split over its data axis (each rank scores
        its share with the full ``h``) and every rank gets all scores."""
        edges = torch.as_tensor(edges, device=h.device).long()
        if mesh is not None and mesh.data > 1:
            m = edges.shape[0]
            per = -(-m // mesh.data)
            edges = torch.cat([edges, edges.new_zeros((per * mesh.data - m, 2))])
            mine = self.batch_predict(h, edges[mesh.data_index * per:][:per])
            return gather_rows(mine, mesh.data_group)[:m]
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
        mesh=None,
    ):
        """Reference BaseModel.test: encode once, score valid/test pos+neg
        pairs, Hits@K or MRR.  ``mesh`` splits the scoring over its data
        axis."""
        with span("eval.test"):
            with span("eval.encode"):
                h = self.encode(graph, graph_t, node_feats)
            preds = {}
            for split in ("valid", "test"):
                preds[split] = {}
                for kind in ("pos", "neg"):
                    with span("eval.predict"):
                        preds[split][kind] = self.batch_predict(
                            h, split_edges[split][kind], mesh=mesh
                        )
            with span("eval.metric"):
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


def _clip_group(params, max_norm: float) -> None:
    """torch clip_grad_norm_ on one parameter group: scale every gradient
    by min(1, max_norm / (global norm + 1e-6))."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)


def adjust_lr(base_lr: float, decay_ratio: float) -> float:
    """Linear lr decay floored at lr * 1e-4 (reference adjust_lr)."""
    return max(base_lr * (1 - decay_ratio), base_lr * 1e-4)
