"""The plain reference of PLNLP's link predictor, in float32 PyTorch.

It follows the published method (PLNLP, ``main.py`` and ``model.py`` of
the reference code) and imports torch alone: no kernel, no blocking, no
cache.  From the raw inputs it works out again everything the port derives
from them: the dataset surgery (collab's year filter and valid edges as
input, with the reference's weight order kept; citation2's symmetrised
graph), the coalesced adjacency and its GCN normalisation, the negatives
(by replaying the sampler's draws from the same generator seed: the same
calls in the same order give the same numbers), the encoders SAGE and GCN,
the predictors DOT and MLP, the AUC loss, per-group gradient clipping and
Adam.  Aggregations are chunked ``index_add_`` sums, so that a graph of
tens of millions of edges fits, accumulated in float64.

``model`` below is the configuration's ``model`` dict: the CLI's flag
names and values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_CHUNK = 1 << 22  # edges or pairs a chunk


def _f32_exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- the adjacency ----------------------------------------------------------


class Adjacency:
    """The coalesced edge set, sorted by (dst, src): ``src``, ``dst``,
    ``weight`` (float32), ``count`` (in-edges a row, float32), ``keys``
    (dst * n + src, sorted) and ``indptr`` over dst."""

    def __init__(self, src, dst, weight, num_nodes: int):
        self.num_nodes = n = num_nodes
        self.src, self.dst, self.weight = src, dst, weight
        self.keys = dst * n + src
        self.count = torch.bincount(dst, minlength=n).float()
        self.indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
        self.indptr[1:] = torch.cumsum(torch.bincount(dst, minlength=n), 0)

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())


def _coalesce(src, dst, weight, n: int):
    """Duplicates merged, weights summed in float64 and rounded once."""
    uniq, inv = torch.unique(dst * n + src, return_inverse=True)
    if weight is None:
        w = torch.ones(uniq.numel(), dtype=torch.float32, device=src.device)
    else:
        w = torch.zeros(uniq.numel(), dtype=torch.float64, device=src.device)
        w = w.index_add_(0, inv, weight.double()).float()
    return uniq % n, uniq // n, w


def _undirected(src, dst, weight, n: int):
    w2 = None if weight is None else torch.cat([weight, weight])
    return torch.cat([src, dst]), torch.cat([dst, src]), w2


def derive(model: Dict, inputs: Dict) -> Tuple[Adjacency, torch.Tensor]:
    """The aggregation's adjacency and the training positives (P, 2) that
    the configuration's surgery gives (PLNLP main.py:105-186)."""
    n = inputs["num_nodes"]
    split = inputs["split_edge"]
    tr = split["train"]
    weighted = False
    if "edge" in tr:
        pos = tr["edge"]
        weight = tr.get("weight")
        if model.get("year", -1) > 0 and "year" in tr:
            sel = tr["year"] >= model["year"]
            pos, weight = pos[sel], (None if weight is None else weight[sel])
        adj_edges, adj_weight = pos, weight
        if model.get("use_valedges_as_input"):
            va = split["valid"]["edge"]
            full = torch.cat([va, pos])  # [valid, train]
            # the reference concatenates the weights the other way round
            ones_tr = torch.ones(pos.shape[0], device=pos.device)
            full_w = torch.cat([
                ones_tr if weight is None else weight,
                torch.ones(va.shape[0], device=pos.device),
            ])
            pos, adj_edges, adj_weight = full, full, full_w
        src, dst = adj_edges[:, 0], adj_edges[:, 1]
        weighted = adj_weight is not None
        src, dst, w = _undirected(src, dst, adj_weight, n)
    else:
        pos = torch.stack([tr["source_node"], tr["target_node"]], 1)
        src, dst, w = _undirected(pos[:, 0], pos[:, 1], None, n)
    src, dst, w = _coalesce(src, dst, w if weighted else None, n)
    if model["encoder"] == "GCN":
        # D^-1/2 (A + I) D^-1/2 with the diagonal set to 1
        off = src != dst
        loops = torch.arange(n, device=src.device)
        src, dst, w = _coalesce(
            torch.cat([src[off], loops]), torch.cat([dst[off], loops]),
            torch.cat([w[off], torch.ones(n, device=src.device)]), n,
        )
        deg = torch.zeros(n, dtype=torch.float64, device=src.device).index_add_(0, dst, w.double())
        dinv = torch.where(deg > 0, deg.pow(-0.5), torch.zeros_like(deg))
        w = (dinv[dst] * w.double() * dinv[src]).float()
    elif model["encoder"] != "SAGE":
        raise ValueError(f"the reference has no encoder {model['encoder']}")
    return Adjacency(src, dst, w, n), pos.long()


# -- parameters -------------------------------------------------------------


def _layer_dims(in_ch: int, hidden: int, num_layers: int):
    return [(in_ch if i == 0 else hidden, hidden) for i in range(num_layers)]


def input_dim(model: Dict, num_feats: int) -> int:
    return model["emb_hidden_channels"] + (num_feats if model.get("use_node_feats") else 0)


def param_shapes(model: Dict, num_nodes: int, num_feats: int) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter, named as the port's state dict."""
    shapes = [("emb", (num_nodes, model["emb_hidden_channels"]))]
    for i, (a, b) in enumerate(_layer_dims(
        input_dim(model, num_feats), model["gnn_hidden_channels"], model["gnn_num_layers"]
    )):
        pre = f"encoder.layers.{i}."
        if model["encoder"] == "SAGE":
            shapes += [(pre + "lin_l.weight", (b, a)), (pre + "lin_l.bias", (b,)),
                       (pre + "lin_r.weight", (b, a))]
        else:
            shapes += [(pre + "lin.weight", (b, a)), (pre + "lin.bias", (b,))]
    if model["predictor"] == "MLP":
        h = model["mlp_hidden_channels"]
        dims = [h] * model["mlp_num_layers"] + [1]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes += [(f"predictor.lins.{i}.weight", (b, a)), (f"predictor.lins.{i}.bias", (b,))]
    elif model["predictor"] != "DOT":
        raise ValueError(f"the reference has no predictor {model['predictor']}")
    return shapes


def model_shape(model: Dict, adj: Adjacency, num_feats: int) -> Dict:
    """The shapes ``flops.py`` counts from."""
    return {
        "num_nodes": adj.num_nodes,
        "num_edges": adj.num_edges,
        "encoder": model["encoder"],
        "layers": _layer_dims(
            input_dim(model, num_feats), model["gnn_hidden_channels"], model["gnn_num_layers"]
        ),
        "predictor": model["predictor"],
        "hidden": model["gnn_hidden_channels"],
        "mlp_layers": model["mlp_num_layers"],
        # the trained table's columns take a gradient, the features' do not
        "input_grad_width": model["emb_hidden_channels"] if model.get("train_node_emb", True) else 0,
    }


# -- forward ----------------------------------------------------------------


class _Aggregate(torch.autograd.Function):
    """out[dst] += w * x[src] over the edges, in chunks; backward the same
    over the transposed edges."""

    @staticmethod
    def forward(ctx, x, src, dst, w):
        ctx.save_for_backward(src, dst, w)
        return _agg(x, src, dst, w)

    @staticmethod
    def backward(ctx, g):
        src, dst, w = ctx.saved_tensors
        return _agg(g, dst, src, w), None, None, None


def _agg(x, src, dst, w):
    """Summed in float64 and rounded once: a hub row sums hundreds of
    thousands of terms, and float32 atomics in any order lose digits there
    (on citation2's graph they missed a float64 sum by up to 1e-3 where the
    port's ordered sums stay within 1e-5)."""
    out = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    for lo in range(0, src.numel(), _CHUNK):
        s, d = src[lo:lo + _CHUNK], dst[lo:lo + _CHUNK]
        out.index_add_(0, d, x[s].double() * w[lo:lo + _CHUNK, None].double())
    return out.to(x.dtype)


def _dropout(x, rate: float, gen):
    """torch dropout from ``gen``'s draws, as the port draws them."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def encode(model: Dict, p: Dict, adj: Adjacency, x, gen=None):
    """The encoder over the whole graph; ``gen`` draws dropout (training)."""
    layers = model["gnn_num_layers"]
    for i in range(layers):
        pre = f"encoder.layers.{i}."
        if model["encoder"] == "SAGE":
            agg = _Aggregate.apply(x, adj.src, adj.dst, adj.weight)
            agg = agg * torch.where(adj.count > 0, 1.0 / adj.count.clamp(min=1), 0.0)[:, None]
            x = (agg @ p[pre + "lin_l.weight"].t() + p[pre + "lin_l.bias"]
                 + x @ p[pre + "lin_r.weight"].t())
        else:
            hw = x @ p[pre + "lin.weight"].t()
            x = _Aggregate.apply(hw, adj.src, adj.dst, adj.weight) + p[pre + "lin.bias"]
        if i < layers - 1:
            x = _dropout(torch.relu(x), model["dropout"], gen)
    return x


def predict(model: Dict, p: Dict, hi, hj, gen=None):
    if model["predictor"] == "DOT":
        return (hi * hj).sum(-1)
    x = hi * hj
    n = model["mlp_num_layers"]
    for i in range(n):
        x = x @ p[f"predictor.lins.{i}.weight"].t() + p[f"predictor.lins.{i}.bias"]
        if i < n - 1:
            x = _dropout(torch.relu(x), model["dropout"], gen)
    return x.reshape(-1)


def node_input(model: Dict, p: Dict, node_feat):
    if model.get("use_node_feats"):
        return torch.cat([p["emb"], node_feat], -1)
    return p["emb"]


# -- negatives: the sampler's draws replayed ---------------------------------


def _randint(gen, high: int, shape):
    return torch.randint(0, high, shape, generator=gen, device=gen.device)


def _exists(adj: Adjacency, src, dst):
    q = dst * adj.num_nodes + src
    idx = torch.searchsorted(adj.keys, q).clamp(max=adj.num_edges - 1)
    return adj.keys[idx] == q


def global_negatives(gen, adj: Adjacency, count: int):
    """Uniform pairs that are not edges nor self loops: four rounds of
    redraws, then a pair still bad takes a good pair of the batch."""
    n = adj.num_nodes
    src, dst = _randint(gen, n, (2, count))
    for _ in range(4):
        bad = _exists(adj, src, dst) | (src == dst)
        cand = _randint(gen, n, (2, count))
        src, dst = torch.where(bad, cand[0], src), torch.where(bad, cand[1], dst)
    bad = _exists(adj, src, dst) | (src == dst)
    donor = _randint(gen, count, (count,))
    first_good = torch.argmin(bad.to(torch.uint8))
    donor = torch.where(bad[donor], first_good, donor)
    idx = torch.where(bad & ~bad[donor], donor, torch.arange(count, device=src.device))
    return torch.stack([src[idx], dst[idx]], -1)


def negatives(model: Dict, gen, adj: Adjacency, pos):
    """(P, num_neg, 2) negatives of the configuration's sampler."""
    k = model["num_neg"]
    p = pos.shape[0]
    if model["neg_sampler"] == "local":
        src = pos[:, 0].repeat_interleave(k)
        dst = _randint(gen, adj.num_nodes, (k * p,))
        return torch.stack([src, dst], -1).reshape(p, k, 2)
    if model["neg_sampler"] == "global":
        return global_negatives(gen, adj, p * k).reshape(p, k, 2)
    raise ValueError(f"the reference has no sampler {model['neg_sampler']}")


# -- training ---------------------------------------------------------------


def _group(name: str) -> str:
    return name.split(".")[0]


def train_steps(model: Dict, params: Dict, adj: Adjacency, node_feat,
                batches: List[Tuple[torch.Tensor, int]]) -> Dict:
    """One optimiser step a batch, each as one call of the port's
    ``train_epoch`` on that batch alone: its generator seeded with the
    batch's seed draws the negatives, the shuffle and the dropout masks.
    Returns the loss of each step, each leaf's gradient norm at step 1 as
    Adam gets it (after clipping), and each leaf's change after the last
    step."""
    _f32_exact()
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, model["lr"]
    losses, first_grad = [], {}
    for t, (pos, seed) in enumerate(batches, start=1):
        gen = torch.Generator(device=pos.device).manual_seed(seed)
        neg = negatives(model, gen, adj, pos)
        perm = torch.randperm(pos.shape[0], generator=gen, device=gen.device)
        pos, neg = pos[perm], neg[perm]
        h = encode(model, p, adj, node_input(model, p, node_feat), gen)
        pairs = torch.cat([pos, neg.reshape(-1, 2)])
        out = predict(model, p, h[pairs[:, 0]], h[pairs[:, 1]], gen).float()
        b = pos.shape[0]
        diff = out[:b].reshape(-1, 1) - out[b:].reshape(b, model["num_neg"])
        loss = torch.square(1 - diff).sum()  # AUC
        if model["loss_func"] != "AUC":
            raise ValueError(f"the reference has no loss {model['loss_func']}")
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        clip = model["grad_clip_norm"]
        if clip >= 0:
            for group in ("encoder", "predictor"):
                names = [k for k in grads if _group(k) == group]
                if not names:
                    continue
                norm = torch.sqrt(sum(torch.sum(grads[k] ** 2) for k in names))
                scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
                for k in names:
                    grads[k] = grads[k] * scale
        losses.append(float(loss.detach()))
        if t == 1:
            first_grad = {k: float(g.norm()) for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2**t)).add_(eps)
                p[k].addcdiv_(m[k], denom, value=-lr / (1 - b1**t))
    change = {k: float((p[k].detach() - params[k]).norm()) for k in p}
    return {"loss": losses, "grad": first_grad, "change": change}


# -- evaluation and ranking --------------------------------------------------


@torch.no_grad()
def embed(model: Dict, params: Dict, adj: Adjacency, node_feat):
    """Eval-mode node representations (N, D)."""
    _f32_exact()
    return encode(model, params, adj, node_input(model, params, node_feat))


@torch.no_grad()
def scores(model: Dict, params: Dict, h, pairs):
    out = [predict(model, params, h[c[:, 0]], h[c[:, 1]]) for c in pairs.split(_CHUNK // 8)]
    return torch.cat(out)


@torch.no_grad()
def mrr(model: Dict, params: Dict, h, split: Dict) -> float:
    """OGB's MRR: each positive ranked among its own negatives, ties given
    the mean of the optimistic and the pessimistic rank."""
    src, dst, neg = split["source_node"], split["target_node"], split["target_node_neg"]
    total = 0.0
    rows = max(1, (_CHUNK // 8) // neg.shape[1])
    for lo in range(0, src.numel(), rows):
        s, negs = src[lo:lo + rows], neg[lo:lo + rows]
        pos = predict(model, params, h[s], h[dst[lo:lo + rows]]).reshape(-1, 1)
        k = negs.shape[1]
        sn = predict(model, params, h[s.repeat_interleave(k)], h[negs.reshape(-1)]).reshape(-1, k)
        opt = (sn > pos).float().sum(1)
        pess = (sn >= pos).float().sum(1)
        total += float((1.0 / (0.5 * (opt + pess) + 1.0)).double().sum())
    return total / src.numel()


@torch.no_grad()
def pair_scores(model: Dict, params: Dict, h, split: Dict, kind: str, idx):
    """Scores of pairs ``idx`` of a split in OGB's MRR layout: "pos" the
    (source, target) pairs, "neg" each source with each of its negatives,
    source by source."""
    src = split["source_node"]
    if kind == "pos":
        pairs = torch.stack([src[idx], split["target_node"][idx]], 1)
    else:
        k = split["target_node_neg"].shape[1]
        pairs = torch.stack([src[idx // k], split["target_node_neg"].reshape(-1)[idx]], 1)
    return scores(model, params, h, pairs)


@torch.no_grad()
def rank_gaps(h, adj: Adjacency, srcs, ids, got, k: int) -> Dict:
    """Judge one ranking answer: for sources ``srcs`` (S,), the returned
    candidate ids (S, k) and scores (S, k).  Every node is a candidate, the
    known neighbours (the sources of a row's in-edges) excluded, the score
    the DOT product.  Returns the count of ids that are out of range,
    repeated in a row or excluded; the widest gap between a returned score
    and the reference's score of the same pair; the widest gap by which a
    returned pair's reference score lies below the reference's k-th best;
    both as shares of the row's largest reference score in magnitude."""
    n = adj.num_nodes
    bad, score_gap, rank_gap = 0, 0.0, 0.0
    for lo in range(0, srcs.numel(), 64):
        s = srcs[lo:lo + 64]
        i = ids[lo:lo + 64]
        full = h[s] @ h[:n].t()
        scale = full.abs().amax(1).clamp(min=torch.finfo(torch.float32).tiny)
        deg = adj.indptr[s + 1] - adj.indptr[s]
        rows = torch.repeat_interleave(torch.arange(s.numel(), device=s.device), deg)
        first = torch.repeat_interleave(adj.indptr[s], deg)
        pos_in = torch.arange(rows.numel(), device=s.device) - torch.repeat_interleave(
            torch.cumsum(deg, 0) - deg, deg)
        nbr = adj.src[first + pos_in]
        masked = full.clone()
        masked[rows, nbr] = float("-inf")
        kth = torch.topk(masked, k, dim=1).values[:, -1]
        inrange = (i >= 0) & (i < n)
        ic = i.clamp(0, n - 1)
        sorted_i = torch.sort(ic, 1).values
        dup = torch.zeros_like(inrange)
        dup[:, 1:] = sorted_i[:, 1:] == sorted_i[:, :-1]
        excluded = torch.isinf(masked.gather(1, ic)) & inrange
        bad += int((~inrange).sum() + dup.sum() + excluded.sum())
        ref = full.gather(1, ic)
        score_gap = max(score_gap, float(((got[lo:lo + 64] - ref).abs() / scale[:, None]).max()))
        below = (kth[:, None] - ref).clamp(min=0) / scale[:, None]
        rank_gap = max(rank_gap, float(below.max()))
    return {"bad_ids": bad, "score_gap": score_gap, "rank_gap": rank_gap}
