"""plnlp_tpu_torch training against plnlp_tpu (CPU).

Four joint optimizer steps: the JAX ``Model._train_step`` and the port's
``Model.train_step`` start from the same parameters (carried across with
``params_from_jax``) and take the same fixed pos / neg / margin / mask
batches at dropout 0.  Losses are compared at every step at rtol = atol =
1e-5, and the parameters after the fourth step at rtol = atol = 1e-4
(float32 sums in another order, compounded through four updates).
Covered: SAGE, GCN and WSAGE on a ``HybridGraph`` (with the internal
relabel, and perm-free under padded-carry), SAGE on blocked CSR; Adam,
AdamW and SGD; a frozen pretrained table; a margin loss.

A pairwise loss (AUC, LogRank, ...) is unchanged when every score moves by
the same constant, so an MLP predictor's last bias, and the first-layer
bias of a unit active on every pair, have a gradient that is exactly 0 and
in float32 is rounding residue (~1e-7) that differs between the packages;
Adam divides by its magnitude and turns it into steps of ±lr.  So Adam and
AdamW run with the DOT predictor or the CE loss, which have no such
direction, and the MLP predictor with a pairwise loss runs under SGD.

Then ``train_epoch``'s batching (⌈P/b⌉ steps, the static last batch
counting each positive once) and the port-only pieces: dropout, remat,
``params_to_jax``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import plnlp_tpu.graph as jgraph
import plnlp_tpu.ops.tile_spmm as jts
from plnlp_tpu.training import Model as JaxModel
from plnlp_tpu.training import ModelConfig as JaxConfig
from plnlp_tpu.training import adjust_lr as jax_adjust_lr
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.convert import params_from_jax, params_to_jax
from plnlp_tpu_torch.data.synthetic import make_sbm_graph
from plnlp_tpu_torch.models import Encoder
from plnlp_tpu_torch.nn import dropout
from plnlp_tpu_torch.ops import tile_spmm as tts
from plnlp_tpu_torch.training import Model, ModelConfig, adjust_lr

N, W, B = 300, 16, 64
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _operands(encoder, backend):
    """(port graph, port graph_t, JAX graph, JAX graph_t) on an SBM graph."""
    rng = np.random.default_rng(0)
    src, dst = make_sbm_graph(rng, N, 2500, num_communities=5)
    src, dst, _ = tgraph.to_undirected_edges(src, dst, None, N)
    # SAGE runs the internal relabel (perm_in/perm_out); GCN and WSAGE run
    # a perm-free operand on ids relabeled to community order, as the CLI
    # builds it, under padded-carry
    reorder = "labelprop" if encoder == "SAGE" else None
    if backend == "hybrid" and reorder is None:
        relabel = np.empty(N, np.int64)
        relabel[tts.label_prop_order(src, dst, N)] = np.arange(N)
        src, dst = relabel[src], relabel[dst]
    w = None
    if encoder == "GCN":
        src, dst, w = tgraph.gcn_normalize_edges(src, dst, None, N)
    elif encoder == "WSAGE":
        src, dst, w = tgraph.row_normalize_edges(src, dst, None, N)
    if backend == "csr":
        kw = dict(num_nodes=N, block=(64, 128))
        return (*tgraph.prepare_graph(src, dst, w, device="cpu", **kw),
                *jgraph.prepare_graph(src, dst, w, **kw))
    kw = dict(num_nodes=N, tile=32, min_fill=20, block=(64, 512), reorder=reorder)
    th = tts.build_hybrid(src, dst, w, device="cpu", **kw)
    assert th.num_tiles > 1 and th.res_edges > 0 and (th.perm_in is None) == (reorder is None)
    return th, None, jts.build_hybrid(src, dst, w, **kw), None


# (encoder, backend, predictor, optimizer, loss, num_neg, pretrained)
CONFIGS = [
    ("SAGE", "hybrid", "DOT", "Adam", "AUC", 1, False),
    ("GCN", "hybrid", "MLP", "AdamW", "CE", 2, False),
    ("WSAGE", "hybrid", "MLP", "SGD", "WeightedHingeAUC", 1, False),
    ("SAGE", "csr", "MLP", "Adam", "CE", 1, False),
    ("SAGE", "csr", "MLP", "SGD", "AUC", 1, False),
    ("GCN", "hybrid", "DOT", "AdamW", "LogRank", 1, True),
]


@pytest.mark.parametrize(
    "encoder,backend,predictor,optimizer,loss,num_neg,pretrained", CONFIGS
)
def test_four_optimizer_steps_match_jax(
    encoder, backend, predictor, optimizer, loss, num_neg, pretrained
):
    rng = np.random.default_rng(1)
    kw = dict(
        encoder=encoder, predictor=predictor, optimizer=optimizer, loss_func=loss,
        num_neg=num_neg, emb_hidden_channels=W, gnn_hidden_channels=W,
        mlp_hidden_channels=W, batch_size=B, lr=0.01, grad_clip_norm=1.0,
    )
    emb = rng.standard_normal((N, W)).astype(np.float32) * 0.1 if pretrained else None
    jm = JaxModel(JaxConfig(**kw), N, pretrain_emb=emb)
    jp = jm.init_params(jax.random.PRNGKey(2))
    jo = jm.init_opt_state(jp)
    tm = Model(ModelConfig(**kw), N, pretrain_emb=emb, device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    opt = tm.make_optimizer()
    tg, tgt, jg, jgt = _operands(encoder, backend)
    use_margin = loss == "WeightedHingeAUC"
    for step in range(4):
        pos = rng.integers(0, N, (B, 2))
        neg = rng.integers(0, N, (B, num_neg, 2))
        margin = (rng.random(B) + 0.5).astype(np.float32)
        mask = (np.arange(B) >= (16 if step == 3 else 0)).astype(np.float32)
        lr = adjust_lr(0.01, step / 8)
        jp, jo, jloss = jm._train_step(
            jp, jo, jg, jgt, None, pos.astype(np.int32), neg.astype(np.int32), margin, mask,
            np.float32(lr), jax.random.PRNGKey(step), use_margin,
        )
        tloss = tm.train_step(
            opt, tg, tgt, None, torch.from_numpy(pos), torch.from_numpy(neg),
            torch.from_numpy(margin) if use_margin else None, torch.from_numpy(mask), lr,
        )
        np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
    got = params_to_jax(tm)
    want = jax.tree_util.tree_map(np.asarray, jp)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_allclose(a, b, err_msg=jax.tree_util.keystr(path), **PARAM_TOL)
    if pretrained:
        np.testing.assert_array_equal(got["emb"], emb)  # no step moved it


def test_train_epoch_batches_count_each_positive_once(monkeypatch):
    tg, _, _, _ = _operands("SAGE", "csr")
    cfg = ModelConfig(emb_hidden_channels=8, gnn_hidden_channels=8, mlp_hidden_channels=8,
                      batch_size=64, num_neg=2)
    tm = Model(cfg, N, device="cpu")
    p_cap, p_real = 300, 290  # 10 padded entries
    pos = np.stack([np.arange(p_cap), (np.arange(p_cap) + 1) % N], axis=1)
    pos_mask = np.ones(p_cap, bool)
    pos_mask[:5] = False
    seen = []

    def record(opt, graph, graph_t, node_feats, pos_b, neg_b, margin, mask, lr, gen):
        assert pos_b.shape == (64, 2) and neg_b.shape == (64, 2, 2) and mask.shape == (64,)
        seen.append(pos_b[mask > 0, 0].tolist())
        return torch.tensor(1.0)

    monkeypatch.setattr(tm, "train_step", record)
    gen = torch.Generator().manual_seed(0)
    out = tm.train_epoch(None, tg, None, None, pos, None, gen, 0.01,
                         num_pos=p_real, pos_mask=pos_mask)
    assert len(seen) == -(-p_real // 64) == 5
    assert sorted(sum(seen, [])) == list(range(5, p_real))
    assert out == 1.0
    with pytest.raises(NotImplementedError, match="item 11"):
        tm.train_epoch(None, tg, None, None, pos, None, gen, 0.01, mesh=object())


def test_train_epoch_on_hybrid_runs():
    th, _, _, _ = _operands("GCN", "hybrid")
    rng = np.random.default_rng(0)
    src, dst = make_sbm_graph(rng, N, 2500, num_communities=5)
    sample_graph = tgraph.build_graph(src, dst, num_nodes=N, symmetrize=True, device="cpu")
    cfg = ModelConfig(encoder="GCN", emb_hidden_channels=8, gnn_hidden_channels=8,
                      mlp_hidden_channels=8, batch_size=128, dropout=0.3)
    tm = Model(cfg, N, device="cpu")
    before = params_to_jax(tm)["emb"]
    gen = torch.Generator().manual_seed(0)
    opt = tm.make_optimizer()
    with pytest.raises(ValueError, match="sample_graph"):
        tm.train_epoch(opt, th, None, None, np.stack([src, dst], 1), None, gen, 0.01)
    loss = tm.train_epoch(opt, th, None, None, np.stack([src, dst], 1), None, gen, 0.01,
                          sample_graph=sample_graph)
    assert np.isfinite(loss) and not np.array_equal(params_to_jax(tm)["emb"], before)


def test_dropout_semantics():
    x = torch.randn(400, 50)
    gen = torch.Generator().manual_seed(0)
    assert dropout(x, 0.5, gen, train=False) is x
    assert dropout(x, 0.0, gen, train=True) is x
    assert dropout(x, 0.3, None, train=True) is x
    out = dropout(x, 0.3, gen, True)
    kept = out != 0
    np.testing.assert_allclose(out[kept].numpy(), x[kept].numpy() / 0.7, rtol=1e-6)
    assert abs(float(kept.float().mean()) - 0.7) < 0.02


def test_remat_and_transformer():
    # remat recomputes each conv in the backward: bitwise the same gradients,
    # for SAGE over blocked CSR and TRANSFORMER over the hybrid operand
    for encoder, backend in (("SAGE", "csr"), ("TRANSFORMER", "hybrid")):
        tg, tgt, _, _ = _operands("GCN" if backend == "hybrid" else encoder, backend)
        grads = []
        for remat in (False, True):
            enc = Encoder(torch.Generator().manual_seed(0), encoder, W, W, 2)
            x = torch.randn(N, W, generator=torch.Generator().manual_seed(1), requires_grad=True)
            enc(tg, x, tgt, remat=remat).square().sum().backward()
            grads.append(x.grad)
        torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    assert list(enc.layers[0]) == ["lin_query", "lin_key", "lin_value", "lin_skip"]
    assert adjust_lr(0.01, 0.5) == jax_adjust_lr(0.01, 0.5)
    assert adjust_lr(0.01, 1.0) == jax_adjust_lr(0.01, 1.0)
