"""plnlp_tpu_torch serving path against plnlp_tpu (CPU): encoders,
predictors, metrics, Model.test and Scorer, with the JAX weights carried
over by ``params_from_jax``.

Tolerance through the model: float32 at rtol = atol = 1e-4 (sums and
matmuls in another order).  Top-k id lists must be equal where the scores
have no ties; the MLPDOT/MLPBIL width-1 towers tie often, so for them only
the sorted top-k scores are compared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.graph as jgraph
import plnlp_tpu.metrics as jmetrics
import plnlp_tpu.ops.tile_spmm as jts
from plnlp_tpu.models.predictors import apply_predictor
from plnlp_tpu.models.predictors import grid_scores as jax_grid_scores
from plnlp_tpu.models.predictors import init_predictor
from plnlp_tpu.serve import Scorer as JaxScorer
from plnlp_tpu.training import Model as JaxModel
from plnlp_tpu.training import ModelConfig as JaxConfig
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch import metrics as tmetrics
from plnlp_tpu_torch.convert import params_from_jax
from plnlp_tpu_torch.data.synthetic import make_sbm_graph
from plnlp_tpu_torch.models.predictors import Predictor, grid_scores
from plnlp_tpu_torch.ops import tile_spmm as tts
from plnlp_tpu_torch.serve import Scorer
from plnlp_tpu_torch.training import Model, ModelConfig

TOL = dict(rtol=1e-4, atol=1e-4)
N = 150
W = 16


@functools.lru_cache(maxsize=None)
def _graphs(encoder, n=N):
    # symmetric edge list, so exclude_edges masks true neighbors
    rng = np.random.default_rng(7)
    src = rng.integers(0, n, 6 * n)
    dst = rng.integers(0, n, 6 * n)
    keep = src != dst
    src, dst = np.concatenate([src[keep], dst[keep]]), np.concatenate([dst[keep], src[keep]])
    w = None
    if encoder == "GCN":
        src, dst, w = jgraph.gcn_normalize_edges(src, dst, None, n)
    elif encoder == "WSAGE":
        src, dst, w = jgraph.row_normalize_edges(src, dst, None, n)
    kw = dict(num_nodes=n, block=(16, 32))
    tg, tgt = tgraph.prepare_graph(src, dst, w, device="cpu", **kw)
    jg, jgt = jgraph.prepare_graph(src, dst, w, **kw)
    return tg, tgt, jg, jgt


@functools.lru_cache(maxsize=None)
def _models(encoder="SAGE", predictor="DOT", **extra):
    """(JAX model, JAX params, port model with those params); cached so a
    configuration's JAX jits compile once per test process."""
    kw = dict(
        encoder=encoder, predictor=predictor, emb_hidden_channels=W,
        gnn_hidden_channels=W, mlp_hidden_channels=W, batch_size=64, **extra,
    )
    jm = JaxModel(JaxConfig(**kw), num_nodes=N)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tm = Model(ModelConfig(**kw), num_nodes=N, device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    return jm, jp, tm


@pytest.mark.parametrize(
    "encoder,layers", [("SAGE", 1), ("SAGE", 2), ("GCN", 2), ("WSAGE", 2)]
)
def test_encode_matches_jax(encoder, layers):
    tg, tgt, jg, jgt = _graphs(encoder)
    jm, jp, tm = _models(encoder, gnn_num_layers=layers)
    want = np.asarray(jm._encode(jp, jg, jgt, None))
    got = tm.encode(tg, tgt).numpy()
    assert got.shape == (N + 1, W)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "use_feats,train_emb,pretrained",
    [(True, True, False), (True, False, True), (False, True, True)],
)
def test_input_layer_sizing_matches_jax(use_feats, train_emb, pretrained):
    """emb ⊕ node features, and frozen pretrained tables, as in plnlp_tpu."""
    tg, tgt, jg, jgt = _graphs("SAGE")
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((N, 5)).astype(np.float32)
    pre = rng.standard_normal((N, 6)).astype(np.float32) if pretrained else None
    kw = dict(
        emb_hidden_channels=W, gnn_hidden_channels=W, mlp_hidden_channels=W,
        use_node_feats=use_feats, train_node_emb=train_emb,
    )
    jm = JaxModel(JaxConfig(**kw), N, 5, pre)
    jp = jm.init_params(jax.random.PRNGKey(4))
    tm = Model(ModelConfig(**kw), N, 5, pre, device="cpu")
    assert (tm.input_dim, tm.emb_dim, tm.emb_trainable) == (
        jm.input_dim, jm.emb_dim, jm.emb_trainable
    )
    params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    want = jm._encode(jp, jg, jgt, jnp.asarray(feats) if use_feats else None)
    got = tm.encode(tg, tgt, feats if use_feats else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["DOT", "BIL", "MLP", "MLPDOT", "MLPBIL", "MLPCAT"])
def test_predictor_and_grid_scores_match_jax(rng, name):
    params = init_predictor(jax.random.PRNGKey(2), name, W, 3)
    pred = Predictor(torch.Generator().manual_seed(0), name, W, 3)
    holder = torch.nn.Module()
    holder.predictor = pred
    params_from_jax({"predictor": jax.tree_util.tree_map(np.asarray, params)}, holder)
    xi, xj = (rng.standard_normal((40, W)).astype(np.float32) for _ in range(2))
    want = apply_predictor(params, name, jnp.asarray(xi), jnp.asarray(xj))
    with torch.no_grad():
        got = pred(torch.from_numpy(xi), torch.from_numpy(xj))
        grid = grid_scores(pred, torch.from_numpy(xi[:7]), torch.from_numpy(xj))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_grid = jax_grid_scores(params, name, jnp.asarray(xi[:7]), jnp.asarray(xj))
    if want_grid is None:
        assert grid is None
    else:
        np.testing.assert_allclose(grid.numpy(), np.asarray(want_grid), **TOL)


def test_metrics_match_jax(rng):
    pos = rng.standard_normal(300).astype(np.float32)
    neg = rng.standard_normal(80).astype(np.float32)
    ks = (1, 20, 50, 100)  # 100 > #neg -> 1.0
    got = tmetrics.evaluate_hits(pos, neg, pos[:50], neg[:30], ks=ks)
    want = jmetrics.evaluate_hits(pos, neg, pos[:50], neg[:30], ks=ks)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert got["Hits@100"] == (1.0, 1.0)
    # MRR with exact ties (rounded scores)
    pos_m = np.round(rng.standard_normal(60), 1).astype(np.float32)
    neg_m = np.round(rng.standard_normal((60, 20)), 1).astype(np.float32)
    got_m = tmetrics.evaluate_mrr(pos_m, neg_m, pos_m[:10], neg_m[:10])
    want_m = jmetrics.evaluate_mrr(pos_m, neg_m, pos_m[:10], neg_m[:10])
    np.testing.assert_allclose(got_m["MRR"], want_m["MRR"], rtol=1e-6)


@pytest.mark.parametrize("metric", ["hits", "mrr"])
def test_model_test_matches_jax(rng, metric):
    tg, tgt, jg, jgt = _graphs("SAGE")
    jm, jp, tm = _models("SAGE", "MLP")
    if metric == "hits":
        split = {
            s: {"pos": rng.integers(0, N, (30, 2)), "neg": rng.integers(0, N, (70, 2))}
            for s in ("valid", "test")
        }
    else:
        split = {
            s: {"pos": rng.integers(0, N, (20, 2)), "neg": rng.integers(0, N, (200, 2))}
            for s in ("valid", "test")
        }
    want = jm.test(
        jp, jg, jgt, None,
        {s: {k: jnp.asarray(v) for k, v in d.items()} for s, d in split.items()},
        metric,
    )
    got = tm.test(tg, tgt, None, split, metric)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def _assert_topk_equal(got, want, distinct):
    ids_g, sc_g = got
    ids_w, sc_w = want
    np.testing.assert_allclose(sc_g, sc_w, **TOL)
    if distinct:
        np.testing.assert_array_equal(ids_g, ids_w)


@pytest.mark.parametrize("predictor", ["DOT", "MLP", "MLPBIL"])
def test_scorer_matches_jax(rng, predictor):
    tg, tgt, jg, jgt = _graphs("SAGE")
    jm, jp, tm = _models("SAGE", predictor)
    js, ts = JaxScorer(jm, jp, jg, jgt), Scorer(tm, tg, tgt)
    np.testing.assert_allclose(ts.h.numpy(), np.asarray(js.h), **TOL)

    pairs = rng.integers(-1, N, (97, 2))
    np.testing.assert_allclose(ts.score(pairs), js.score(pairs), **TOL)

    distinct = predictor != "MLPBIL"
    srcs = rng.integers(0, N, 9)
    cands = rng.permutation(N)[:40]
    for kw in (
        dict(k=6),
        dict(k=6, exclude_edges=True),
        dict(candidates=cands, k=5, exclude_edges=True),
    ):
        _assert_topk_equal(
            ts.rank_candidates_batch(srcs, **kw), js.rank_candidates_batch(srcs, **kw),
            distinct,
        )
    ids, scores = ts.rank_candidates(int(srcs[0]), k=6)
    np.testing.assert_allclose(scores, js.rank_candidates(int(srcs[0]), k=6)[1], **TOL)
    assert ids.shape == (6,)


def test_scorer_exclude_edges_and_chunking(rng, monkeypatch):
    """exclude_edges drops known neighbors; source chunking is value-neutral."""
    tg, tgt, _, _ = _graphs("SAGE")
    _, _, tm = _models("SAGE", "DOT")
    ts = Scorer(tm, tg, tgt)
    indptr, senders = tg.indptr.numpy(), tg.senders.numpy()
    srcs = np.arange(0, N, 13)
    ids, scores = ts.rank_candidates_batch(srcs, k=10, exclude_edges=True)
    for row, s in zip(ids, srcs):
        assert not set(row.tolist()) & set(senders[indptr[s]:indptr[s + 1]].tolist())
    assert np.isfinite(scores).all()
    monkeypatch.setattr(Scorer, "_MAX_GRID_PAIRS", 1)
    ids_c, scores_c = ts.rank_candidates_batch(srcs, k=10, exclude_edges=True)
    np.testing.assert_array_equal(ids_c, ids)
    np.testing.assert_allclose(scores_c, scores, rtol=1e-6)


def test_scorer_excludes_edges_over_hybrid_matches_jax(rng):
    """Over the hybrid operand (a 600-node SBM at T = 32, relabeled to
    community order as the CLI builds it) the Scorer reads the known edges
    from ``exclude_graph``, the CSR twin, as the JAX Scorer does; without it
    ranking with ``exclude_edges=True`` raises a ValueError naming it."""
    n = 600
    src, dst = make_sbm_graph(np.random.default_rng(5), n, 6000, num_communities=12)
    src, dst, _ = tgraph.to_undirected_edges(src, dst, None, n)
    relabel = np.empty(n, np.int64)
    relabel[tts.label_prop_order(src, dst, n)] = np.arange(n)
    src, dst = relabel[src], relabel[dst]
    kw = dict(num_nodes=n, tile=32, min_fill=12, block=(32, 64), reorder=None)
    th, jh = tts.build_hybrid(src, dst, device="cpu", **kw), jts.build_hybrid(src, dst, **kw)
    assert th.num_tiles > 0 and th.res_edges > 0
    tg, _ = tgraph.prepare_graph(src, dst, None, num_nodes=n, block=None, device="cpu")
    jg, _ = jgraph.prepare_graph(src, dst, None, num_nodes=n, block=None)
    cfg = dict(encoder="SAGE", predictor="DOT", emb_hidden_channels=W, gnn_hidden_channels=W,
               mlp_hidden_channels=W)
    jm = JaxModel(JaxConfig(**cfg), num_nodes=n)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = Model(ModelConfig(**cfg), num_nodes=n, device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    js, ts = JaxScorer(jm, jp, jh, exclude_graph=jg), Scorer(tm, th, exclude_graph=tg)
    srcs = rng.integers(0, n, 12)
    cands = rng.permutation(n)[:90]
    indptr, senders = tg.indptr.numpy(), tg.senders.numpy()
    for kw in (dict(k=8), dict(candidates=cands, k=6)):
        got = ts.rank_candidates_batch(srcs, exclude_edges=True, **kw)
        _assert_topk_equal(got, js.rank_candidates_batch(srcs, exclude_edges=True, **kw), True)
        for row, s in zip(got[0], srcs):
            assert not set(row.tolist()) & set(senders[indptr[s]:indptr[s + 1]].tolist())
    ts_hg = Scorer(tm, th)
    np.testing.assert_allclose(ts_hg.score(np.stack([srcs, srcs[::-1]], 1)),
                               js.score(np.stack([srcs, srcs[::-1]], 1)), **TOL)
    with pytest.raises(ValueError, match="exclude_graph"):
        ts_hg.rank_candidates_batch(srcs, k=8, exclude_edges=True)


def test_params_from_jax_rejects_mismatches():
    _, jp, _ = _models("SAGE", "MLP")
    jp = jax.tree_util.tree_map(np.asarray, jp)
    tm = Model(_models("SAGE", "MLP")[2].cfg, num_nodes=N, device="cpu")
    params_from_jax(jp, tm)
    np.testing.assert_array_equal(tm.encoder.layers[0]["lin_l"].weight.detach().numpy(),
                                  jp["encoder"]["layers"][0]["lin_l"]["w"].T)
    with pytest.raises(ValueError, match="not in the JAX tree"):
        params_from_jax({k: v for k, v in jp.items() if k != "predictor"}, tm)
    bad = dict(jp, emb=np.zeros((N + 1, W), np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, tm)


def test_model_rejects_unported_options():
    # TRANSFORMER is ported over a HybridGraph, a DenseAdj and a CSR Graph;
    # other operands (GraphParallel) are not
    tm = Model(ModelConfig(encoder="TRANSFORMER", emb_hidden_channels=4,
                           gnn_hidden_channels=4), num_nodes=4, device="cpu")
    with pytest.raises(NotImplementedError, match="TRANSFORMER over"):
        tm.encode(object())
