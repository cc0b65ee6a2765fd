"""plnlp_tpu_torch serving path against plnlp_tpu (CPU): encoders,
metrics and Model.test, with the JAX weights carried over by
``params_from_jax``; the predictors and the Scorer are held in
tests/test_torch_scorer.py.

Tolerance through the model: float32 at rtol = atol = 1e-4 (sums and
matmuls in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import plnlp_tpu.graph as jgraph
import plnlp_tpu.metrics as jmetrics
from plnlp_tpu.training import Model as JaxModel
from plnlp_tpu.training import ModelConfig as JaxConfig
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch import metrics as tmetrics
from plnlp_tpu_torch.convert import params_from_jax
from plnlp_tpu_torch.training import Model, ModelConfig
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

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
