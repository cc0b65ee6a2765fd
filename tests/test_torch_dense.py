"""plnlp_tpu_torch's dense backend against plnlp_tpu (CPU).

* ``prepare_dense`` gives the JAX package's arrays exactly (one weight per
  cell after coalescing), with and without symmetrize; ``to_dense`` gives
  the same operand from a Graph.
* ``spmm`` over a ``DenseAdj``, sum and mean, values and the gradient of
  x: one matmul in another summation order, rtol = 1e-5, atol = 1e-6.
* All four encoders over a ``DenseAdj`` (the JAX weights carried over),
  values and the gradients of x and of every parameter, on a graph whose
  node 0 has no in-edge (TRANSFORMER gives it the skip term alone).
  Two layers of matmuls and a softmax in another order: rtol = 1e-5,
  atol = 1e-5 (the gradients of the last layer's bias sum all 48 rows).
* ``Scorer.rank_candidates_batch(exclude_edges=True)`` over a ``DenseAdj``
  returns the JAX Scorer's ids, with and without ``candidates=``; no known
  neighbor is ranked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.dense as jdense
from plnlp_tpu.models.encoders import apply_encoder, init_encoder
from plnlp_tpu.ops.spmm import spmm as jspmm
from plnlp_tpu.serve import Scorer as JaxScorer
from plnlp_tpu.training import Model as JaxModel
from plnlp_tpu.training import ModelConfig as JaxConfig
from plnlp_tpu_torch import dense as tdense
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.convert import _load, params_from_jax
from plnlp_tpu_torch.models import Encoder
from plnlp_tpu_torch.ops.spmm import spmm
from plnlp_tpu_torch.serve import Scorer
from plnlp_tpu_torch.training import Model, ModelConfig
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

TOL = dict(rtol=1e-5, atol=1e-6)
ENC_TOL = dict(rtol=1e-5, atol=1e-5)
N, D = 48, 12


def _edges(weighted=True, symmetric=False):
    """A multigraph with duplicates and self-loops; node 0 has no in-edge."""
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, N, 300), rng.integers(0, N, 300)
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    keep = (dst != 0) & (src != 0) if symmetric else dst != 0
    w = rng.random(len(src)).astype(np.float32) + 0.1 if weighted else None
    return src[keep], dst[keep], None if w is None else w[keep]


@pytest.mark.parametrize("symmetrize", [False, True])
def test_prepare_dense_matches_jax(symmetrize):
    src, dst, w = _edges()
    got = tdense.prepare_dense(src, dst, w, num_nodes=N, symmetrize=symmetrize, device="cpu")
    want = jdense.prepare_dense(src, dst, w, num_nodes=N, symmetrize=symmetrize)
    np.testing.assert_array_equal(got.adj.numpy(), np.asarray(want.adj))
    np.testing.assert_array_equal(got.in_degrees.numpy(), np.asarray(want.in_degrees))
    assert got.adj.dtype == torch.float32 and got.in_degrees.dtype == torch.int32
    g = tgraph.build_graph(src, dst, w, num_nodes=N, symmetrize=symmetrize, device="cpu")
    dev = tdense.to_dense(g)
    np.testing.assert_array_equal(dev.adj.numpy(), got.adj.numpy())
    np.testing.assert_array_equal(dev.in_degrees.numpy(), got.in_degrees.numpy())


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_spmm_dense_matches_jax(reduce):
    src, dst, w = _edges()
    td = tdense.prepare_dense(src, dst, w, num_nodes=N, device="cpu")
    jd = jdense.prepare_dense(src, dst, w, num_nodes=N)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, D)).astype(np.float32)
    cot = rng.standard_normal((N, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda xx: jspmm(jd, xx, reduce), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm(td, xt, reduce)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), **TOL)
    assert not out[0].any()  # no in-edge: 0 for sum and mean


@pytest.mark.parametrize("name", ["SAGE", "GCN", "WSAGE", "TRANSFORMER"])
def test_encoders_over_dense_match_jax(name):
    src, dst, w = _edges()
    if name == "GCN":
        src, dst, w = tgraph.gcn_normalize_edges(src, dst, w, N)
        # the self-loop GCN adds gives node 0 an in-edge: take it away again
        keep = dst != 0
        src, dst, w = src[keep], dst[keep], w[keep]
    elif name == "WSAGE":
        src, dst, w = tgraph.row_normalize_edges(src, dst, w, N)
    elif name == "TRANSFORMER":
        w = None
    td = tdense.prepare_dense(src, dst, w, num_nodes=N, device="cpu")
    jd = jdense.prepare_dense(src, dst, w, num_nodes=N)
    assert int(td.in_degrees[0]) == 0
    jp = init_encoder(jax.random.PRNGKey(2), name, D, D, 2)
    enc = Encoder(torch.Generator().manual_seed(0), name, D, D, 2)
    with torch.no_grad():
        _load(enc, jax.tree_util.tree_map(np.asarray, jp), "encoder", set())
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, D)).astype(np.float32)
    cot = rng.standard_normal((N, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, xx: apply_encoder(p, name, jd, xx), jp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = enc(td, xt)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **ENC_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **ENC_TOL)
    assert all(torch.isfinite(p.grad).all() for p in enc.parameters())
    got_p = {"layers": [
        {lname: {"w": lin.weight.grad.numpy().T,
                 **({"b": lin.bias.grad.numpy()} if lin.bias is not None else {})}
         for lname, lin in layer.items()} for layer in enc.layers]}
    got_leaves = jax.tree_util.tree_leaves_with_path(got_p)
    want_leaves = jax.tree_util.tree_leaves_with_path(gp)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=jax.tree_util.keystr(path),
                                   **ENC_TOL)


def test_scorer_excludes_edges_over_dense_matches_jax():
    src, dst, _ = _edges(weighted=False, symmetric=True)
    td = tdense.prepare_dense(src, dst, None, num_nodes=N, device="cpu")
    jd = jdense.prepare_dense(src, dst, None, num_nodes=N)
    cfg = dict(encoder="SAGE", predictor="DOT", emb_hidden_channels=D, gnn_hidden_channels=D,
               mlp_hidden_channels=D)
    jm = JaxModel(JaxConfig(**cfg), num_nodes=N)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = Model(ModelConfig(**cfg), num_nodes=N, device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    js, ts = JaxScorer(jm, jp, jd), Scorer(tm, td)
    rng = np.random.default_rng(6)
    srcs = rng.integers(0, N, 9)
    cands = rng.permutation(N)[:30]
    adj = td.adj.numpy()
    for kw in (dict(k=7), dict(candidates=cands, k=5)):
        ids, scores = ts.rank_candidates_batch(srcs, exclude_edges=True, **kw)
        ids_j, scores_j = js.rank_candidates_batch(srcs, exclude_edges=True, **kw)
        np.testing.assert_array_equal(ids, ids_j)
        np.testing.assert_allclose(scores, scores_j, rtol=1e-5, atol=1e-6)
        for row, s in zip(ids, srcs):
            assert not adj[s, row].any()  # no known neighbor ranked
