"""plnlp_tpu_torch predictors, grid scores and ``Scorer`` against plnlp_tpu
(CPU), with the JAX weights carried over by ``params_from_jax``.

Tolerance: float32 at rtol = atol = 1e-4 (sums and matmuls in another
order).  Top-k id lists must be equal where the scores have no ties; the
MLPDOT/MLPBIL width-1 towers tie often, so for them only the sorted top-k
scores are compared.  The encoders, metrics and ``Model.test`` are in
tests/test_torch_serve.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.graph as jgraph
import plnlp_tpu.ops.tile_spmm as jts
from plnlp_tpu.models.predictors import apply_predictor
from plnlp_tpu.models.predictors import grid_scores as jax_grid_scores
from plnlp_tpu.models.predictors import init_predictor
from plnlp_tpu.serve import Scorer as JaxScorer
from plnlp_tpu.training import Model as JaxModel
from plnlp_tpu.training import ModelConfig as JaxConfig
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.convert import params_from_jax
from plnlp_tpu_torch.data.synthetic import make_sbm_graph
from plnlp_tpu_torch.models.predictors import Predictor, grid_scores
from plnlp_tpu_torch.ops import tile_spmm as tts
from plnlp_tpu_torch.serve import Scorer
from plnlp_tpu_torch.training import Model, ModelConfig
from tests.test_torch_serve import N, TOL, W, _graphs, _models
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)


def _assert_topk_equal(got, want, distinct):
    ids_g, sc_g = got
    ids_w, sc_w = want
    np.testing.assert_allclose(sc_g, sc_w, **TOL)
    if distinct:
        np.testing.assert_array_equal(ids_g, ids_w)


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
