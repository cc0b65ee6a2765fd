"""plnlp_tpu_torch's blocked TransformerConv (``ops/transformer.py``, the
hand-written backward on K1 over ``tconv_map``) against plnlp_tpu (CPU).

* ``prepare_graph(couple_transpose=True)``'s ``tconv_map`` by what it
  means: every live slot of the transposed graph points at the forward
  slot of the same (src, dst) edge, each forward slot once, padding slots
  at 0; with duplicate edges and self loops too.  (The port's block layout
  has no TPU residue pad, so the array differs from the JAX one.)
* ``transformer_conv_blocked`` against the JAX hand VJP
  (``couple_transpose=True`` on both sides; JAX side jitted), on a random
  graph, on one with isolated rows and rows of one in-edge (dlogit exactly
  0 at live slots: K1 skips them), and on one with duplicate edges and self
  loops.  float32: through ``Encoder`` (2 layers) against
  ``apply_encoder(..., gb, graph_t=gbt)``, values and the gradients of x
  and of all eight q/k/v/skip parameters a layer at rtol 1e-4, atol 1e-5
  (as tests/test_transformer_vjp.py).  bfloat16 at rtol 3e-2, atol 1e-2
  (the JAX package rounds each logit to bf16, the port keeps it f32):
  ``Encoder``'s values, and one layer's values, x gradient and each
  linear's weight and bias gradients taken together, with atol scaled by
  the array's largest magnitude (test_transformer_vjp.py's idiom; they are
  sums over every node, and the key bias's is rounding residue of an exact
  0).  Gradients through the 2-layer stack are not held in bf16: a hidden
  value within a bf16 rounding of 0 lands on either side of the relu in
  two computations that round in other places, and the flip gates a whole
  cotangent (JAX's own bf16 x gradient misses its f32 one by up to 14x
  this tolerance there).
* Dispatch: the blocked path is taken only with ``tconv_map`` (a counting
  stub in place of ``ops.transformer``'s entry), K1 runs once a layer
  forward and three times backward, and the entry raises ``ValueError``
  without the map.
* ``remat=True`` gives the same values and gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.graph as jgraph
from plnlp_tpu.models.encoders import apply_encoder, init_encoder
from plnlp_tpu.ops.transformer import transformer_conv_blocked as jax_conv
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.convert import _load
from plnlp_tpu_torch.models import Encoder
from plnlp_tpu_torch.ops import transformer as ttf
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=1e-2)
D = 16
BLOCK = (8, 32)


def _edges(case):
    """(num_nodes, src, dst, coalesce) of a small graph."""
    rng = np.random.default_rng(5)
    if case == "random":
        n = 90
        return n, rng.integers(0, n, 500), rng.integers(0, n, 500), True
    if case == "sparse":
        # rows 0..59 take ~8 in-edges each, rows 60..79 exactly one (their
        # softmax is 1, their dlogit exactly 0), rows 80..95 none
        n = 96
        s1, d1 = rng.integers(0, n, 480), rng.integers(0, 60, 480)
        s2, d2 = rng.integers(0, n, 20), np.arange(60, 80)
        return n, np.concatenate([s1, s2]), np.concatenate([d1, d2]), True
    # duplicate edges and self loops, kept apart (no coalesce)
    n = 24
    src = np.array([0, 0, 0, 1, 2, 3, 3, 5, 5, 5, 7, 23] * 3)
    dst = np.array([1, 1, 2, 0, 0, 3, 4, 6, 6, 6, 7, 0] * 3)
    return n, src, dst, False


@functools.lru_cache(maxsize=None)
def _graphs(case):
    n, src, dst, coalesce = _edges(case)
    kw = dict(num_nodes=n, block=BLOCK, coalesce=coalesce, couple_transpose=True)
    return n, tgraph.prepare_graph(src, dst, None, device="cpu", **kw), \
        jgraph.prepare_graph(src, dst, None, **kw)


@pytest.mark.parametrize("case", ["random", "sparse", "duplicates"])
def test_tconv_map_pairs_each_transposed_slot_with_its_edge(case):
    n, (g, gt), _ = _graphs(case)
    tmap = g.tconv_map
    assert tmap.dtype == torch.int32 and tmap.shape == gt.blk_src.shape
    f_src, f_dst = g.blk_src.reshape(-1), ttf._slot_dst(g).reshape(-1)
    f_w = g.blk_weight.reshape(-1)
    live_t = (gt.blk_weight != 0).reshape(-1)
    t_map = tmap.reshape(-1).long()
    # a transposed slot's source is the edge's destination, its row the source
    t_src, t_row = gt.blk_src.reshape(-1), ttf._slot_dst(gt).reshape(-1)
    assert torch.equal(f_src[t_map[live_t]], t_row[live_t])
    assert torch.equal(f_dst[t_map[live_t]].int(), t_src[live_t])
    assert torch.equal(f_w[t_map[live_t]], gt.blk_weight.reshape(-1)[live_t])
    # a bijection onto the live forward slots; padding slots point at 0
    assert sorted(t_map[live_t].tolist()) == torch.nonzero(f_w != 0)[:, 0].tolist()
    assert not t_map[~live_t].any()
    assert int(live_t.sum()) == g.num_edges
    if case == "duplicates":
        assert g.num_edges == 36 and int(((f_src == f_dst) & (f_w != 0)).sum()) == 6


def test_couple_transpose_needs_blocks():
    with pytest.raises(ValueError, match="couple_transpose"):
        tgraph.prepare_graph([0, 1], [1, 0], num_nodes=2, block=None, couple_transpose=True,
                             device="cpu")


def _encoder_pair(n_layers, key):
    jp = init_encoder(jax.random.PRNGKey(key), "TRANSFORMER", D, D, n_layers)
    enc = Encoder(torch.Generator().manual_seed(0), "TRANSFORMER", D, D, n_layers)
    with torch.no_grad():
        _load(enc, jax.tree_util.tree_map(np.asarray, jp), "encoder", set())
    return jp, enc


def _f32(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a).astype(np.float32)


def _inputs(n, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)).astype(np.float32),
            rng.standard_normal((n, D)).astype(np.float32))


def _linear_grads(layer):
    """{linear: (weight (in, out) as JAX holds it, bias)} gradients."""
    return {name: (lin.weight.grad.numpy().T, lin.bias.grad.numpy())
            for name, lin in layer.items()}


@pytest.mark.parametrize("case", ["random", "sparse", "duplicates"])
def test_blocked_transformer_matches_jax(case):
    n, (g, gt), (jg, jgt) = _graphs(case)
    assert jg.tconv_map is not None
    jp, enc = _encoder_pair(2, key=1)
    x, cot = _inputs(n)

    @jax.jit
    def reference(p, xx):
        out, vjp = jax.vjp(
            lambda p, xx: apply_encoder(p, "TRANSFORMER", jg, xx, graph_t=jgt), p, xx)
        return out, vjp(jnp.asarray(cot))

    want, (gp, gx) = reference(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = enc(g, xt, gt)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **F32_TOL)
    for i, layer in enumerate(enc.layers):
        for name, (w, b) in _linear_grads(layer).items():
            jl = gp["layers"][i][name]
            np.testing.assert_allclose(w, np.asarray(jl["w"]), err_msg=f"{i} {name}", **F32_TOL)
            np.testing.assert_allclose(b, np.asarray(jl["b"]), err_msg=f"{i} {name}", **F32_TOL)


@pytest.mark.parametrize("case", ["random", "sparse", "duplicates"])
def test_blocked_transformer_bf16_matches_jax(case):
    n, (g, gt), (jg, jgt) = _graphs(case)
    jp, enc = _encoder_pair(2, key=1)
    x, cot = _inputs(n)
    xb, cb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(cot).astype(jnp.bfloat16)

    @jax.jit
    def reference(p, xx):
        h = apply_encoder(p, "TRANSFORMER", jg, xx, graph_t=jgt)
        out, vjp = jax.vjp(lambda lp, xx: jax_conv(lp, jg, jgt, xx), p["layers"][0], xx)
        return h, out, vjp(cb)

    want_h, want, (gp, gx) = reference(jp, xb)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    with torch.no_grad():
        h = enc(g, xt, gt)
    assert h.dtype == torch.bfloat16 and h.shape == (n, D)
    np.testing.assert_allclose(_f32(h), _f32(want_h), **BF16_TOL)
    out = ttf.transformer_conv_blocked(enc.layers[0], g, gt, xt)
    out.backward(torch.from_numpy(cot).to(torch.bfloat16))
    assert out.dtype == xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(want), **BF16_TOL)
    np.testing.assert_allclose(_f32(xt.grad), _f32(gx), **BF16_TOL)
    for name, (w, b) in _linear_grads(enc.layers[0]).items():
        assert w.dtype == b.dtype == np.float32  # the f32 parameters' gradients
        got = np.concatenate([w.reshape(-1), b])
        ref = np.concatenate([_f32(gp[name]["w"]).reshape(-1), _f32(gp[name]["b"])])
        np.testing.assert_allclose(got, ref, rtol=BF16_TOL["rtol"],
                                   atol=BF16_TOL["atol"] * max(1.0, np.abs(ref).max()),
                                   err_msg=name)


def test_blocked_path_only_with_tconv_map(monkeypatch):
    n, (g, gt), _ = _graphs("random")
    src, dst = g.senders.numpy(), g.receivers.numpy()
    plain, plain_t = tgraph.prepare_graph(src, dst, None, num_nodes=n, block=BLOCK,
                                          device="cpu")
    assert plain.tconv_map is None
    _, enc = _encoder_pair(2, key=2)
    x = torch.randn(n, D, generator=torch.Generator().manual_seed(0))
    real, k1 = ttf.transformer_conv_blocked, ttf.scatter_matmul
    entries, launches = [], []

    def entry(*a):
        entries.append(1)
        return real(*a)

    def count_k1(*a):
        launches.append(a[3].dtype)
        return k1(*a)

    monkeypatch.setattr(ttf, "transformer_conv_blocked", entry)
    monkeypatch.setattr(ttf, "scatter_matmul", count_k1)
    out = enc(g, x.clone().requires_grad_(True), gt)
    assert len(entries) == 2 and len(launches) == 2  # a launch a layer forward
    out.sum().backward()
    assert len(launches) == 8  # and three a layer backward
    for graph, graph_t in ((plain, plain_t), (g, None), (plain, None)):
        ref = enc(graph, x, graph_t)
        torch.testing.assert_close(ref, out.detach(), rtol=1e-5, atol=1e-6)
    assert len(entries) == 2 and len(launches) == 8  # the per-edge path ran
    with pytest.raises(ValueError, match="couple_transpose=True"):
        real(enc.layers[0], plain, plain_t, x)


def test_blocked_transformer_remat():
    n, (g, gt), _ = _graphs("sparse")
    _, enc = _encoder_pair(2, key=3)
    x = torch.randn(n, D, generator=torch.Generator().manual_seed(1))
    cot = torch.randn(n, D, generator=torch.Generator().manual_seed(2))
    runs = []
    for remat in (False, True):
        enc.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_(True)
        out = enc(g, xx, gt, remat=remat)
        out.backward(cot)
        runs.append([out.detach(), xx.grad] + [p.grad for p in enc.parameters()])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
