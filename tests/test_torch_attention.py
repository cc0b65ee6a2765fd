"""plnlp_tpu_torch TRANSFORMER over the hybrid operand against plnlp_tpu (CPU).

* The plain versions of K3, K4 and K5 (``ops/flash_tiles.py``, which the
  CUDA kernels are held to on the card) against the Pallas kernels of
  ``plnlp_tpu/ops/pallas_attention.py`` in interpret mode, called directly,
  with int8 and f32 tile stores and a row tile that no tile reaches (the
  port zero-fills it, num = 0, den = 0, m = -inf; the TPU kernels leave it
  undefined, so only covered row tiles are compared), and the zero-tile
  operand (port only: the JAX package takes its scan path there).
  float32 sums in another order: rtol = atol = 1e-5.
* ``hybrid_transformer_conv`` through the encoder stack, values and the
  gradients of x and of every q/k/v/skip parameter, against JAX's
  ``apply_encoder(..., "TRANSFORMER", hg, x)`` (on the CPU the JAX package
  takes its scan path, its plain reference): perm-free under padded-carry,
  with the label-prop relabel (perm_in/perm_out), with no residual, and
  with residual-only and isolated rows.  Softmax sums in another order:
  rtol = 1e-4, atol = 1e-5.
* The per-edge path over a CSR ``Graph`` against JAX's, same tolerance,
  and ``sddmm_dot`` at 1e-5.
* One joint optimizer step with TRANSFORMER + MLP + CE over the hybrid
  operand against the JAX ``_train_step``, under SGD: loss at rtol = atol =
  1e-5, the parameters after the step at rtol = atol = 1e-4.  Not Adam: the
  key bias adds q_i·b to every logit of row i, which the softmax cancels,
  so its gradient is exactly 0 and in float32 is rounding residue that
  Adam turns into steps of ±lr (as for the MLP's last bias under a pairwise
  loss, tests/test_torch_train.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.graph as jgraph
import plnlp_tpu.ops.pallas_attention as jpa
import plnlp_tpu.ops.sddmm as jsd
import plnlp_tpu.ops.tile_spmm as jts
from plnlp_tpu.models.encoders import apply_encoder, init_encoder
from plnlp_tpu.training import Model as JaxModel
from plnlp_tpu.training import ModelConfig as JaxConfig
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.convert import _load, params_from_jax, params_to_jax
from plnlp_tpu_torch.data.synthetic import make_sbm_graph
from plnlp_tpu_torch.models import Encoder
from plnlp_tpu_torch.ops import flash_tiles as ft
from plnlp_tpu_torch.ops import sddmm as tsd
from plnlp_tpu_torch.ops import tile_spmm as tts
from plnlp_tpu_torch.training import Model, ModelConfig
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)

T, D, NR = 16, 8, 5
COVERED = (0, 1, 3)  # row tiles 2 and 4 get no tile


def _tile_case(store):
    """A row-sorted tile set over NR row tiles (2 and 4 uncovered), its
    transpose, random features and row stats."""
    rng = np.random.default_rng(7)
    nt = 6
    trow = np.sort(rng.choice(COVERED, nt)).astype(np.int32)
    tcol = rng.integers(0, NR, nt).astype(np.int32)
    mask = rng.random((nt, T, T)) < 0.3
    mask[:, :3] = False  # the first 3 rows of every row tile have no edge
    if store is np.int8:
        vals = (mask * rng.integers(1, 4, (nt, T, T))).astype(np.int8)
    else:
        vals = (mask * rng.standard_normal((nt, T, T))).astype(np.float32)
    order = np.lexsort((trow, tcol))
    vals_t = np.ascontiguousarray(vals.transpose(0, 2, 1)[order])
    trow_t, tcol_t = tcol[order], trow[order]
    rows = NR * T
    q, k, v, g = (rng.standard_normal((rows, D)).astype(np.float32) for _ in range(4))
    stats = np.stack([rng.standard_normal(rows), rng.random(rows) + 0.5,
                      rng.standard_normal(rows)], 1).astype(np.float32)
    return dict(vals=vals, trow=trow, tcol=tcol, vals_t=vals_t, trow_t=trow_t, tcol_t=tcol_t,
                q=q, k=k, v=v, g=g, stats=stats)


def _ptr(rows):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=NR))])
                            .astype(np.int32))


def _covered(rows):
    return np.repeat(np.isin(np.arange(NR), rows), T)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


SCALE = 1.0 / np.sqrt(D)


@pytest.mark.parametrize("store", [np.int8, np.float32])
def test_flash_fwd_plain_matches_pallas_interpret(store):
    c = _tile_case(store)
    qt, kt, vt = (jnp.asarray(c[x].reshape(NR, T, D)) for x in "qkv")
    num_j, stats_j = jpa.flash_tiles_fwd(jnp.asarray(c["vals"]), jnp.asarray(c["trow"]),
                                         jnp.asarray(c["tcol"]), qt, kt, vt, NR, float(SCALE),
                                         interpret=True)
    before = dict(ft.LAUNCHES)
    num, ml = ft.flash_tiles_fwd(_t(c["vals"]), _t(c["trow"]), _t(c["tcol"]), _ptr(c["trow"]),
                                 _t(c["q"]), _t(c["k"]), _t(c["v"]), SCALE)
    assert ft.LAUNCHES == before  # the CPU path is no kernel launch
    cov = _covered(c["trow"])
    num, ml = num.numpy(), ml.numpy()
    stats_j = np.asarray(stats_j)
    np.testing.assert_allclose(num[cov], np.asarray(num_j)[cov], **KERNEL_TOL)
    np.testing.assert_allclose(ml[cov, 1], stats_j[cov, 0], **KERNEL_TOL)  # den
    np.testing.assert_allclose(ml[cov, 0], stats_j[cov, 1], **KERNEL_TOL)  # m (-inf where no edge)
    assert np.isneginf(ml[cov, 0]).any()  # rows of covered tiles with no edge
    np.testing.assert_array_equal(num[~cov], 0.0)
    np.testing.assert_array_equal(ml[~cov, 1], 0.0)
    assert np.isneginf(ml[~cov, 0]).all()


@pytest.mark.parametrize("store", [np.int8, np.float32])
def test_flash_dq_dkv_plain_match_pallas_interpret(store):
    c = _tile_case(store)
    qt, kt, vt, gt = (jnp.asarray(c[x].reshape(NR, T, D)) for x in "qkvg")
    stat = jnp.asarray(c["stats"])
    dq_j = jpa.flash_tiles_dq(jnp.asarray(c["vals"]), jnp.asarray(c["trow"]),
                              jnp.asarray(c["tcol"]), qt, kt, vt, gt, jpa.pack_mdd(stat), NR,
                              float(SCALE), interpret=True)
    dk_j, dv_j = jpa.flash_tiles_dkv(jnp.asarray(c["vals_t"]), jnp.asarray(c["trow_t"]),
                                     jnp.asarray(c["tcol_t"]), qt, kt, vt, gt,
                                     jpa.pack_mdd_t(stat, T), NR, float(SCALE), interpret=True)
    feats = [_t(c[x]) for x in "qkvg"]
    dq = ft.flash_tiles_dq(_t(c["vals"]), _t(c["trow"]), _t(c["tcol"]), _ptr(c["trow"]),
                           *feats, _t(c["stats"]), SCALE).numpy()
    dk, dv = (a.numpy() for a in ft.flash_tiles_dkv(
        _t(c["vals_t"]), _t(c["trow_t"]), _t(c["tcol_t"]), _ptr(c["trow_t"]), *feats,
        _t(c["stats"]), SCALE))
    cov, cov_t = _covered(c["trow"]), _covered(c["trow_t"])
    np.testing.assert_allclose(dq[cov], np.asarray(dq_j)[cov], **KERNEL_TOL)
    np.testing.assert_allclose(dk[cov_t], np.asarray(dk_j)[cov_t], **KERNEL_TOL)
    np.testing.assert_allclose(dv[cov_t], np.asarray(dv_j)[cov_t], **KERNEL_TOL)
    np.testing.assert_array_equal(dq[~cov], 0.0)
    np.testing.assert_array_equal(dk[~cov_t], 0.0)
    np.testing.assert_array_equal(dv[~cov_t], 0.0)


def test_flash_plain_versions_take_zero_tiles_and_ragged_rows():
    """nt = 0 gives the empty partials, so the residual alone decides; and
    rows that are not a multiple of T (stats past them read (0, 1, 0))."""
    c = _tile_case(np.int8)
    rows = NR * T - 5
    feats = [_t(c[x][:rows]) for x in "qkvg"]
    stats = _t(c["stats"][:rows])
    empty = torch.zeros((0, T, T), dtype=torch.int8)
    none = torch.zeros(0, dtype=torch.int32)
    ptr0 = torch.zeros(NR + 1, dtype=torch.int32)
    num, ml = ft.flash_tiles_fwd(empty, none, none, ptr0, *feats[:3], SCALE)
    assert num.shape == (rows, D) and not num.any() and not ml[:, 1].any()
    assert torch.isneginf(ml[:, 0]).all()
    assert not ft.flash_tiles_dq(empty, none, none, ptr0, *feats, stats, SCALE).any()
    assert not any(a.any() for a in ft.flash_tiles_dkv(empty, none, none, ptr0, *feats, stats,
                                                        SCALE))
    # ragged rows read as zero features and stats (0, 1, 0): the same as
    # padding them so by hand
    args = (_t(c["vals"]), _t(c["trow"]), _t(c["tcol"]), _ptr(c["trow"]))
    padded = [torch.cat([a, a.new_zeros((5, D))]) for a in feats]
    stats_p = torch.cat([stats, torch.tensor([[0.0, 1.0, 0.0]] * 5)])
    got = ft.flash_tiles_dq(*args, *feats, stats, SCALE)
    assert got.shape == (rows, D)
    torch.testing.assert_close(got, ft.flash_tiles_dq(*args, *padded, stats_p, SCALE)[:rows],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="stats"):
        ft.flash_tiles_dq(*args, *feats, stats[:, :2].contiguous(), SCALE)
    with pytest.raises(TypeError, match="int32"):
        ft.flash_tiles_fwd(args[0], args[1].long(), *args[2:], *feats[:3], SCALE)


# ---------------------------------------------------------------------------
# The conv through the encoder stack
# ---------------------------------------------------------------------------


def _conv_graph(case):
    rng = np.random.default_rng(3)
    if case == "isolated":
        # dense core among 0..63, stray edges among 64..89 (residual-only row
        # tiles at T = 16), nodes 90..99 isolated
        n = 100
        s1, d1 = rng.integers(0, 64, 800), rng.integers(0, 64, 800)
        s2, d2 = rng.integers(64, 90, 12), rng.integers(64, 90, 12)
        return n, np.concatenate([s1, s2]), np.concatenate([d1, d2])
    n = 150
    src, dst = make_sbm_graph(rng, n, 1200, num_communities=5)
    if case == "padded":
        # a perm-free operand on ids relabeled to community order, as the
        # CLI builds it: the encoder stack runs padded-carry
        src, dst, _ = tgraph.to_undirected_edges(src, dst, None, n)
        relabel = np.empty(n, np.int64)
        relabel[tts.label_prop_order(src, dst, n)] = np.arange(n)
        src, dst = relabel[src], relabel[dst]
    return n, src, dst


# case -> (build kwargs, layers)
CONV_CASES = {
    "padded": (dict(tile=16, min_fill=6, reorder=None), 2),
    "labelprop": (dict(tile=16, min_fill=3, reorder="labelprop"), 2),
    "all_dense": (dict(tile=16, min_fill=1, reorder="labelprop"), 1),
    "isolated": (dict(tile=16, min_fill=5, reorder=None), 1),
}


@functools.lru_cache(maxsize=None)
def _hybrid_pair(case):
    n, src, dst = _conv_graph(case)
    kw = dict(CONV_CASES[case][0], num_nodes=n, block=(8, 32))
    return n, tts.build_hybrid(src, dst, device="cpu", **kw), jts.build_hybrid(src, dst, **kw)


def _encoder_pair(n_layers, d, key):
    jp = init_encoder(jax.random.PRNGKey(key), "TRANSFORMER", d, d, n_layers)
    enc = Encoder(torch.Generator().manual_seed(0), "TRANSFORMER", d, d, n_layers)
    with torch.no_grad():
        _load(enc, jax.tree_util.tree_map(np.asarray, jp), "encoder", set())
    return jp, enc


def _compare_encoders(jp, enc, jgraph_, tgraph_, n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cot = rng.standard_normal((n, d)).astype(np.float32)

    @jax.jit
    def reference(p, xx):
        out, vjp = jax.vjp(lambda p, xx: apply_encoder(p, "TRANSFORMER", jgraph_, xx), p, xx)
        return out, vjp(jnp.asarray(cot))

    want, (gp, gx) = reference(jp, jnp.asarray(x))
    want = np.asarray(want)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = enc(tgraph_, xt)
    assert out.shape == (n, d)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), want, **CONV_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **CONV_TOL)
    got_p = {"layers": [
        {name: {"w": lin.weight.grad.numpy().T, "b": lin.bias.grad.numpy()}
         for name, lin in layer.items()} for layer in enc.layers]}
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got_p),
                                 jax.tree_util.tree_leaves_with_path(gp)):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=jax.tree_util.keystr(path),
                                   **CONV_TOL)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_hybrid_transformer_conv_matches_jax(case):
    n, th, jh = _hybrid_pair(case)
    assert th.num_tiles > 0 and th.dense_edges > 0
    if case == "all_dense":
        assert th.res_graph is None
    else:
        assert th.res_edges > 0
    if case == "labelprop":
        assert th.perm_in is not None
    if case == "isolated":
        assert not np.all(np.diff(th.tile_rowptr.numpy()) > 0)  # residual-only row tiles
    jp, enc = _encoder_pair(CONV_CASES[case][1], D, key=1)
    _compare_encoders(jp, enc, jh, th, n, D, seed=4)


def test_per_edge_transformer_matches_jax():
    n, src, dst = _conv_graph("isolated")
    tg = tgraph.build_graph(src, dst, num_nodes=n, device="cpu")
    jg, _ = jgraph.prepare_graph(src, dst, None, num_nodes=n, block=None)
    jp, enc = _encoder_pair(2, D, key=2)
    _compare_encoders(jp, enc, jg, tg, n, D, seed=5)
    rng = np.random.default_rng(6)
    q, k = (rng.standard_normal((n, D)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tsd.sddmm_dot(tg, _t(q), _t(k)).numpy(),
        np.asarray(jsd.sddmm_dot(jg, jnp.asarray(q), jnp.asarray(k)))[: tg.num_edges],
        **KERNEL_TOL,
    )


# ---------------------------------------------------------------------------
# One joint optimizer step
# ---------------------------------------------------------------------------


def test_transformer_train_step_matches_jax():
    n, th, jh = _hybrid_pair("padded")
    w, b = 16, 64
    kw = dict(encoder="TRANSFORMER", predictor="MLP", optimizer="SGD", loss_func="CE",
              emb_hidden_channels=w, gnn_hidden_channels=w, mlp_hidden_channels=w,
              batch_size=b, lr=0.01, grad_clip_norm=1.0)
    jm = JaxModel(JaxConfig(**kw), n)
    jparams = jm.init_params(jax.random.PRNGKey(2))
    tm = Model(ModelConfig(**kw), n, device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tm)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, n, (b, 2))
    neg = rng.integers(0, n, (b, 1, 2))
    mask = np.ones(b, np.float32)
    jparams, _, jloss = jm._train_step(
        jparams, jm.init_opt_state(jparams), jh, None, None, pos.astype(np.int32),
        neg.astype(np.int32), np.ones(b, np.float32), mask, np.float32(0.01),
        jax.random.PRNGKey(0), False,
    )
    tloss = tm.train_step(tm.make_optimizer(), th, None, None, torch.from_numpy(pos),
                          torch.from_numpy(neg), None, torch.from_numpy(mask), 0.01)
    np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
    got = jax.tree_util.tree_leaves_with_path(params_to_jax(tm))
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jparams))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, c) in zip(got, want):
        np.testing.assert_allclose(a, c, err_msg=jax.tree_util.keystr(path), **PARAM_TOL)
