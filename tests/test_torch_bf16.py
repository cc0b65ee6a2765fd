"""plnlp_tpu_torch's bfloat16 compute mode and its ``--block_rows 0`` flag
against plnlp_tpu (CPU).

* K1's and K2's plain versions in bf16 (``scatter_matmul_reference``,
  ``tile_matmul_reference``, which the CUDA kernels are held to on the
  card) against the Pallas kernels in interpret mode with bf16 features:
  weights or tile values cast to bf16, products summed in f32, each output
  element rounded to bf16 once.  Held to one bf16 ulp (an f32 sum in
  another order may round to the neighbouring bf16 value).
* ``build_hybrid(dtype="bfloat16")`` gives the JAX package's arrays: int8
  tiles where that is exact, bf16 otherwise, bit for bit.
* ``spmm`` (blocked, segment, dense) and ``hybrid_spmm`` in bf16, values
  and input gradients, against the JAX package in bf16 at rtol = atol =
  2**-5 (eight bf16 ulps of a value near 1: the JAX CPU path rounds every
  message and every sub-block's partial sum to bf16 where the port's
  blocked and tile paths round once, as the TPU kernels do), and against
  the port in f32 within 2**-6 (1 + sum of the terms' magnitudes): x is
  rounded to bf16 (2**-9 of each term), and the segment path, as the JAX
  package's, adds its ~50 messages a row in bf16, one rounding an add.
* (``Model`` in bf16 is held in tests/test_torch_bf16_model.py.)
* The CLI's ``--block_rows 0`` (the autotune itself is held in
  tests/test_torch_tuning.py).
"""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.dense as jdense
import plnlp_tpu.graph as jgraph
import plnlp_tpu.ops.tile_spmm as jts
from plnlp_tpu.ops.pallas_spmm import scatter_matmul as pallas_scatter_matmul
from plnlp_tpu.ops.pallas_tiles import tile_matmul as pallas_tile_matmul
from plnlp_tpu.ops.spmm import spmm as jspmm
from plnlp_tpu_torch import cli
from plnlp_tpu_torch import dense as tdense
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.data.synthetic import make_sbm_graph
from plnlp_tpu_torch.ops import scatter_matmul as sm
from plnlp_tpu_torch.ops import tile_matmul as tm
from plnlp_tpu_torch.ops import tile_spmm as tts
from plnlp_tpu_torch.ops.spmm import spmm
from tests.conftest import random_graph_np
from tests.test_torch_cli import _args as cli_test_args
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

BF = torch.bfloat16
SPMM_TOL = dict(rtol=2**-5, atol=2**-5)
N, W = 100, 16


def _f32(a):
    """A torch or JAX/NumPy array as float32 NumPy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _ulps(a, b):
    """|a - b| in bf16 units in the last place, for values that bf16 holds."""
    def ordered(v):
        bits = (_f32(v).view(np.uint32) >> 16).astype(np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)

    return np.abs(ordered(a) - ordered(b))


# ---------------------------------------------------------------------------
# K1 and K2: the plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["weighted", "padded", "empty_rowblock"])
def test_k1_reference_bf16_matches_pallas_interpret(case):
    rng = np.random.default_rng(7)
    if case == "empty_rowblock":
        # no edge into nodes 16..31: row-block 1 of R = 16 is empty
        n, R, Bk = 48, 16, 32
        src, dst = rng.integers(0, n, 200), rng.integers(0, n, 200)
        keep = (dst < 16) | (dst >= 32)
        w = rng.random(200).astype(np.float32) + 0.1
        src, dst, w = src[keep], dst[keep], w[keep]
    else:
        n, e, R, Bk = (70, 500, 16, 32) if case == "weighted" else (40, 120, 8, 128)
        src, dst, w = random_graph_np(rng, n, e, weighted=True)
    tg, _ = tgraph.prepare_graph(src, dst, w, num_nodes=n, block=(R, Bk), device="cpu")
    jg, _ = jgraph.prepare_graph(src, dst, w, num_nodes=n, block=(R, Bk))
    x = rng.standard_normal((n, 32)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = pallas_scatter_matmul(
        xb[jg.blk_src], jg.blk_local, jg.blk_weight, jg.blk_rowblock, R, -(-n // R),
        interpret=True,
    )[:n]
    assert want.dtype == jnp.bfloat16
    before = (sm.LAUNCHES, sm.LAUNCHES_BF16)
    got = sm.scatter_matmul(
        torch.from_numpy(x).to(BF), tg.blk_src, tg.blk_local, tg.blk_weight, tg.blk_rowptr,
        R, n,
    )
    assert (sm.LAUNCHES, sm.LAUNCHES_BF16) == before  # the CPU path is no launch
    assert got.dtype == BF and got.shape == (n, 32)
    assert _ulps(got, want).max() <= 1
    if case == "empty_rowblock":
        assert not got[16:32].any()


@pytest.mark.parametrize("store", [np.int8, "bfloat16", np.float32])
def test_k2_reference_bf16_matches_pallas_interpret(store):
    rng = np.random.default_rng(5)
    t, d, n_r, nt = 32, 24, 5, 7
    trow = np.sort(rng.choice([0, 1, 3], nt)).astype(np.int32)  # row tiles 2, 4 uncovered
    tcol = rng.integers(0, n_r, nt).astype(np.int32)
    if store is np.int8:
        vals_t = torch.from_numpy(rng.integers(-3, 4, (nt, t, t)).astype(np.int8))
    else:
        v = rng.standard_normal((nt, t, t)).astype(np.float32)
        vals_t = torch.from_numpy(v).to(BF if store == "bfloat16" else torch.float32)
    vals_j = jnp.asarray(_f32(vals_t)).astype(
        jnp.int8 if store is np.int8 else jnp.bfloat16 if store == "bfloat16" else jnp.float32)
    x = rng.standard_normal((n_r * t - 5, d)).astype(np.float32)  # ragged last tile
    xb = jnp.asarray(np.concatenate([x, np.zeros((5, d), np.float32)])).astype(jnp.bfloat16)
    want = pallas_tile_matmul(
        vals_j, jnp.asarray(trow), jnp.asarray(tcol), xb.reshape(n_r, t, d), n_r,
        interpret=True,
    )
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(np.bincount(trow, minlength=n_r))])
                           .astype(np.int32))
    before = (tm.LAUNCHES, tm.LAUNCHES_BF16)
    got = tm.tile_matmul(vals_t, torch.from_numpy(trow), torch.from_numpy(tcol), ptr,
                         torch.from_numpy(x).to(BF), n_r * t - 5)
    assert (tm.LAUNCHES, tm.LAUNCHES_BF16) == before
    assert got.dtype == BF
    covered = np.repeat(np.isin(np.arange(n_r), trow), t)[: n_r * t - 5]
    assert _ulps(got[covered], _f32(want)[: n_r * t - 5][covered]).max() <= 1
    assert not got[~covered].any()


# ---------------------------------------------------------------------------
# The hybrid operand's bf16 store and the aggregations in bf16
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sbm(n=N, weighted=False):
    """A symmetric community graph, relabeled to label-prop order."""
    rng = np.random.default_rng(0)
    src, dst = make_sbm_graph(rng, n, 25 * n, num_communities=4)
    src, dst, _ = tgraph.to_undirected_edges(src, dst, None, n)
    relabel = np.empty(n, np.int64)
    relabel[tts.label_prop_order(src, dst, n)] = np.arange(n)
    w = rng.random(len(src)).astype(np.float32) + 0.5 if weighted else None
    return relabel[src], relabel[dst], w


@pytest.mark.parametrize("weighted", [False, True])
def test_build_hybrid_bf16_matches_jax(weighted):
    src, dst, w = _sbm(weighted=weighted)
    kw = dict(num_nodes=N, tile=32, min_fill=20, block=(64, 512), dtype="bfloat16")
    th = tts.build_hybrid(src, dst, w, device="cpu", **kw)
    jh = jts.build_hybrid(src, dst, w, **kw)
    assert th.num_tiles > 1 and th.res_edges > 0
    want_dt = torch.bfloat16 if weighted else torch.int8
    for name in ("tile_vals", "tile_vals_t"):
        got, want = getattr(th, name), getattr(jh, name)
        assert got.dtype == want_dt and str(want.dtype) == str(want_dt).split(".")[1]
        np.testing.assert_array_equal(_f32(got), _f32(want))
    for name in ("tile_row", "tile_col", "tile_row_t", "tile_col_t"):
        np.testing.assert_array_equal(getattr(th, name).numpy(), np.asarray(getattr(jh, name)))
    with pytest.raises(ValueError, match="dtype"):
        tts.build_hybrid(src, dst, w, device="cpu", **dict(kw, dtype="float16"))


def _spmm_pair(kind):
    """(port operand, port transpose, JAX operand, JAX transpose, reduce,
    rows of x) for one aggregation path, on a weighted graph."""
    src, dst, w = _sbm(weighted=True)
    if kind == "blocked":
        kw = dict(num_nodes=N, block=(32, 128))
        return (*tgraph.prepare_graph(src, dst, w, device="cpu", **kw),
                *jgraph.prepare_graph(src, dst, w, **kw), "mean", N)
    if kind == "segment":
        kw = dict(num_nodes=N, block=None)
        return (tgraph.prepare_graph(src, dst, w, device="cpu", **kw)[0], None,
                jgraph.prepare_graph(src, dst, w, **kw)[0], None, "sum", N)
    if kind == "dense":
        return (tdense.prepare_dense(src, dst, w, num_nodes=N, device="cpu"), None,
                jdense.prepare_dense(src, dst, w, num_nodes=N), None, "mean", N)
    kw = dict(num_nodes=N, tile=32, min_fill=20, block=(64, 512), dtype="bfloat16")
    return (tts.build_hybrid(src, dst, w, device="cpu", **kw), None,
            jts.build_hybrid(src, dst, w, **kw), None, "mean", -(-N // 32) * 32)


@pytest.mark.parametrize("kind", ["blocked", "segment", "dense", "hybrid"])
def test_spmm_bf16_matches_jax_and_f32(kind):
    tg, tgt, jg, jgt, reduce, rows = _spmm_pair(kind)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((rows, W)).astype(np.float32)
    gy = rng.standard_normal((rows, W)).astype(np.float32)
    # the weights are positive: the sums of the terms' magnitudes are the
    # f32 aggregation of |x| and its gradient for |gy|
    xa = torch.from_numpy(np.abs(x)).requires_grad_(True)
    mag = spmm(tg, xa, reduce=reduce, graph_t=tgt)
    mag.backward(torch.from_numpy(np.abs(gy)))
    mags = (1 + _f32(mag), 1 + _f32(xa.grad))
    outs = {}
    for dt in (BF, torch.float32):
        xt = torch.from_numpy(x).to(dt).requires_grad_(True)
        out = spmm(tg, xt, reduce=reduce, graph_t=tgt)
        out.backward(torch.from_numpy(gy).to(dt))
        assert out.dtype == dt and xt.grad.dtype == dt and out.shape == (rows, W)
        outs[dt] = (_f32(out), _f32(xt.grad))
    if kind == "hybrid":
        fn = lambda v: jts.hybrid_spmm(jg, v, reduce)  # noqa: E731
    else:
        fn = lambda v: jspmm(jg, v, reduce, graph_t=jgt)  # noqa: E731

    @jax.jit
    def value_and_vjp(v, g):
        out, vjp = jax.vjp(fn, v)
        return out, vjp(g)[0]

    want, want_dx = value_and_vjp(jnp.asarray(x).astype(jnp.bfloat16),
                                  jnp.asarray(gy).astype(jnp.bfloat16))
    got, got_dx = outs[BF]
    np.testing.assert_allclose(got, _f32(want), **SPMM_TOL)
    np.testing.assert_allclose(got_dx, _f32(want_dx), **SPMM_TOL)
    for a, b, m in zip((got, got_dx), outs[torch.float32], mags):
        assert (np.abs(a - b) <= 2**-6 * m).all()
    if kind == "hybrid":  # padded-carry: rows past num_nodes stay zero
        assert not got[N:].any() and not got_dx[N:].any()


# ---------------------------------------------------------------------------
# Block autotune and the hyperparameter search
# ---------------------------------------------------------------------------


def _cli_args(**kw):
    # above 512 nodes, so that the default sweep measures R = 256 and 512
    base = dict(data_name="synthetic:hits:num_nodes=600,num_edges=3000", epochs=1,
                adj_backend="csr")
    return cli_test_args(**dict(base, **kw))


@pytest.mark.parametrize("backend", ["csr", "hybrid"])
def test_cli_block_rows_0_autotunes_and_trains_in_bf16(backend):
    """--block_rows 0 autotunes off the dense backend (the hybrid residual
    is blocked with the choice), and the run trains in bf16; on the dense
    backend it takes 512 without a sweep."""
    kw = dict(block_rows=0, block_edges=64, compute_dtype="bfloat16", adj_backend=backend)
    if backend == "hybrid":
        kw.update(data_name="synthetic:hits-sbm:num_nodes=600,num_edges=6000,num_communities=10",
                  tile_size=32, tile_min_fill=8)
    lines = []
    args = _cli_args(**kw)
    with contextlib.redirect_stdout(io.StringIO()):
        loggers = cli.run_experiment(args, log=lines.append, device="cpu")
    assert sum(line.startswith("autotune: (R=") for line in lines) >= 2
    chosen = [line for line in lines if line.startswith("autotuned block")]
    assert len(chosen) == 1 and args.block_rows in (256, 512) and args.block_edges == 64
    assert all(np.isfinite(sum(lg.results[0], ())).all() for lg in loggers.values())
    if backend == "hybrid":
        assert any("store=torch.int8" in line for line in lines)
    dense = _cli_args(block_rows=0, adj_backend="dense")
    with contextlib.redirect_stdout(io.StringIO()):
        exp = cli.prepare_experiment(dense, log=lines.append, device="cpu")
    assert dense.block_rows == 512 and isinstance(exp["graph"], tdense.DenseAdj)
