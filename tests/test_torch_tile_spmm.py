"""plnlp_tpu_torch hybrid dense-tile SpMM against plnlp_tpu (CPU).

* (The host build, ``build_hybrid``, ``estimate_hybrid`` and the
  label-prop orders, is held in tests/test_torch_tile_build.py.)
* ``tile_matmul_reference`` (the plain version the CUDA kernel K2 is held
  to) against the Pallas kernel in interpret mode, as
  tests/test_tile_spmm.py runs it, on the covered row tiles; the port is
  zero elsewhere.
* ``hybrid_spmm`` values and input gradients against the JAX operator
  (its XLA tile pass) through ``jax.vjp``: float32 sums in another order,
  rtol = atol = 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.ops.tile_spmm as jts
from plnlp_tpu.ops.pallas_tiles import tile_matmul as pallas_tile_matmul
from plnlp_tpu_torch.data.synthetic import make_sbm_graph
from plnlp_tpu_torch.ops import tile_matmul as tm
from plnlp_tpu_torch.ops import tile_spmm as tts
from plnlp_tpu_torch.ops.spmm import spmm
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

TOL = dict(rtol=1e-5, atol=1e-5)
N = 600


@functools.lru_cache(maxsize=None)
def _sbm(weighted=False):
    rng = np.random.default_rng(3)
    src, dst = make_sbm_graph(rng, N, 5000, num_communities=8)
    w = rng.random(len(src)).astype(np.float32) + 0.5 if weighted else None
    return src, dst, w


# name -> (weighted, build kwargs)
CASES = {
    "labelprop": (False, dict(tile=32, min_fill=12, symmetrize=True, reorder="labelprop")),
    "multilevel": (False, dict(tile=32, min_fill=12, symmetrize=True, reorder="multilevel")),
    "relabeled": (True, dict(tile=64, min_fill=20, symmetrize=False)),
    "all_dense": (False, dict(tile=32, min_fill=1, symmetrize=True)),
    "no_tiles": (False, dict(tile=32, min_fill=10**9, symmetrize=True)),
    "budget": (False, dict(tile=32, min_fill=1, symmetrize=True, max_tile_bytes=5 * 32 * 32 * 4)),
}


@functools.lru_cache(maxsize=None)
def _pair(case):
    weighted, kw = CASES[case]
    src, dst, w = _sbm(weighted)
    kw = dict(kw, num_nodes=N, block=(64, 512))
    return tts.build_hybrid(src, dst, w, device="cpu", **kw), jts.build_hybrid(src, dst, w, **kw)


def _np(a):
    return None if a is None else np.asarray(a)


@pytest.mark.parametrize("store", [np.int8, np.float32])
def test_tile_matmul_reference_matches_pallas_interpret(store):
    rng = np.random.default_rng(5)
    t, d, n_r, nt = 32, 24, 5, 7
    trow = np.sort(rng.choice([0, 1, 3], nt)).astype(np.int32)  # row tiles 2, 4 uncovered
    tcol = rng.integers(0, n_r, nt).astype(np.int32)
    if store is np.int8:
        vals = rng.integers(-3, 4, (nt, t, t)).astype(np.int8)
    else:
        vals = rng.standard_normal((nt, t, t)).astype(np.float32)
    x = rng.standard_normal((n_r * t - 5, d)).astype(np.float32)  # ragged last tile
    xp = np.concatenate([x, np.zeros((5, d), np.float32)])
    want = np.asarray(pallas_tile_matmul(
        jnp.asarray(vals), jnp.asarray(trow), jnp.asarray(tcol),
        jnp.asarray(xp.reshape(n_r, t, d)), n_r, interpret=True,
    ))
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(np.bincount(trow, minlength=n_r))])
                           .astype(np.int32))
    before = tm.LAUNCHES
    got = tm.tile_matmul(
        torch.from_numpy(vals), torch.from_numpy(trow), torch.from_numpy(tcol), ptr,
        torch.from_numpy(x), n_r * t - 5,
    ).numpy()
    assert tm.LAUNCHES == before  # the CPU path is no kernel launch
    covered = np.repeat(np.isin(np.arange(n_r), trow), t)[: n_r * t - 5]
    np.testing.assert_allclose(got[covered], want[: n_r * t - 5][covered], **TOL)
    np.testing.assert_array_equal(got[~covered], 0.0)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("case,padded", [
    ("labelprop", False), ("relabeled", False), ("relabeled", True),
    ("all_dense", True), ("no_tiles", False),
])
def test_hybrid_spmm_values_and_grads_match_jax(case, padded, reduce):
    th, jh = _pair(case)
    if case == "all_dense":
        assert th.res_graph is None
    rng = np.random.default_rng(11)
    rows = -(-N // th.tile) * th.tile if padded else N
    x = rng.standard_normal((rows, 16)).astype(np.float32)
    gy = rng.standard_normal((rows, 16)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jts.hybrid_spmm(jh, v, reduce), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = spmm(th, xt, reduce=reduce)
    assert got.shape == (rows, 16)
    got.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)
    if padded:
        np.testing.assert_array_equal(got.detach().numpy()[N:], 0.0)
        np.testing.assert_array_equal(xt.grad.numpy()[N:], 0.0)


def test_tile_matmul_rejects_bad_inputs():
    th, _ = _pair("labelprop")
    x = torch.randn(N, 8)
    args = (th.tile_vals, th.tile_row, th.tile_col, th.tile_rowptr)
    with pytest.raises(TypeError, match="float32"):
        tm.tile_matmul(*args, x.double(), N)
    with pytest.raises(TypeError, match="int32"):
        tm.tile_matmul(th.tile_vals, th.tile_row.long(), *args[2:], x, N)
    with pytest.raises(ValueError, match="multiple of 16"):
        tm.tile_matmul(th.tile_vals[:, :8, :8].contiguous(), *args[1:], x, N)
    with pytest.raises(ValueError, match="out_rows"):
        tm.tile_matmul(*args, x, 10 * N)
    with pytest.raises(ValueError, match="reorder"):
        tts.build_hybrid(*_sbm()[:2], num_nodes=N, tile=32, reorder="metis", device="cpu")
