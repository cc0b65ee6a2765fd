"""plnlp_tpu_torch blocked SpMM against plnlp_tpu (CPU).

``scatter_matmul_reference`` (the plain version the CUDA kernel is held to)
is compared with the Pallas kernel in interpret mode, as
tests/test_pallas_spmm.py runs it; the SpMM values and input gradients with
``spmm_blocked`` through ``jax.vjp``.  Tolerance: float32 sums in another
order, rtol = atol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.graph as jgraph
from plnlp_tpu.ops.pallas_spmm import scatter_matmul as pallas_scatter_matmul
from plnlp_tpu.ops.spmm import spmm_blocked as jax_spmm_blocked
from plnlp_tpu.ops.spmm import spmm_segment as jax_spmm_segment
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.ops import scatter_matmul as sm
from plnlp_tpu_torch.ops.spmm import spmm, spmm_blocked, spmm_segment
from tests.conftest import random_graph_np
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

TOL = dict(rtol=1e-5, atol=1e-5)


def _blocked_pair(src, dst, w, n, R, B, sym=False):
    tg, tgt = tgraph.prepare_graph(
        src, dst, w, num_nodes=n, symmetrize=sym, block=(R, B), device="cpu"
    )
    jg, jgt = jgraph.prepare_graph(src, dst, w, num_nodes=n, symmetrize=sym, block=(R, B))
    return tg, tgt, jg, jgt


def _ref(tg, x):
    return sm.scatter_matmul_reference(
        torch.from_numpy(x), tg.blk_src, tg.blk_local, tg.blk_weight,
        tg.blk_rowptr, tg.block_rows, tg.num_nodes,
    ).numpy()


@pytest.mark.parametrize("n,e,R,B", [(70, 500, 16, 32), (40, 120, 8, 128)])
def test_reference_matches_pallas_interpret(rng, n, e, R, B):
    src, dst, w = random_graph_np(rng, n, e, weighted=True)
    tg, _, jg, _ = _blocked_pair(src, dst, w, n, R, B)
    x = rng.standard_normal((n, 32)).astype(np.float32)
    feats = jnp.asarray(x)[jg.blk_src]
    want = pallas_scatter_matmul(
        feats, jg.blk_local, jg.blk_weight, jg.blk_rowblock, R, -(-n // R),
        interpret=True,
    )[:n]
    np.testing.assert_allclose(_ref(tg, x), np.asarray(want), **TOL)


def test_reference_zero_fills_empty_rowblocks():
    # no edges into nodes 16..31: row-block 1 of R=16 must come out zero
    src, dst = np.array([0, 1, 2, 40]), np.array([3, 3, 40, 41])
    tg, _, jg, _ = _blocked_pair(src, dst, None, 48, 16, 32)
    assert tg.blk_rowptr.tolist() == [0, 1, 2, 3]
    x = np.random.default_rng(0).standard_normal((48, 8)).astype(np.float32)
    got = _ref(tg, x)
    np.testing.assert_array_equal(got[16:32], 0.0)
    want = pallas_scatter_matmul(
        jnp.asarray(x)[jg.blk_src], jg.blk_local, jg.blk_weight, jg.blk_rowblock,
        16, 3, interpret=True,
    )[:48]
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_reference_takes_each_row_blocks_pointer_range(rng):
    """Row-block rb sums exactly the sub-blocks [rowptr[rb], rowptr[rb+1]),
    as the kernel does: emptying row-block 0's range zeroes its rows only."""
    src, dst, w = random_graph_np(rng, 64, 400, weighted=True)
    tg, _, _, _ = _blocked_pair(src, dst, w, 64, 16, 32)
    x = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    full = _ref(tg, x.numpy())
    ptr = tg.blk_rowptr.clone()
    ptr[0] = ptr[1]
    part = sm.scatter_matmul_reference(
        x, tg.blk_src, tg.blk_local, tg.blk_weight, ptr, 16, 64
    ).numpy()
    np.testing.assert_array_equal(part[:16], 0.0)
    np.testing.assert_array_equal(part[16:], full[16:])


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("sym,weighted", [(False, True), (True, False)])
def test_spmm_blocked_values_and_grads_match_jax(rng, reduce, sym, weighted):
    n = 100
    src, dst, w = random_graph_np(rng, n, 600, weighted=weighted)
    tg, tgt, jg, jgt = _blocked_pair(src, dst, w, n, 16, 32, sym=sym)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    gy = rng.standard_normal((n, 24)).astype(np.float32)

    want, vjp = jax.vjp(lambda v: jax_spmm_blocked(jg, jgt, v, reduce), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(gy))

    xt = torch.from_numpy(x).requires_grad_(True)
    got = spmm(tg, xt, reduce=reduce, graph_t=tgt)
    got.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_spmm_segment_matches_jax(rng, reduce):
    src, dst, w = random_graph_np(rng, 60, 400, weighted=True)
    tg = tgraph.build_graph(src, dst, w, num_nodes=60, device="cpu")
    jg = jgraph.build_graph(src, dst, w, num_nodes=60)
    x = rng.standard_normal((60, 16)).astype(np.float32)
    got = spmm(tg, torch.from_numpy(x), reduce=reduce)  # unblocked -> segment
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_spmm_segment(jg, jnp.asarray(x), reduce)), **TOL
    )
    assert torch.equal(got, spmm_segment(tg, torch.from_numpy(x), reduce))


def test_blocked_backward_needs_graph_t(rng):
    src, dst, _ = random_graph_np(rng, 30, 100)
    tg, _ = tgraph.prepare_graph(src, dst, num_nodes=30, block=(8, 32), device="cpu")
    x = torch.randn(30, 4, requires_grad=True)
    out = spmm_blocked(tg, None, x, "mean")  # forward alone is fine
    with pytest.raises(ValueError, match="graph_t"):
        out.sum().backward()


def test_unported_operands_and_bad_inputs_raise(rng):
    src, dst, _ = random_graph_np(rng, 30, 100)
    tg, _ = tgraph.prepare_graph(src, dst, num_nodes=30, block=(8, 32), device="cpu")
    x = torch.randn(30, 4)

    class Unknown:  # no aggregation operand of the port
        pass

    with pytest.raises(TypeError, match="unknown aggregation operand: Unknown"):
        spmm(Unknown(), x)
    with pytest.raises(ValueError, match="reduce"):
        spmm(tg, x, reduce="max")
    args = (tg.blk_src, tg.blk_local, tg.blk_weight, tg.blk_rowptr, 8, 30)
    with pytest.raises(TypeError, match="float32"):
        sm.scatter_matmul(x.double(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        sm.scatter_matmul(torch.randn(4, 30).t(), *args)
    with pytest.raises(ValueError, match="blk_rowptr"):
        sm.scatter_matmul(x, *args[:-1], 60)
    # the CPU path never counts as a kernel launch
    before = sm.LAUNCHES
    sm.scatter_matmul(x, *args)
    assert sm.LAUNCHES == before

