"""plnlp_tpu_torch CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU with nvcc; skips elsewhere.  Imports neither jax nor
plnlp_tpu, so on a machine without them it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.ops import scatter_matmul as sm
from plnlp_tpu_torch.ops.spmm import _mean_scale, spmm


@pytest.fixture
def cuda_graphs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    n = 3000
    src, dst = rng.integers(0, n, 40000), rng.integers(0, 300, 40000)  # skewed
    w = rng.random(40000).astype(np.float32) + 0.1
    return n, tgraph.prepare_graph(
        src, dst, w, num_nodes=n, symmetrize=True, block=(512, 512), device="cuda"
    )


def _within_sum_tolerance(got, want, abs_sum):
    # f32 sums of up to max_degree terms in another order: the rounding
    # scales with sum |w x|, not with the result
    return bool(((got - want).abs() <= 1e-5 + 1e-6 * abs_sum).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 256])
def test_scatter_matmul_matches_plain_version(cuda_graphs, d):
    n, graphs = cuda_graphs
    x = torch.randn(n, d, device="cuda")
    for g in graphs:
        args = (g.blk_src, g.blk_local, g.blk_weight, g.blk_rowptr, g.block_rows, n)
        before = sm.LAUNCHES
        got = sm.scatter_matmul(x, *args)
        torch.cuda.synchronize()
        assert sm.LAUNCHES == before + 1
        want = sm.scatter_matmul_reference(x, *args)
        abs_sum = sm.scatter_matmul_reference(
            x.abs(), g.blk_src, g.blk_local, g.blk_weight.abs(), *args[3:]
        )
        assert _within_sum_tolerance(got, want, abs_sum)


@pytest.mark.cuda
def test_spmm_blocked_gradient_matches_autograd(cuda_graphs):
    n, (g, gt) = cuda_graphs
    x = torch.randn(n, 64, device="cuda", requires_grad=True)
    gy = torch.randn(n, 64, device="cuda")
    spmm(g, x, reduce="mean", graph_t=gt).backward(gy)
    xr = x.detach().clone().requires_grad_(True)
    ref = sm.scatter_matmul_reference(
        xr, g.blk_src, g.blk_local, g.blk_weight, g.blk_rowptr, g.block_rows, n
    )
    _mean_scale(g, ref).backward(gy)
    abs_sum = sm.scatter_matmul_reference(
        _mean_scale(g, gy).abs(), gt.blk_src, gt.blk_local, gt.blk_weight.abs(),
        gt.blk_rowptr, gt.block_rows, n,
    )
    assert _within_sum_tolerance(x.grad, xr.grad, abs_sum)
