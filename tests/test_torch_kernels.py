"""plnlp_tpu_torch CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU with nvcc; skips elsewhere.  Imports neither jax nor
plnlp_tpu, so on a machine without them it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.ops import flash_tiles as ft
from plnlp_tpu_torch.ops import scatter_matmul as sm
from plnlp_tpu_torch.ops import tile_matmul as tm
from plnlp_tpu_torch.ops import tile_spmm as tts
from plnlp_tpu_torch.ops.spmm import _mean_scale, spmm
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)


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


def _skewed_graphs(block):
    """A power-law-like graph for K1's runs: hub row 5 takes 6,000 in-edges
    (many runs of slots, crossing run boundaries), row-block 2 and the rows
    from 2,900 on have no edge (an all-padding sub-block, trailing empty
    rows), and out_rows = 3,000 is less than the row-blocks' 6 x 512 rows."""
    rng = np.random.default_rng(1)
    n = 3000
    dst = np.concatenate([np.full(6000, 5), rng.integers(0, 2900, 20000)])
    src = rng.integers(0, n, len(dst))
    keep = (dst < 1024) | (dst >= 1536)
    w = rng.random(len(dst)).astype(np.float32) + 0.1
    g = tgraph.build_graph(src[keep], dst[keep], w[keep], num_nodes=n, block=block,
                           device="cuda")
    return n, [g]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 256, 300])
@pytest.mark.parametrize("kind", ["symmetrized", "skewed-512x512", "skewed-512x48"])
def test_scatter_matmul_matches_plain_version(cuda_graphs, kind, d):
    """K1 against its plain version within 1e-5 + 1e-6 sum|w x|; rows no
    edge reaches exactly zero; a second launch gives the same bits (the
    carries are summed in a fixed order).  The skewed cases hand x with 37
    rows more than out_rows, as the hybrid residual does."""
    if kind == "symmetrized":
        n, graphs = cuda_graphs
        x = torch.randn(n, d, device="cuda")
    else:
        n, graphs = _skewed_graphs((512, int(kind.split("x")[1])))
        x = torch.randn(n + 37, d, device="cuda")
    for g in graphs:
        args = (g.blk_src, g.blk_local, g.blk_weight, g.blk_rowptr, g.block_rows, n)
        before = sm.LAUNCHES
        got = sm.scatter_matmul(x, *args)
        again = sm.scatter_matmul(x, *args)
        torch.cuda.synchronize()
        assert sm.LAUNCHES == before + 2
        assert torch.equal(got, again)
        want = sm.scatter_matmul_reference(x, *args)
        abs_sum = sm.scatter_matmul_reference(
            x.abs(), g.blk_src, g.blk_local, g.blk_weight.abs(), *args[3:]
        )
        assert got.shape == (n, d)
        assert _within_sum_tolerance(got, want, abs_sum)
        empty = (g.in_degrees == 0).nonzero()[:, 0]
        assert not got[empty].any()
        if kind != "symmetrized":
            assert len(empty) >= 600


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


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["dense", "sparse"])
@pytest.mark.parametrize("store", [torch.int8, torch.float32])
@pytest.mark.parametrize("t,d", [(32, 24), (64, 100), (256, 256), (128, 131), (256, 520)])
def test_tile_matmul_matches_plain_version(store, t, d, fill):
    """K2 against its plain version within 1e-5 + 1e-6 sum|v x|, on full
    tiles and on ~1%-full ones (as the hybrid operand builds), with
    negative values, one all-zero tile, row tiles no tile reaches (zero)
    and a ragged last x tile; a second launch gives the same bits."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_r, nt = 7, 13
    # row tiles 2 and 5 get no tile: the kernel must write zeros there
    trow = torch.sort(torch.tensor([0, 1, 3, 4, 6], device="cuda")[
        torch.randint(0, 5, (nt,), device="cuda", generator=gen)]).values.int()
    tcol = torch.randint(0, n_r, (nt,), device="cuda", generator=gen).int()
    ptr = torch.cat([trow.new_zeros(1), torch.bincount(trow, minlength=n_r).cumsum(0).int()])
    if store is torch.int8:
        vals = torch.randint(-2, 3, (nt, t, t), device="cuda", generator=gen).to(torch.int8)
    else:
        vals = torch.randn(nt, t, t, device="cuda", generator=gen)
    if fill == "sparse":
        vals = vals * (torch.rand(nt, t, t, device="cuda", generator=gen) < 0.01).to(vals.dtype)
    vals[3] = 0
    n_x = n_r * t - 3  # ragged last x tile
    x = torch.randn(n_x, d, device="cuda", generator=gen)
    before = tm.LAUNCHES
    got = tm.tile_matmul(vals, trow, tcol, ptr, x, n_x)
    again = tm.tile_matmul(vals, trow, tcol, ptr, x, n_x)
    torch.cuda.synchronize()
    assert tm.LAUNCHES == before + 2
    assert torch.equal(got, again)
    want = tm.tile_matmul_reference(vals, trow, tcol, x, n_r, n_x)
    abs_sum = tm.tile_matmul_reference(vals.float().abs(), trow, tcol, x.abs(), n_r, n_x)
    assert _within_sum_tolerance(got, want, abs_sum)
    for r in (2, 5):
        assert not got[r * t: (r + 1) * t].any()


def _within_bf16_tolerance(got, want, abs_sum):
    # the kernel and the plain version each round an f32 sum once to bf16:
    # the f32 sums' tolerance plus one bf16 ulp (2**-7 relative) for the
    # two roundings
    return bool(((got.float() - want.float()).abs()
                 <= 1e-5 + 1e-6 * abs_sum + 2**-7 * want.float().abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 256, 300])
@pytest.mark.parametrize("kind", ["symmetrized", "skewed-512x512"])
def test_scatter_matmul_bf16_matches_plain_version(cuda_graphs, kind, d):
    """K1 in bf16 against its plain version (f32 sums of bf16-rounded
    weights times bf16 x, one rounding a row): within one bf16 ulp beyond
    the f32 sums' tolerance; rows no edge reaches exactly zero; a second
    launch gives the same bits; only the bf16 count moves.  d = 100 and 300
    take the scalar column path (d % 8 != 0)."""
    if kind == "symmetrized":
        n, graphs = cuda_graphs
        x = torch.randn(n, d, device="cuda")
    else:
        n, graphs = _skewed_graphs((512, 512))
        x = torch.randn(n + 37, d, device="cuda")
    x = x.to(torch.bfloat16)
    for g in graphs:
        args = (g.blk_src, g.blk_local, g.blk_weight, g.blk_rowptr, g.block_rows, n)
        before = (sm.LAUNCHES, sm.LAUNCHES_BF16)
        got = sm.scatter_matmul(x, *args)
        again = sm.scatter_matmul(x, *args)
        torch.cuda.synchronize()
        assert (sm.LAUNCHES, sm.LAUNCHES_BF16) == (before[0], before[1] + 2)
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        want = sm.scatter_matmul_reference(x, *args)
        abs_sum = sm.scatter_matmul_reference(
            x.float().abs(), g.blk_src, g.blk_local, g.blk_weight.abs(), *args[3:]
        )
        assert _within_bf16_tolerance(got, want, abs_sum)
        assert not got[(g.in_degrees == 0).nonzero()[:, 0]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d", [(32, 24), (64, 100), (256, 256), (128, 520)])
def test_tile_matmul_bf16_matches_plain_version(store, t, d):
    """K2 with bf16 x against its plain version (vals cast to bf16, f32
    sums, one rounding an element), on ~1%-full tiles with one full row
    (the list drains) and row tiles no tile reaches (zero); a second launch
    gives the same bits; only the bf16 count moves."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_r, nt = 7, 13
    trow = torch.sort(torch.tensor([0, 1, 3, 4, 6], device="cuda")[
        torch.randint(0, 5, (nt,), device="cuda", generator=gen)]).values.int()
    tcol = torch.randint(0, n_r, (nt,), device="cuda", generator=gen).int()
    ptr = torch.cat([trow.new_zeros(1), torch.bincount(trow, minlength=n_r).cumsum(0).int()])
    mask = torch.rand(nt, t, t, device="cuda", generator=gen) < 0.01
    mask[:, 3, :] = True
    if store is torch.int8:
        vals = (mask * torch.randint(-2, 3, (nt, t, t), device="cuda", generator=gen)).to(store)
    else:
        vals = (mask * torch.randn(nt, t, t, device="cuda", generator=gen)).to(store)
    n_x = n_r * t - 3
    x = torch.randn(n_x, d, device="cuda", generator=gen).to(torch.bfloat16)
    before = (tm.LAUNCHES, tm.LAUNCHES_BF16)
    got = tm.tile_matmul(vals, trow, tcol, ptr, x, n_x)
    again = tm.tile_matmul(vals, trow, tcol, ptr, x, n_x)
    torch.cuda.synchronize()
    assert (tm.LAUNCHES, tm.LAUNCHES_BF16) == (before[0], before[1] + 2)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    want = tm.tile_matmul_reference(vals, trow, tcol, x, n_r, n_x)
    abs_sum = tm.tile_matmul_reference(vals.to(torch.bfloat16).float().abs(), trow, tcol,
                                       x.float().abs(), n_r, n_x)
    assert _within_bf16_tolerance(got, want, abs_sum)
    for r in (2, 5):
        assert not got[r * t: (r + 1) * t].any()


@pytest.mark.cuda
@pytest.mark.parametrize("reorder", [None, "labelprop"])
def test_hybrid_spmm_gradient_matches_autograd(reorder):
    _need_cuda()
    from plnlp_tpu_torch.data.synthetic import make_sbm_graph

    rng = np.random.default_rng(0)
    n = 2000
    src, dst = make_sbm_graph(rng, n, 30000, num_communities=10)
    hg = tts.build_hybrid(src, dst, num_nodes=n, tile=64, min_fill=40, symmetrize=True,
                          block=(256, 512), reorder=reorder, device="cuda")
    assert hg.num_tiles > 1 and hg.res_edges > 0
    x = torch.randn(n, 64, device="cuda", requires_grad=True)
    gy = torch.randn(n, 64, device="cuda")
    before = (tm.LAUNCHES, sm.LAUNCHES)
    spmm(hg, x, reduce="mean").backward(gy)
    torch.cuda.synchronize()
    assert (tm.LAUNCHES, sm.LAUNCHES) == (before[0] + 2, before[1] + 2)
    # autograd through the plain versions, as the CPU path runs them; the
    # same backward of |gy| gives the sums of the terms' magnitudes (the
    # adjacency is nonnegative)
    hg_cpu = hg.to("cpu")
    xr = x.detach().cpu().requires_grad_(True)
    spmm(hg_cpu, xr, reduce="mean").backward(gy.cpu())
    xa = x.detach().cpu().requires_grad_(True)
    spmm(hg_cpu, xa, reduce="mean").backward(gy.cpu().abs())
    assert _within_sum_tolerance(x.grad.cpu(), xr.grad, xa.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.int8, torch.float32])
@pytest.mark.parametrize("t,d", [(32, 24), (64, 100), (256, 256), (128, 131), (16, 300),
                                 (32, 520)])
def test_flash_tiles_match_plain_versions(store, t, d):
    """K3, K4, K5 against their plain versions, with chip_smoke's checks
    (y, m, den of K3; dq, dk, dv within 1e-5 + 1e-6 sum|terms|, and a
    second launch of each bitwise equal); row tiles 2 and 5 uncovered, the
    last row tile ragged; d up to 256 takes the one-slice path of each
    kernel, wider d 256-column slices."""
    _need_cuda()
    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_r, nt = 7, 13
    trow = torch.sort(torch.tensor([0, 1, 3, 4, 6], device="cuda")[
        torch.randint(0, 5, (nt,), device="cuda", generator=gen)]).values.int()
    tcol = torch.randint(0, n_r, (nt,), device="cuda", generator=gen).int()
    mask = torch.rand(nt, t, t, device="cuda", generator=gen) < 0.1
    if store is torch.int8:
        vals = (mask * torch.randint(1, 3, (nt, t, t), device="cuda", generator=gen)).to(torch.int8)
    else:
        vals = mask * torch.randn(nt, t, t, device="cuda", generator=gen)
    rows = n_r * t - 3
    q, k, v, g = (torch.randn(rows, d, device="cuda", generator=gen) for _ in range(4))
    before = dict(ft.LAUNCHES)
    chip_smoke.check_flash_kernels(*_tile_sets(trow, tcol, vals, n_r), q, k, v, g, rows)
    assert ft.LAUNCHES == {"fwd": before["fwd"] + 2, "dq": before["dq"] + 2,
                           "dkv": before["dkv"] + 2}


def _tile_sets(trow, tcol, vals, n_r):
    """The row-sorted tile set of tiles ``vals`` at row tiles ``trow``
    (sorted) and column tiles ``tcol`` (int32), and its transposed
    (source-sorted) twin, each as (vals, tile_row, tile_col, tile_rowptr)."""
    order = torch.argsort(tcol.long() * n_r + trow.long(), stable=True)
    vals_t = vals.transpose(1, 2)[order].contiguous()
    trow_t, tcol_t = tcol[order].contiguous(), trow[order].contiguous()

    def ptr(rows):
        return torch.cat([rows.new_zeros(1), torch.bincount(rows, minlength=n_r).cumsum(0).int()])

    return (vals, trow, tcol, ptr(trow)), (vals_t, trow_t, tcol_t, ptr(trow_t))


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.int8, torch.float32])
@pytest.mark.parametrize("case,t,d", [("hub", 256, 256), ("hub", 32, 100), ("hub", 16, 520),
                                      ("full-row", 256, 300), ("full-row", 32, 24),
                                      ("full-row", 16, 256)])
def test_flash_backward_compacted_lists(store, case, t, d):
    """K4 and K5's compacted lists on the shapes that stress them, with
    chip_smoke's checks (within 1e-5 + 1e-6 sum|terms|, a second launch
    of each kernel bitwise equal; K3 is checked alongside): a ~1%-full
    operand whose row tile 0 holds a tile in every column tile (the hub),
    row tile 2 empty, and edges from and into the rows of the ragged last
    row tile past `rows` (K4's and K5's terms there are 0; K3 counts them);
    "full-row" also fills row 5 of row tile 1's tiles (K4's list for that
    row takes ~3 T entries, so at T = 256 it drains before it overflows)
    and column 7 of column tile 2's tiles (K5's list for source row
    2 T + 7 takes ~4 T)."""
    _need_cuda()
    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_r = 7
    pairs = [(0, c) for c in range(n_r)] + [(1, 1), (1, 2), (1, 6), (3, 0), (4, 4), (5, 2),
                                             (6, 2), (6, 6)]
    trow, tcol = torch.tensor(pairs, device="cuda").int().T.contiguous()
    mask = torch.rand(len(pairs), t, t, device="cuda", generator=gen) < 0.01
    if case == "full-row":
        mask[trow == 1, 5, :] = True
        mask[tcol == 2, :, 7] = True
    mask[tcol == n_r - 1, t - 3:, t - 1] = True  # from source rows past `rows`
    mask[trow == n_r - 1, t - 1, :3] = True  # into destination rows past `rows`
    if store is torch.int8:
        vals = (mask * torch.randint(1, 3, mask.shape, device="cuda", generator=gen)).to(torch.int8)
    else:
        vals = mask * torch.randn(mask.shape, device="cuda", generator=gen)
    rows = n_r * t - 3
    q, k, v, g = (torch.randn(rows, d, device="cuda", generator=gen) for _ in range(4))
    before = dict(ft.LAUNCHES)
    chip_smoke.check_flash_kernels(*_tile_sets(trow, tcol, vals, n_r), q, k, v, g, rows)
    assert ft.LAUNCHES == {"fwd": before["fwd"] + 2, "dq": before["dq"] + 2,
                           "dkv": before["dkv"] + 2}


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.int8, torch.float32])
@pytest.mark.parametrize("t,d", [(256, 256), (256, 520), (32, 100)])
def test_flash_forward_compacted_lists(store, t, d):
    """K3's compacted lists, with chip_smoke's checks (y, m, den against the
    plain version, rows without an edge exactly (0, 0, -inf), a second
    launch bitwise equal): row tile 4's only tile takes its edges from the
    three sources past `rows` alone, so its rows with an edge come out
    m = 0, den = their edge count, num = 0 exactly (the features read as
    zero, but each edge counts in den); row 5 of row tile 1 is full in all
    three of its tiles (at T = 256 its list overflows and drains twice);
    row tile 2 holds no tile; d = 520 takes three 256-column slices, each
    of which must give the same m and den."""
    _need_cuda()
    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_r = 7
    pairs = [(0, 0), (0, 3), (1, 1), (1, 2), (1, 6), (3, 0), (4, 6), (5, 5), (6, 6)]
    trow, tcol = torch.tensor(pairs, device="cuda").int().T.contiguous()
    mask = torch.rand(len(pairs), t, t, device="cuda", generator=gen) < 0.05
    mask[trow == 1, 5, :] = True
    past = (trow == 4).nonzero()[0, 0]
    mask[past] = False
    mask[past, : t // 2, t - 3:] = torch.rand(t // 2, 3, device="cuda", generator=gen) < 0.7
    mask[past, 0, t - 1] = True
    if store is torch.int8:
        vals = (mask * torch.randint(1, 3, mask.shape, device="cuda", generator=gen)).to(torch.int8)
    else:
        vals = mask * torch.randn(mask.shape, device="cuda", generator=gen)
    rows = n_r * t - 3
    q, k, v, g = (torch.randn(rows, d, device="cuda", generator=gen) for _ in range(4))
    fwd_set, bwd_set = _tile_sets(trow, tcol, vals, n_r)
    before = dict(ft.LAUNCHES)
    chip_smoke.check_flash_kernels(fwd_set, bwd_set, q, k, v, g, rows)
    num, ml = ft.flash_tiles_fwd(*fwd_set, q, k, v, 1.0 / d ** 0.5)
    torch.cuda.synchronize()
    assert ft.LAUNCHES == {"fwd": before["fwd"] + 3, "dq": before["dq"] + 2,
                           "dkv": before["dkv"] + 2}
    count = mask[past].sum(1).float()
    has = count > 0
    block = slice(4 * t, 5 * t)
    assert int(has.sum()) > 0
    assert torch.equal(ml[block][has], torch.stack([torch.zeros_like(count), count], 1)[has])
    assert not num[block].any()
    assert torch.isneginf(ml[block][~has, 0]).all() and not ml[block][~has, 1].any()
    assert torch.isneginf(ml[2 * t: 3 * t, 0]).all() and not ml[2 * t: 3 * t, 1].any()


def _flash_operand(store, t, d, gen, n_r=7, nt=13):
    trow = torch.sort(torch.tensor([0, 1, 3, 4, 6], device="cuda")[
        torch.randint(0, 5, (nt,), device="cuda", generator=gen)]).values.int()
    tcol = torch.randint(0, n_r, (nt,), device="cuda", generator=gen).int()
    mask = torch.rand(nt, t, t, device="cuda", generator=gen) < 0.1
    mask[trow == 1, 5, :] = True  # a full row: K3's and K4's lists drain
    if store is torch.int8:
        vals = (mask * torch.randint(1, 3, (nt, t, t), device="cuda", generator=gen)).to(store)
    else:
        vals = (mask * torch.randn(nt, t, t, device="cuda", generator=gen)).to(store)
    return trow, tcol, vals


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d", [(32, 24), (64, 100), (256, 256), (16, 300), (32, 520)])
def test_flash_tiles_bf16_match_plain_versions(store, t, d):
    """K3, K4, K5's bf16 entry points (bf16 q, k, v, g; f32 outputs and
    stats) against their bf16 plain versions with chip_smoke's checks: the
    f32 sums' tolerance plus 2**-7 of the sum of the terms' magnitudes (a
    weight rounded to bf16 before its product may land one ulp apart), m
    and den as in f32, a second launch of each bitwise equal; only the bf16
    counts move.  d = 24, 256 and 520 take the 16-byte column path (8 bf16
    a load), 100 and 300 the scalar one; 300 and 520 more than one
    256-column slice; row tiles 2 and 5 uncovered, the last ragged."""
    _need_cuda()
    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_r = 7
    trow, tcol, vals = _flash_operand(store, t, d, gen, n_r)
    rows = n_r * t - 3
    q, k, v, g = (torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
                  for _ in range(4))
    before = (dict(ft.LAUNCHES), dict(ft.LAUNCHES_BF16))
    chip_smoke.check_flash_kernels(*_tile_sets(trow, tcol, vals, n_r), q, k, v, g, rows)
    assert ft.LAUNCHES == before[0]
    assert ft.LAUNCHES_BF16 == {kind: before[1][kind] + 2 for kind in ("fwd", "dq", "dkv")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_matmul_takes_exact_zero_weights_mid_row(dtype):
    """K1 with weights computed as ops/transformer.py computes them, exact
    zeros at live slots: every third slot of the hub row (which crosses many
    runs) and whole runs of it, all of rows 7..9, and the first and last
    slot of every run.  A skipped live slot adds 0 either way; the rows,
    runs and carries must come out as the plain version's, rows with only
    zero weights exactly 0."""
    _need_cuda()
    n, (g,) = _skewed_graphs((512, 512))
    w = g.blk_weight.clone()
    live = w != 0
    flat = w.view(-1)
    dst = (g.blk_rowblock[:, None].long() * g.block_rows + g.blk_local).view(-1)
    hub = (dst == 5) & live.view(-1)
    hub_slots = hub.nonzero()[:, 0]
    flat[hub_slots[::3]] = 0.0
    flat[hub_slots[200:600]] = 0.0  # whole runs of 128 slots
    flat[((dst >= 7) & (dst <= 9))] = 0.0
    run = 128  # csrc/scatter_matmul.cu's kRun
    flat[::run] = 0.0
    flat[run - 1::run] = 0.0
    x = torch.randn(n, 256, device="cuda").to(dtype)
    args = (g.blk_src, g.blk_local, w, g.blk_rowptr, g.block_rows, n)
    got = sm.scatter_matmul(x, *args)
    again = sm.scatter_matmul(x, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = sm.scatter_matmul_reference(x, *args)
    abs_sum = sm.scatter_matmul_reference(x.float().abs(), g.blk_src, g.blk_local, w.abs(),
                                          *args[3:])
    if dtype is torch.bfloat16:
        assert _within_bf16_tolerance(got, want, abs_sum)
    else:
        assert _within_sum_tolerance(got, want, abs_sum)
    assert not got[7:10].any()


@pytest.mark.cuda
def test_blocked_transformer_on_the_card():
    """ops/transformer.py's layer over a graph with rows of one in-edge,
    self loops, duplicate edges and isolated rows, through K1 on the card
    against the same layer through K1's plain version on the CPU, f32 and
    bf16 (chip_smoke phase 29's check); K1 launches once forward and three
    times backward, in the entry point of x's dtype."""
    _need_cuda()
    import chip_smoke

    chip_smoke.check_blocked_small(torch.device("cuda"))
