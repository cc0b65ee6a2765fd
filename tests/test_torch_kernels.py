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

# One PyTorch thread a test process, as tests/torch_cpu.py sets it for the
# other port files; set here so this file runs on its own with
# --noconftest, where a site package named ``tests`` can shadow the
# repository's tests directory.
torch.set_num_threads(1)


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


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shard", ["tiles", "no-tiles"])
def test_tile_matmul_over_gathered_buffer(shard, x_dtype):
    """K2 as a tiled partition's shard runs it: x is the gathered buffer of
    3 shards (3 x 256 rows), the output the shard's 256 rows (out_rows
    shorter than x), its tiles' rows shard-local and their columns global;
    a shard with no tile at all writes zeros.  Against the plain version,
    a second launch bitwise equal."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    t, d, n_r, shards = 64, 128, 4, 3
    rows = n_r * t
    nt = 9 if shard == "tiles" else 0
    trow = torch.sort(torch.randint(0, n_r - 1, (nt,), device="cuda", generator=gen)).values.int()
    tcol = torch.randint(0, shards * n_r, (nt,), device="cuda", generator=gen).int()
    ptr = torch.cat([trow.new_zeros(1), torch.bincount(trow, minlength=n_r).cumsum(0).int()])
    mask = torch.rand(nt, t, t, device="cuda", generator=gen) < 0.05
    vals = (mask * torch.randint(-2, 3, (nt, t, t), device="cuda", generator=gen)).to(torch.int8)
    x = torch.randn(shards * rows, d, device="cuda", generator=gen).to(x_dtype)
    got = tm.tile_matmul(vals, trow, tcol, ptr, x, rows)
    again = tm.tile_matmul(vals, trow, tcol, ptr, x, rows)
    torch.cuda.synchronize()
    assert got.shape == (rows, d) and got.dtype == x_dtype and torch.equal(got, again)
    want = tm.tile_matmul_reference(vals, trow, tcol, x, n_r, rows)
    abs_sum = tm.tile_matmul_reference(vals.abs(), trow, tcol, x.float().abs(), n_r, rows)
    if x_dtype == torch.float32:
        assert _within_sum_tolerance(got, want, abs_sum)
    else:
        assert _within_bf16_tolerance(got, want, abs_sum)
    assert not got[(n_r - 1) * t:].any()  # the last row tile has no tile
    if shard == "no-tiles":
        assert not got.any()


def _within_bf16_tolerance(got, want, abs_sum):
    # the kernel and the plain version each round an f32 sum once to bf16:
    # the f32 sums' tolerance plus one bf16 ulp (2**-7 relative) for the
    # two roundings
    return bool(((got.float() - want.float()).abs()
                 <= 1e-5 + 1e-6 * abs_sum + 2**-7 * want.float().abs()).all())


def _small_graph():
    """A launch far too small to fill the card: 300 edges into 40 of 3,000
    rows (a few runs; most of the output is rows no edge reaches)."""
    rng = np.random.default_rng(2)
    n = 3000
    dst = rng.integers(0, 40, 300) * 7
    w = rng.random(300).astype(np.float32) + 0.1
    return n, [tgraph.build_graph(rng.integers(0, n, 300), dst, w, num_nodes=n,
                                  block=(512, 512), device="cuda")]


def _bf16_into_nan(x, blk_src, blk_local, blk_weight, blk_rowptr, block_rows, out_rows):
    """The bf16 K1 launched as its wrapper launches it, into an output
    filled with NaN (the wrapper's comes from torch.empty): every row must
    be written.  Not counted in LAUNCHES_BF16."""
    out = torch.full((out_rows, x.shape[1]), float("nan"), dtype=torch.bfloat16,
                     device="cuda")
    sm._launch(x, blk_src, blk_local, blk_weight, blk_rowptr, block_rows, out)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 64, 72, 100, 256, 300, 520])
@pytest.mark.parametrize("kind", ["symmetrized", "skewed-512x512", "small", "hub-only"])
def test_scatter_matmul_bf16_matches_plain_version(cuda_graphs, kind, d):
    """K1 in bf16 against its plain version (f32 sums of bf16-rounded
    weights times bf16 x, one rounding a row): within one bf16 ulp beyond
    the f32 sums' tolerance; rows no edge reaches exactly zero (the output
    starts as NaN: the kernel writes every row); a second launch gives the
    same bits; only the bf16 count moves.  d across a lane's 16-byte load
    (8, 72), past one 256-column slice (300, 520), and 100 and 300 on the
    scalar column path (d % 8 != 0).  The skewed graph's hub row crosses
    many runs; "small" is a launch far too small to fill the card;
    "hub-only" takes the skewed graph's row-block 0 alone (a row pointer
    that empties the rest, so nearly all of out is rows no slot reaches)."""
    if kind == "symmetrized":
        n, graphs = cuda_graphs
        x = torch.randn(n, d, device="cuda")
    else:
        n, graphs = _skewed_graphs((512, 512)) if kind != "small" else _small_graph()
        x = torch.randn(n + 37, d, device="cuda")
    x = x.to(torch.bfloat16)
    for g in graphs:
        ptr = g.blk_rowptr
        if kind == "hub-only":
            ptr = ptr.clone()
            ptr[2:] = ptr[1]
        args = (g.blk_src, g.blk_local, g.blk_weight, ptr, g.block_rows, n)
        before = (sm.LAUNCHES, sm.LAUNCHES_BF16)
        got = sm.scatter_matmul(x, *args)
        again = sm.scatter_matmul(x, *args)
        into_nan = _bf16_into_nan(x, *args)
        torch.cuda.synchronize()
        assert (sm.LAUNCHES, sm.LAUNCHES_BF16) == (before[0], before[1] + 2)
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        assert torch.equal(got, into_nan)
        want = sm.scatter_matmul_reference(x, *args)
        abs_sum = sm.scatter_matmul_reference(
            x.float().abs(), g.blk_src, g.blk_local, g.blk_weight.abs(), *args[3:]
        )
        assert _within_bf16_tolerance(got, want, abs_sum)
        assert not got[(g.in_degrees == 0).nonzero()[:, 0]].any()
        if kind == "hub-only":
            assert not got[g.block_rows:].any()


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


# The tile pairs (row tile, column tile) of the drain cases below: row
# tile 2 and column tile 5 hold no tile, row tile 0 a tile in every other
# column tile.
_DRAIN_PAIRS = [(0, c) for c in (0, 1, 2, 3, 4, 6)] + [(1, 1), (1, 2), (1, 6), (3, 0), (3, 3),
                                                      (4, 4), (5, 2), (6, 2), (6, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("case,t,d", [("long", 64, 256), ("short", 64, 64), ("empty", 32, 24),
                                      ("full", 256, 256), ("nan", 64, 256), ("split", 64, 128)])
def test_tile_matmul_bf16_drain(store, case, t, d):
    """K2's bf16 kernel (its own scan and drain for 16-byte rows) on the
    lists that stress it, against its plain version within the f32 sums'
    tolerance plus one bf16 ulp, a second launch bitwise equal: "long" row
    3 of row tile 1 holds 40 entries in each of its tiles (more than the x
    rows in flight); "short" the rows of row tile 3 hold 0-3 entries;
    "empty" rows of no entry beside row tile 2, which holds no tile (zero);
    "full" row 5 of row tile 0 is full in its 6 tiles (1,536 entries: the
    list of 512 drains mid-scan); "nan" NaN in rows of x that the tiles
    hold only as zeros (the output stays finite: a zero is skipped, never
    multiplied); "split" x is the gathered buffer of 3 shards and the
    output the first shard's rows."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_r, shards = 7, 3 if case == "split" else 1
    trow, tcol = torch.tensor(_DRAIN_PAIRS, device="cuda").int().T.contiguous()
    if case == "split":
        tcol = (tcol + n_r * torch.randint(0, shards, tcol.shape, device="cuda",
                                           generator=gen)).int()
    mask = torch.rand(len(trow), t, t, device="cuda", generator=gen) < 0.02
    if case == "long":
        mask[trow == 1, 3, :] = False
        mask[trow == 1, 3, :40] = True
    elif case == "short":
        mask[trow == 3] = torch.rand(mask[trow == 3].shape, device="cuda", generator=gen) < 1.5 / t
    elif case == "empty":
        mask[:, ::2] = False  # every other row of every tile holds no entry
    elif case == "full":
        mask[trow == 0, 5, :] = True
    if store is torch.int8:
        vals = (mask * torch.randint(-2, 3, mask.shape, device="cuda", generator=gen)).to(store)
    else:
        vals = (mask * torch.randn(mask.shape, device="cuda", generator=gen)).to(store)
    n_x = shards * n_r * t - 3
    out_rows = n_r * t if case == "split" else n_x
    x = torch.randn(n_x, d, device="cuda", generator=gen).to(torch.bfloat16)
    x_plain = x
    if case == "nan":
        held = torch.zeros(shards * n_r * t, dtype=torch.bool, device="cuda")
        for i in range(len(trow)):
            held[int(tcol[i]) * t + torch.nonzero(vals[i].float().abs().sum(0))[:, 0]] = True
        free = torch.nonzero(~held[:n_x])[:, 0][::3]
        assert free.numel() > 0
        x = x.clone()
        x[free] = float("nan")
    ptr = torch.cat([trow.new_zeros(1), torch.bincount(trow, minlength=n_r).cumsum(0).int()])
    before = (tm.LAUNCHES, tm.LAUNCHES_BF16)
    got = tm.tile_matmul(vals, trow, tcol, ptr, x, out_rows)
    again = tm.tile_matmul(vals, trow, tcol, ptr, x, out_rows)
    torch.cuda.synchronize()
    assert (tm.LAUNCHES, tm.LAUNCHES_BF16) == (before[0], before[1] + 2)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    want = tm.tile_matmul_reference(vals, trow, tcol, x_plain, n_r, out_rows)
    abs_sum = tm.tile_matmul_reference(vals.to(torch.bfloat16).float().abs(), trow, tcol,
                                       x_plain.float().abs(), n_r, out_rows)
    assert _within_bf16_tolerance(got, want, abs_sum)
    assert not got[2 * t: 3 * t].any()


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("store", [torch.int8, torch.float32])
@pytest.mark.parametrize("t,d", [(256, 256), (256, 520), (32, 100)])
def test_flash_forward_compacted_lists(store, t, d, dtype):
    """K3's compacted lists, with chip_smoke's checks (y, m, den against the
    plain version, rows without an edge exactly (0, 0, -inf), a second
    launch bitwise equal): row tile 4's only tile takes its edges from the
    three sources past `rows` alone, so its rows with an edge come out
    m = 0, den = their edge count, num = 0 exactly (the features read as
    zero, but each edge counts in den); row 5 of row tile 1 is full in all
    three of its tiles (at T = 256 its list overflows and drains twice);
    row tile 2 holds no tile; d = 520 takes three 256-column slices, each
    of which must give the same m and den.  In bf16 (q, k, v, g; the bf16
    entries, K3's packed kernel where d % 8 == 0) the same."""
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
    q, k, v, g = (torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
                  for _ in range(4))
    fwd_set, bwd_set = _tile_sets(trow, tcol, vals, n_r)
    counts = ft.LAUNCHES_BF16 if dtype == torch.bfloat16 else ft.LAUNCHES
    before = dict(counts)
    chip_smoke.check_flash_kernels(fwd_set, bwd_set, q, k, v, g, rows)
    num, ml = ft.flash_tiles_fwd(*fwd_set, q, k, v, 1.0 / d ** 0.5)
    torch.cuda.synchronize()
    assert counts == {"fwd": before["fwd"] + 3, "dq": before["dq"] + 2,
                      "dkv": before["dkv"] + 2}
    count = mask[past].sum(1).float()
    has = count > 0
    block = slice(4 * t, 5 * t)
    assert int(has.sum()) > 0
    assert torch.equal(ml[block][has], torch.stack([torch.zeros_like(count), count], 1)[has])
    assert not num[block].any()
    assert torch.isneginf(ml[block][~has, 0]).all() and not ml[block][~has, 1].any()
    assert torch.isneginf(ml[2 * t: 3 * t, 0]).all() and not ml[2 * t: 3 * t, 1].any()


def _flash_operand(store, t, d, gen, n_r=7, nt=13, short=False):
    trow = torch.sort(torch.tensor([0, 1, 3, 4, 6], device="cuda")[
        torch.randint(0, 5, (nt,), device="cuda", generator=gen)]).values.int()
    tcol = torch.randint(0, n_r, (nt,), device="cuda", generator=gen).int()
    mask = torch.rand(nt, t, t, device="cuda", generator=gen) < 0.1
    if short:  # row tile 3's rows hold 0-3 entries each, beside longer rows
        mask[trow == 3] = torch.rand(mask[trow == 3].shape, device="cuda",
                                     generator=gen) < 1.5 / t
    mask[trow == 1, 5, :] = True  # a full row: K3's and K4's lists drain
    if store is torch.int8:
        vals = (mask * torch.randint(1, 3, (nt, t, t), device="cuda", generator=gen)).to(store)
    else:
        vals = (mask * torch.randn(nt, t, t, device="cuda", generator=gen)).to(store)
    return trow, tcol, vals


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d,short", [(32, 24, False), (64, 100, False), (256, 256, False),
                                       (16, 300, False), (32, 520, False), (64, 256, True),
                                       (256, 256, True), (256, 520, True), (16, 72, True)])
def test_flash_tiles_bf16_match_plain_versions(store, t, d, short):
    """K3, K4, K5's bf16 entry points (bf16 q, k, v, g; f32 outputs and
    stats) against their bf16 plain versions with chip_smoke's checks: the
    f32 sums' tolerance plus 2**-7 of the sum of the terms' magnitudes (a
    weight rounded to bf16 before its product may land one ulp apart), m
    and den as in f32, a second launch of each bitwise equal; only the bf16
    counts move.  d = 24, 72, 256 and 520 take the 16-byte column path (8
    bf16 a load; K3's packed kernel), 100 and 300 the scalar one; 300 and
    520 more than one 256-column slice; row tiles 2 and 5 uncovered, the
    last ragged; row 5 of row tile 1 full (several chunks, and at T = 256
    a drain of the list mid-row); with ``short`` row tile 3's rows hold
    0-3 entries each, packed into the lanes beside the longer rows."""
    _need_cuda()
    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_r = 7
    trow, tcol, vals = _flash_operand(store, t, d, gen, n_r, short=short)
    rows = n_r * t - 3
    q, k, v, g = (torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
                  for _ in range(4))
    before = (dict(ft.LAUNCHES), dict(ft.LAUNCHES_BF16))
    chip_smoke.check_flash_kernels(*_tile_sets(trow, tcol, vals, n_r), q, k, v, g, rows)
    assert ft.LAUNCHES == before[0]
    assert ft.LAUNCHES_BF16 == {kind: before[1][kind] + 2 for kind in ("fwd", "dq", "dkv")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(32, 24), (64, 100), (256, 256), (32, 520), (256, 520)])
def test_flash_tiles_split_counts(dtype, t, d):
    """K3, K4, K5 (f32 on int8 tiles; bf16 on bf16 tiles) as the shards of
    a 3-shard tiled partition run them: own rows 2 t a shard, gathered rows
    6 t; K3 and K4 with q, g and the stats of the own rows and k, v of the
    gathered ones, K5 with k, v of the own rows and q, g and the stats of
    the gathered ones, against their plain versions with chip_smoke's
    checks (phase 31d), a second launch of each bitwise equal.  Shard 2
    holds no tile, shard 0 no transposed tile, row tile 1 of shard 1 no
    tile: their rows come out (0, 0, -inf) from K3 and zero from K4, K5."""
    _need_cuda()
    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(4)
    shards, n_r = 3, 2
    rps = n_r * t
    grid = torch.argwhere(torch.rand(shards * n_r, shards * n_r, device="cuda",
                                     generator=gen) < 0.5)
    keep = ((grid[:, 0] // n_r != shards - 1) & (grid[:, 0] != n_r + 1)
            & (grid[:, 1] // n_r != 0))
    trow, tcol = grid[keep, 0].int(), grid[keep, 1].int()
    mask = torch.rand(len(trow), t, t, device="cuda", generator=gen) < 0.1
    vals = (mask * 1).to(torch.int8 if dtype == torch.float32 else torch.bfloat16)

    def tile_set(rows, cols, v):  # sorted by the shard-local row tile
        order = torch.argsort(rows.long() * shards * n_r + cols.long())
        rows = rows[order].contiguous()
        ptr = torch.cat([rows.new_zeros(1), torch.bincount(rows, minlength=n_r).cumsum(0).int()])
        return v[order].contiguous(), rows, cols[order].contiguous(), ptr

    sets = []
    for s in range(shards):
        f, b = trow // n_r == s, tcol // n_r == s
        sets.append((tile_set(trow[f] - s * n_r, tcol[f], vals[f]),
                     tile_set(tcol[b] - s * n_r, trow[b], vals[b].transpose(1, 2))))
    assert not len(sets[-1][0][0]) and not len(sets[0][1][0])
    q, k, v, g = (torch.randn(shards * rps, d, device="cuda", generator=gen).to(dtype)
                  for _ in range(4))
    counts = ft.LAUNCHES_BF16 if dtype == torch.bfloat16 else ft.LAUNCHES
    before = dict(counts)
    chip_smoke.check_flash_split(sets, q, k, v, g, rps)
    assert counts == {"fwd": before["fwd"] + 2 * shards, "dq": before["dq"] + 2 * shards,
                      "dkv": before["dkv"] + 2 * shards}


_DRAIN_CASES = [("long", 64, 256), ("short", 64, 256), ("empty", 32, 24), ("full", 256, 256),
                ("split", 64, 256), ("wide", 32, 264), ("odd", 32, 100)]


def _check_bf16_drain(kind, store, case, t, d, seed):
    """The bf16 entries of K3-K5 with chip_smoke's checks (phase 27's
    tolerances, a second launch of each bitwise equal) on the tiles of
    _DRAIN_PAIRS, 3% full, whose lists stress the drain of K4 (``kind``
    "dq": the cases hit destination rows, the tiles' rows of row tile
    ``at`` = 0) or of K5 ("dkv": source rows, the tiles' columns of column
    tile ``at`` = 2): "long" row 9 of ``at`` takes 40 entries from each of
    its tiles; "short" the rows of tile 3 hold 0-3 entries; "empty" every
    other row holds no entry, and the row tile ``idle`` (K4: 2, K5: 5) no
    tile, so its rows come out zero; "full" row 7 of ``at`` is full in
    each of its tiles; "split" two shards at split row counts (own rows
    7 T, the gathered buffer 14 T); "wide" and "odd" (d = 264, 100) take
    drain_bwd."""
    _need_cuda()
    import chip_smoke

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_r = 7
    trow, tcol = torch.tensor(_DRAIN_PAIRS, device="cuda").int().T.contiguous()
    mask = torch.rand(len(trow), t, t, device="cuda", generator=gen) < 0.03
    # the drained rows as the first tile axis: K5's are the tiles' columns
    own, rows_of, at, idle = ((trow, mask, 0, 2) if kind == "dq" else
                              (tcol, mask.transpose(1, 2), 2, 5))
    if case == "long":
        rows_of[own == at, 9, :] = False
        rows_of[own == at, 9, :40] = True
    elif case == "short":
        mask[own == 3] = torch.rand(mask[own == 3].shape, device="cuda", generator=gen) < 1.5 / t
    elif case == "empty":
        rows_of[:, ::2, :] = False
    elif case == "full":
        rows_of[own == at, 7, :] = True
    if store is torch.int8:
        vals = (mask * torch.randint(1, 3, mask.shape, device="cuda", generator=gen)).to(store)
    else:
        vals = (mask * torch.randn(mask.shape, device="cuda", generator=gen)).to(store)
    before = dict(ft.LAUNCHES_BF16)
    if case == "split":
        # a 2 n_r operand whose shard s owns row tiles [s n_r, (s + 1) n_r):
        # the pairs twice (the second shifted by n_r), their columns spread
        # over both shards
        rps = n_r * t
        trow2 = torch.cat([trow, trow + n_r])
        tcol2 = (torch.cat([tcol, tcol + n_r]) * 3 % (2 * n_r)).int()
        vals = torch.cat([vals, vals.flip(0)])

        def tile_set(rows, cols, v):  # sorted by the shard-local row tile
            order = torch.argsort(rows.long() * 2 * n_r + cols.long())
            rows = rows[order].contiguous()
            ptr = torch.cat([rows.new_zeros(1),
                             torch.bincount(rows, minlength=n_r).cumsum(0).int()])
            return v[order].contiguous(), rows, cols[order].contiguous(), ptr

        sets = []
        for s in range(2):
            f, b = trow2 // n_r == s, tcol2 // n_r == s
            sets.append((tile_set(trow2[f] - s * n_r, tcol2[f], vals[f]),
                         tile_set(tcol2[b] - s * n_r, trow2[b], vals[b].transpose(1, 2))))
        q, k, v, g = (torch.randn(2 * rps, d, device="cuda", generator=gen).to(torch.bfloat16)
                      for _ in range(4))
        chip_smoke.check_flash_split(sets, q, k, v, g, rps)
        assert ft.LAUNCHES_BF16 == {kd: before[kd] + 4 for kd in ("fwd", "dq", "dkv")}
        return
    rows = n_r * t - 3
    q, k, v, g = (torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
                  for _ in range(4))
    fwd_set, bwd_set = _tile_sets(trow, tcol, vals, n_r)
    stats, _ = chip_smoke.check_flash_kernels(fwd_set, bwd_set, q, k, v, g, rows)
    scale = 1.0 / d ** 0.5
    outs = ([ft.flash_tiles_dq(*fwd_set, q, k, v, g, stats, scale)] if kind == "dq" else
            ft.flash_tiles_dkv(*bwd_set, q, k, v, g, stats, scale))
    torch.cuda.synchronize()
    assert ft.LAUNCHES_BF16 == {kd: before[kd] + (3 if kd == kind else 2)
                                for kd in ("fwd", "dq", "dkv")}
    assert not any(o[idle * t: (idle + 1) * t].any() for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("case,t,d", _DRAIN_CASES)
def test_flash_dkv_bf16_drain(store, case, t, d):
    """K5's bf16 entry (its own drain for 16-byte rows and d <= 256; the
    wide path, d = 264, and the scalar one, d = 100, keep drain_bwd) on the
    lists that stress it, K3 and K4 alongside (_check_bf16_drain): "long"
    source row 2 T + 9 gathers from 40 rows of each tile of column tile 2
    (more than a 32-entry batch of stats and than the entries in flight);
    "short" the source rows of column tile 3 hold 0-3 entries; "empty"
    every other source row holds no entry, and column tile 5 no tile (K5's
    rows of row tile 5 zero); "full" source row 2 T + 7 is full in the 4
    tiles of column tile 2 (1,024 entries: the list of 512 drains
    mid-scan); "split" two shards at split row counts (rows_g is not
    rows)."""
    _check_bf16_drain("dkv", store, case, t, d, seed=6)


@pytest.mark.cuda
@pytest.mark.parametrize("store", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("case,t,d", _DRAIN_CASES)
def test_flash_dq_bf16_drain(store, case, t, d):
    """K4's bf16 entry (its own kernel for 16-byte rows and d <= 256; the
    wide path, d = 264, and the scalar one, d = 100, keep drain_bwd) on the
    lists that stress it, K3 and K5 alongside (_check_bf16_drain): "long"
    destination row 9 gathers from 40 columns of each of row tile 0's 6
    tiles (more than a step's entries and than a 32-entry batch); "short"
    the rows of row tile 3 hold 0-3 entries; "empty" every other
    destination row holds no entry, and row tile 2 no tile (its dq zero);
    "full" row 7 of row tile 0 is full in its 6 tiles (1,536 entries at
    T = 256: the list of 512 drains mid-scan); "split" two shards at split
    row counts (rows_g is not rows)."""
    _check_bf16_drain("dq", store, case, t, d, seed=7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_matmul_takes_exact_zero_weights_mid_row(dtype):
    """K1 with weights computed as ops/transformer.py computes them, exact
    zeros at live slots: every third slot of the hub row (which crosses many
    runs) and whole runs of it, all of rows 7..9, and the first and last
    slot of every run.  A skipped live slot adds 0 either way; the rows,
    runs and carries must come out as the plain version's, rows with only
    zero weights exactly 0 (in bf16 the output starts as NaN)."""
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
    if dtype is torch.bfloat16:
        assert torch.equal(got, _bf16_into_nan(x, *args))
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
