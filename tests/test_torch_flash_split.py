"""K3-K5's plain versions at split row counts (``ops/flash_tiles.py``)
against the JAX package's partials for a shard of a tiled partition.

A shard of a tiled partition owns ``rows_per_shard`` rows and gathers from
the all-gathered buffer of every shard's: K3 and K4 take q (and g and the
stats) of the own rows and k, v of the gathered ones; K5 takes k, v of the
own rows and q, g and the stats of the gathered ones.  The JAX package's
``parallel/tile_transformer.py`` computes the same partials on its CPU mesh
with ``_fallback_fwd_partials``, ``_fallback_dq`` and ``_fallback_dkv``
(plain ``jnp``, no mesh), from local Q tiles and global K/V tiles; each
case holds the port's wrapper on CPU tensors (its plain version) against
them on the same numpy inputs, shard by shard, at T = 16, D = 16, S = 2
(the gathered rows 5 short of the last column tile, which reads zeros
past them) and S = 4; shard S-1 holds no tile and shard 0 no transposed
tile, and row tile 1 of every shard no tile.  Tolerance 1e-5 + 1e-6
sum|terms| in f32; in bf16 (the JAX side fed the bf16-rounded f32 inputs)
plus 2**-7 sum|terms| (each second product's weight is rounded to bf16).
Also: with the two counts equal the plain versions give the bits of the
single-count plain versions they replaced, and wrong shapes raise.
"""

import math

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)
from plnlp_tpu_torch.ops import flash_tiles as ft

T, D, NRL = 16, 16, 3  # tile, width, row tiles a shard
RPS = NRL * T
SCALE = 1.0 / math.sqrt(D)
BF16_RTOL = 2.0**-7


def _tile_set(rows, cols, vals):
    """(vals, tile_row, tile_col, tile_rowptr) sorted by row tile."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=NRL))]).astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(vals)), torch.from_numpy(rows.astype(np.int32)),
            torch.from_numpy(cols.astype(np.int32)), torch.from_numpy(ptr))


def _case(shards, seed=0):
    """Every shard's forward and transposed tile sets (rows local, columns
    global) and the gathered q, k, v, g (S * RPS rows, f32) with random
    global row stats (M, den, δ)."""
    r = np.random.default_rng(seed)
    n_rt = shards * NRL
    grid = np.argwhere(r.random((n_rt, n_rt)) < 0.4)
    keep = (grid[:, 0] // NRL != shards - 1) & (grid[:, 0] % NRL != 1) & (grid[:, 1] // NRL != 0)
    trow, tcol = grid[keep, 0], grid[keep, 1]
    vals = ((r.random((len(trow), T, T)) < 0.15) * r.integers(1, 3, (len(trow), T, T))
            ).astype(np.int8)
    sets = []
    for s in range(shards):
        f = trow // NRL == s
        b = tcol // NRL == s
        sets.append((_tile_set(trow[f] - s * NRL, tcol[f], vals[f]),
                     _tile_set(tcol[b] - s * NRL, trow[b], vals[b].transpose(0, 2, 1))))
    n = shards * RPS
    q, k, v, g = (r.standard_normal((n, D)).astype(np.float32) for _ in range(4))
    stats = np.stack([r.standard_normal(n), r.uniform(1, 3, n), r.standard_normal(n)],
                     1).astype(np.float32)
    assert not len(sets[-1][0][0]) and not len(sets[0][1][0])
    return sets, q, k, v, g, stats


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _feats(arrays, dtype):
    """The torch arrays the port gets and the numpy ones JAX gets (bf16:
    the bf16-rounded values in f32)."""
    if dtype == "float32":
        return [torch.from_numpy(a) for a in arrays], arrays
    ts = [_bf16(a) for a in arrays]
    return ts, [t.float().numpy() for t in ts]


def _jtiles(a, n_tiles):
    """(rows, D) -> (n_tiles, T, D), zero past the rows, as JAX's tiles."""
    out = np.zeros((n_tiles * T, a.shape[1]), np.float32)
    out[: a.shape[0]] = a
    return out.reshape(n_tiles, T, -1)


def _jstats(st, n_tiles):
    out = np.zeros((n_tiles * T, 3), np.float32)
    out[:, 1] = 1.0
    out[: st.shape[0]] = st
    return out


def _tol(dtype):
    return 1e-6 + (BF16_RTOL if dtype == "bfloat16" else 0.0)


def _gathered_rows(shards):
    # S = 2: the last column tile ragged (its last 5 rows past the
    # gathered count read as zeros); S = 4: whole tiles
    return shards * RPS - (5 if shards == 2 else 0)


CASES = [(s, dt) for s in (2, 4) for dt in ("float32", "bfloat16")]
IDS = [f"S{s}-{dt}" for s, dt in CASES]


@pytest.mark.parametrize("shards,dtype", CASES, ids=IDS)
def test_split_fwd_matches_jax(shards, dtype):
    import jax.numpy as jnp

    from plnlp_tpu.parallel.tile_transformer import _fallback_fwd_partials

    sets, q, k, v, _, _ = _case(shards)
    n_g = _gathered_rows(shards)
    (qt, kt, vt), (qn, kn, vn) = _feats([q, k[:n_g], v[:n_g]], dtype)
    n_ct = -(-n_g // T)
    for s, (fwd, _) in enumerate(sets):
        own = slice(s * RPS, (s + 1) * RPS)
        num, ml = ft.flash_tiles_fwd(*fwd, qt[own].contiguous(), kt, vt, SCALE)
        num_a, _ = ft.flash_tiles_fwd(*fwd, qt[own].contiguous(), kt, vt.abs(), SCALE)
        jargs = (jnp.asarray(fwd[0].numpy()), jnp.asarray(fwd[1].numpy()),
                 jnp.asarray(fwd[2].numpy()), jnp.asarray(_jtiles(qn[own], NRL)),
                 jnp.asarray(_jtiles(kn, n_ct)), jnp.asarray(_jtiles(vn, n_ct)))
        num_j, den_j, m_j = (np.asarray(a) for a in _fallback_fwd_partials(*jargs, NRL, SCALE))
        m, den = ml[:, 0].numpy(), ml[:, 1].numpy()
        has = den_j > 0
        msg = f"S={shards} shard {s} {dtype}"
        assert (np.isneginf(m) == ~has).all() and not num[~has].any() and not den[~has].any(), msg
        np.testing.assert_allclose(m[has], m_j[has], rtol=1e-6, atol=1e-6, err_msg=msg)
        np.testing.assert_allclose(den[has], den_j[has], rtol=1e-5, atol=1e-5, err_msg=msg)
        y, y_j = num.numpy()[has] / den[has, None], num_j[has] / den_j[has, None]
        tol = 1e-5 + _tol(dtype) * num_a.numpy()[has] / den[has, None]
        assert (np.abs(y - y_j) <= tol).all(), msg
        # row tile 1 holds no tile; shard S-1 none at all
        assert (~has).any() and has.any() == (s < shards - 1), msg


def _bwd_inputs(shards, dtype):
    sets, q, k, v, g, stats = _case(shards)
    n_g = _gathered_rows(shards)
    return sets, stats, n_g, _feats([q, k, v, g], dtype)


@pytest.mark.parametrize("shards,dtype", CASES, ids=IDS)
def test_split_dq_matches_jax(shards, dtype):
    import chip_smoke
    import jax.numpy as jnp

    from plnlp_tpu.parallel.tile_transformer import _fallback_dq

    sets, stats, n_g, ((qt, kt, vt, gt), (qn, kn, vn, gn)) = _bwd_inputs(shards, dtype)
    kt, vt, kn, vn = kt[:n_g], vt[:n_g], kn[:n_g], vn[:n_g]
    n_ct = -(-n_g // T)
    for s, (fwd, _) in enumerate(sets):
        own = slice(s * RPS, (s + 1) * RPS)
        q_o, g_o = qt[own].contiguous(), gt[own].contiguous()
        st = torch.from_numpy(stats[own].copy())
        dq = ft.flash_tiles_dq(*fwd, q_o, kt, vt, g_o, st, SCALE)
        (mag,) = chip_smoke.flash_bwd_magnitudes(*fwd[:3], q_o, kt, vt, g_o, st, SCALE, False)
        want = np.asarray(_fallback_dq(
            jnp.asarray(fwd[0].numpy()), jnp.asarray(fwd[1].numpy()), jnp.asarray(fwd[2].numpy()),
            jnp.asarray(_jtiles(qn[own], NRL)), jnp.asarray(_jtiles(kn, n_ct)),
            jnp.asarray(_jtiles(vn, n_ct)), jnp.asarray(_jtiles(gn[own], NRL)),
            jnp.asarray(stats[own]), NRL, SCALE))
        msg = f"S={shards} shard {s} {dtype}"
        assert (np.abs(dq.numpy() - want) <= 1e-5 + _tol(dtype) * mag.numpy()).all(), msg
        if s == shards - 1:  # no tile on this shard: K4's dq is zero
            assert not dq.any(), msg


@pytest.mark.parametrize("shards,dtype", CASES, ids=IDS)
def test_split_dkv_matches_jax(shards, dtype):
    import chip_smoke
    import jax.numpy as jnp

    from plnlp_tpu.parallel.tile_transformer import _fallback_dkv

    sets, stats, n_g, ((qt, kt, vt, gt), (qn, kn, vn, gn)) = _bwd_inputs(shards, dtype)
    qt, gt, qn, gn = qt[:n_g], gt[:n_g], qn[:n_g], gn[:n_g]
    st_full = torch.from_numpy(stats[:n_g].copy())
    n_ct = -(-n_g // T)
    for s, (_, bwd) in enumerate(sets):
        own = slice(s * RPS, (s + 1) * RPS)
        k_o, v_o = kt[own].contiguous(), vt[own].contiguous()
        dk, dv = ft.flash_tiles_dkv(*bwd, qt, k_o, v_o, gt, st_full, SCALE)
        mags = chip_smoke.flash_bwd_magnitudes(*bwd[:3], qt, k_o, v_o, gt, st_full, SCALE, True)
        want = _fallback_dkv(
            jnp.asarray(bwd[0].numpy()), jnp.asarray(bwd[1].numpy()), jnp.asarray(bwd[2].numpy()),
            jnp.asarray(_jtiles(qn, n_ct)), jnp.asarray(_jtiles(kn[own], NRL)),
            jnp.asarray(_jtiles(vn[own], NRL)), jnp.asarray(_jtiles(gn, n_ct)),
            jnp.asarray(_jstats(stats[:n_g], n_ct)), NRL, SCALE)
        msg = f"S={shards} shard {s} {dtype}"
        for name, got, w, mag in zip(("dk", "dv"), (dk, dv), want, mags):
            assert (np.abs(got.numpy() - np.asarray(w)) <= 1e-5 + _tol(dtype) * mag.numpy()
                    ).all(), f"{msg} {name}"
        if s == 0:  # no transposed tile on this shard
            assert not dk.any() and not dv.any(), msg


# The plain versions as they were before the gathered count, every array
# padded to the own row tiles (one chunk: the cases hold under 64 tiles).


def _old_tiles(a, n, t):
    a = a.float()
    pad = n * t - a.shape[0]
    if pad:
        a = torch.cat([a, a.new_zeros((pad, a.shape[1]))])
    return a.reshape(n, t, a.shape[1])


def _old_stats(stats, n, t):
    pad = n * t - stats.shape[0]
    if pad:
        fill = stats.new_zeros((pad, 3))
        fill[:, 1] = 1.0
        stats = torch.cat([stats, fill])
    s = stats.reshape(n, t, 3)
    return s[..., 0], s[..., 1], s[..., 2]


def _old_fwd(vals, trow, tcol, q, k, v, n, scale):
    t, rows, d = vals.shape[1], q.shape[0], q.shape[1]
    qt, kt, vt = (_old_tiles(a, n, t) for a in (q, k, v))
    trow, tcol = trow.long(), tcol.long()
    m = qt.new_full((n * t,), float("-inf"))
    s = torch.bmm(qt[trow], kt[tcol].transpose(1, 2)) * scale
    s = torch.where(vals != 0, s, float("-inf"))
    m.scatter_reduce_(0, (trow[:, None] * t + torch.arange(t)).reshape(-1), s.amax(2).reshape(-1),
                      "amax")
    m = m.reshape(n, t)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.bmm(qt[trow], kt[tcol].transpose(1, 2)) * scale
    p = torch.where(vals != 0, torch.exp(s - m_safe[trow][:, :, None]), 0.0)
    den = qt.new_zeros((n, t)).index_add_(0, trow, p.sum(2))
    num = qt.new_zeros((n, t, d)).index_add_(0, trow, torch.bmm(p.to(v.dtype).float(), vt[tcol]))
    return num.reshape(-1, d)[:rows], torch.stack([m, den], -1).reshape(-1, 2)[:rows]


def _old_bwd(vals, trow, tcol, q, k, v, g, stats, n, scale, transposed):
    t, rows, d = vals.shape[1], q.shape[0], q.shape[1]
    qt, kt, vt, gt = (_old_tiles(a, n, t) for a in (q, k, v, g))
    m, den, delta = _old_stats(stats, n, t)
    r, c = trow.long(), tcol.long()
    if transposed:
        s = torch.bmm(kt[r], qt[c].transpose(1, 2)) * scale
        dav = torch.bmm(vt[r], gt[c].transpose(1, 2))
        st = [a[c][:, None, :] for a in (m, den, delta)]
    else:
        s = torch.bmm(qt[r], kt[c].transpose(1, 2)) * scale
        dav = torch.bmm(gt[r], vt[c].transpose(1, 2))
        st = [a[r][:, :, None] for a in (m, den, delta)]
    alpha = torch.where(vals != 0, torch.exp(s - st[0]) / st[1], 0.0)
    ds = alpha * (dav - st[2]) * scale
    if not transposed:
        out = qt.new_zeros((n, t, d)).index_add_(0, r, torch.bmm(ds.to(k.dtype).float(), kt[c]))
        return out.reshape(-1, d)[:rows]
    dk = qt.new_zeros((n, t, d)).index_add_(0, r, torch.bmm(ds.to(q.dtype).float(), qt[c]))
    dv = qt.new_zeros((n, t, d)).index_add_(0, r, torch.bmm(alpha.to(g.dtype).float(), gt[c]))
    return dk.reshape(-1, d)[:rows], dv.reshape(-1, d)[:rows]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_equal_counts_give_the_single_count_bits(dtype):
    """One operand (own rows = gathered rows = 3 T - 3, a ragged last row
    tile): K3, K4 and K5 give the bits of the single-count plain versions."""
    r = np.random.default_rng(3)
    n_r, rows = 3, 3 * T - 3
    trow = np.repeat(np.arange(n_r), 3)
    tcol = np.tile(np.arange(n_r), n_r)
    vals = ((r.random((len(trow), T, T)) < 0.2) * 1).astype(np.int8)
    fwd = _tile_set(trow, tcol, vals)
    bwd = _tile_set(tcol, trow, vals.transpose(0, 2, 1))
    (q, k, v, g), _ = _feats([r.standard_normal((rows, D)).astype(np.float32) for _ in range(4)],
                             dtype)
    stats = torch.from_numpy(np.stack([r.standard_normal(rows), r.uniform(1, 3, rows),
                                       r.standard_normal(rows)], 1).astype(np.float32))
    for got, want in zip(ft.flash_tiles_fwd(*fwd, q, k, v, SCALE),
                         _old_fwd(*fwd[:3], q, k, v, n_r, SCALE)):
        assert torch.equal(got, want)
    assert torch.equal(ft.flash_tiles_dq(*fwd, q, k, v, g, stats, SCALE),
                       _old_bwd(*fwd[:3], q, k, v, g, stats, n_r, SCALE, False))
    for got, want in zip(ft.flash_tiles_dkv(*bwd, q, k, v, g, stats, SCALE),
                         _old_bwd(*bwd[:3], q, k, v, g, stats, n_r, SCALE, True)):
        assert torch.equal(got, want)


def test_wrong_split_shapes_raise():
    """The stats must have K4's own rows and K5's gathered rows; a tile
    column must start below the gathered rows (the wrappers check it on CPU
    tensors, ``GraphParallel.place`` on a partition's tiles); the gathered
    (and the own) arrays must share one shape."""
    from plnlp_tpu_torch.parallel import Mesh, partition_graph
    from plnlp_tpu_torch.parallel.graph_parallel import GraphParallel

    r = np.random.default_rng(1)
    src, dst = r.integers(0, 90, 900), r.integers(0, 90, 900)
    pg = partition_graph(src, dst, None, num_nodes=90, num_shards=2, block=(8, 32), tile=T,
                         min_fill=2, reorder="labelprop")
    GraphParallel.place(pg, Mesh(1, 2))
    pg.tiles_t[0]["col"] = pg.tiles_t[0]["col"] + 2 * pg.rows_per_shard // T
    with pytest.raises(ValueError, match="past the"):
        GraphParallel.place(pg, Mesh(1, 2))

    sets, q, k, v, g, stats = _case(2)
    (fwd, bwd) = sets[0][0], sets[1][1]
    q, k, v, g, stats = (torch.from_numpy(a) for a in (q, k, v, g, stats))
    own = slice(0, RPS)
    q_o, g_o, k_o, v_o = (a[own].contiguous() for a in (q, g, k, v))
    with pytest.raises(ValueError, match="stats"):
        ft.flash_tiles_dq(*fwd, q_o, k, v, g_o, stats, SCALE)  # gathered rows
    with pytest.raises(ValueError, match="stats"):
        ft.flash_tiles_dkv(*bwd, q, k_o, v_o, g, stats[own].contiguous(), SCALE)  # own rows
    short = (int(fwd[2].max()) * T) - 1  # the last tile column starts past these rows
    with pytest.raises(ValueError, match="past the"):
        ft.flash_tiles_fwd(*fwd, q_o, k[:short], v[:short], SCALE)
    with pytest.raises(ValueError, match="gathered"):
        ft.flash_tiles_dq(*fwd, q_o, k, v[:-1], g_o, stats[own].contiguous(), SCALE)
    with pytest.raises(ValueError, match="own"):
        ft.flash_tiles_dkv(*bwd, q, k_o, v, g, stats, SCALE)
