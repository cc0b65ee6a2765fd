"""Block-sparse flash attention over the dense tiles: the three CUDA kernels
and their plain versions.

Replaces the TPU kernels of ``plnlp_tpu/ops/pallas_attention.py``:

* K3 :func:`flash_tiles_fwd` (``_fwd_kernel``) — for each destination row,
  over the tiles of its row tile, the scores ``s = scale * q kᵀ`` masked
  where ``vals == 0``; returns the tile-local softmax partials ``num`` (rows,
  D) and ``ml`` (rows, 2) = (m, den), with ``m`` the row's largest masked
  score and ``num``/``den`` the sums of ``exp(s - m) v`` and ``exp(s - m)``
  (``m`` read as 0 while it is -inf).  Rows with no tile edge come out
  num = 0, den = 0, m = -inf.
* K4 :func:`flash_tiles_dq` (``_dq_kernel``) — with the caller's global row
  stats ``stats`` (rows, 3) = (M, den, δ): ``α = mask ? exp(s - M) / den : 0``,
  ``ds = α (g vᵀ - δ) scale``, ``dq = Σ ds k``.
* K5 :func:`flash_tiles_dkv` (``_dkv_kernel``) — the same over the
  transposed tile set (rows = source, columns = destination, stats per
  destination): ``dk = Σ ds_tᵀ q``, ``dv = Σ α_tᵀ g``, accumulated per
  source row.

Two row counts: the rows a call owns (its output rows, bounded by
``tile_rowptr``'s row tiles) and the rows its tile columns gather from.
K3 owns q and gathers k, v; K4 owns q, g and ``stats`` and gathers k, v;
K5 owns k, v and gathers q, g and ``stats``.  Over one operand the two
counts are equal (num_nodes, or n_pad under padded-carry); on a shard of a
tiled partition the own rows are its ``rows_per_shard`` slots and the
gathered rows the all-gathered buffer of every shard's
(``parallel/tile_transformer.py``).  Rows past either count read as zero
features and stats (0, 1, 0).  A tile column must start below the gathered
rows: the wrappers check it on CPU tensors, where it costs nothing, and
``GraphParallel.place`` checks a partition's tiles once; on the card it is
the caller's guarantee.  q, k, v and g are float32 or, all four, bfloat16; the tile
store ``vals`` is int8, float32 or bfloat16 and only its zero pattern is
read.  The outputs and the stats are float32 either way.  In bfloat16 the
functions are the TPU kernels' with bf16 features: the scores and g·v are
f32 sums of bf16 products, and the weight of each second product is
rounded to bf16 first (K3 ``num += bf16(p) v`` while ``den`` sums the f32
p; K4 ``dq += bf16(ds) k``; K5 ``dk += bf16(ds) q``, ``dv += bf16(α) g``).  A row tile's tiles are found through ``tile_rowptr``, so the
TPU kernel's first/last-visit flags and its lane-wide stats layouts are not
needed.  The mask is a select everywhere: pad rows may carry features
whose masked ``exp`` overflows, and ``0 * inf`` would be NaN.

CUDA tensors launch ``csrc/flash_tiles.cu``, whose header gives the bound
and the design.  Each kernel gives each output row to one warp: it reads
its row of each tile once, compacts the nonzeros into a list and gathers
only their rows (k and v for K3 and K4; q, g and the stats for K5), so
zeros of ``vals`` are skipped, never multiplied, and a second launch gives
the same bits.  CPU tensors take the ``*_reference`` plain versions, which
stream the tiles in chunks of 64 so that no (nt, T, T) score tensor or
(nt, T, D) gather is ever whole.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "flash_tiles_fwd",
    "flash_tiles_dq",
    "flash_tiles_dkv",
    "flash_tiles_fwd_reference",
    "flash_tiles_dq_reference",
    "flash_tiles_dkv_reference",
    "LAUNCHES",
    "LAUNCHES_BF16",
]

# Kernel launches per kernel since the counts were last set to 0 (read by
# chip_smoke.py to show that the main path ran through the kernels):
# LAUNCHES for float32 features, LAUNCHES_BF16 for bfloat16.
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}
LAUNCHES_BF16 = {"fwd": 0, "dq": 0, "dkv": 0}

_FEATURES = (torch.float32, torch.bfloat16)
# the tile store's code in the C interface
_VALS_KIND = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}

# Tiles per step of the plain versions: bounds the live (C, T, T) scores.
_CHUNK = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # vals, vals_kind, tile_col, tile_rowptr, q, k, v, num, ml,
    # n_rowtiles, tile, rows, rows_g, d, scale, stream
    "fwd": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # vals, vals_kind, tile_col, tile_rowptr, q, k, v, g, stats, dq,
    # n_rowtiles, tile, rows, rows_g, d, scale, stream
    "dq": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # vals_t, vals_kind, tile_col_t, tile_rowptr_t, q, k, v, g, stats, dk,
    # dv, n_rowtiles, tile, rows, rows_g, d, scale, stream
    "dkv": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
            _P],
}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _tiles(a: torch.Tensor, n_rowtiles: int, t: int) -> torch.Tensor:
    """(rows, D) -> (n_rowtiles, T, D) float32 (bf16 values are exact in
    f32), rows past the end zero."""
    a = a.float()
    pad = n_rowtiles * t - a.shape[0]
    if pad:
        a = torch.cat([a, a.new_zeros((pad, a.shape[1]))])
    return a.reshape(n_rowtiles, t, a.shape[1])


def _gathered_tiles(rows_g: int, t: int) -> int:
    """The column tiles of a gathered array of ``rows_g`` rows."""
    return -(-rows_g // t)


def _row_stats(stats: torch.Tensor, n_rowtiles: int, t: int):
    """(rows, 3) -> M, den, δ each (n_rowtiles, T); rows past the end read
    (0, 1, 0), so their α is 0 / 1 and never 0 / 0."""
    pad = n_rowtiles * t - stats.shape[0]
    if pad:
        fill = stats.new_zeros((pad, 3))
        fill[:, 1] = 1.0
        stats = torch.cat([stats, fill])
    s = stats.reshape(n_rowtiles, t, 3)
    return s[..., 0], s[..., 1], s[..., 2]


def _chunks(nt: int):
    for lo in range(0, nt, _CHUNK):
        yield slice(lo, min(lo + _CHUNK, nt))


def _rounded(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A product's f32 weight as the TPU kernel casts it before the
    product: rounded to the features' dtype (a no-op for float32)."""
    return w.to(like.dtype).float()


def flash_tiles_fwd_reference(vals, tile_row, tile_col, q, k, v, n_rowtiles: int, scale: float):
    """K3's plain version, in two passes over the tile chunks: the row max,
    then the exp-weighted sums against it (the same partials as one online
    sweep; in bf16 the kernels round p against their running max, within
    one bf16 ulp of each term).  q has the own rows, k and v the gathered
    rows."""
    t, rows, d = vals.shape[1], q.shape[0], q.shape[1]
    n_g = _gathered_tiles(k.shape[0], t)
    qt = _tiles(q, n_rowtiles, t)
    kt, vt = _tiles(k, n_g, t), _tiles(v, n_g, t)
    trow, tcol = tile_row.long(), tile_col.long()
    m = qt.new_full((n_rowtiles * t,), float("-inf"))
    local = torch.arange(t, device=q.device)
    for c in _chunks(vals.shape[0]):
        s = torch.bmm(qt[trow[c]], kt[tcol[c]].transpose(1, 2)) * scale
        s = torch.where(vals[c] != 0, s, float("-inf"))
        m.scatter_reduce_(0, (trow[c][:, None] * t + local).reshape(-1), s.amax(2).reshape(-1),
                          "amax")
    m = m.reshape(n_rowtiles, t)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    den = qt.new_zeros((n_rowtiles, t))
    num = qt.new_zeros((n_rowtiles, t, d))
    for c in _chunks(vals.shape[0]):
        s = torch.bmm(qt[trow[c]], kt[tcol[c]].transpose(1, 2)) * scale
        p = torch.where(vals[c] != 0, torch.exp(s - m_safe[trow[c]][:, :, None]), 0.0)
        den.index_add_(0, trow[c], p.sum(2))
        num.index_add_(0, trow[c], torch.bmm(_rounded(p, v), vt[tcol[c]]))
    ml = torch.stack([m, den], -1).reshape(-1, 2)[:rows]
    return num.reshape(-1, d)[:rows], ml


def _alpha_ds(s, mask, m, den, delta, dav, scale):
    alpha = torch.where(mask, torch.exp(s - m) / den, 0.0)
    return alpha, alpha * (dav - delta) * scale


def flash_tiles_dq_reference(vals, tile_row, tile_col, q, k, v, g, stats, n_rowtiles: int,
                             scale: float):
    """K4's plain version: q, g and stats have the own rows, k and v the
    gathered rows."""
    t, rows, d = vals.shape[1], q.shape[0], q.shape[1]
    n_g = _gathered_tiles(k.shape[0], t)
    qt, gt = _tiles(q, n_rowtiles, t), _tiles(g, n_rowtiles, t)
    kt, vt = _tiles(k, n_g, t), _tiles(v, n_g, t)
    m, den, delta = _row_stats(stats, n_rowtiles, t)
    trow, tcol = tile_row.long(), tile_col.long()
    dq = qt.new_zeros((n_rowtiles, t, d))
    for c in _chunks(vals.shape[0]):
        r, kc = trow[c], kt[tcol[c]]
        s = torch.bmm(qt[r], kc.transpose(1, 2)) * scale
        dav = torch.bmm(gt[r], vt[tcol[c]].transpose(1, 2))
        _, ds = _alpha_ds(s, vals[c] != 0, m[r][:, :, None], den[r][:, :, None],
                          delta[r][:, :, None], dav, scale)
        dq.index_add_(0, r, torch.bmm(_rounded(ds, k), kc))
    return dq.reshape(-1, d)[:rows]


def flash_tiles_dkv_reference(vals_t, tile_row_t, tile_col_t, q, k, v, g, stats,
                              n_rowtiles: int, scale: float):
    """K5's plain version: source x destination orientation, stats per
    destination column.  k and v have the own (source) rows; q, g and
    stats the gathered (destination) rows."""
    t, rows, d = vals_t.shape[1], k.shape[0], k.shape[1]
    n_g = _gathered_tiles(q.shape[0], t)
    kt, vt = _tiles(k, n_rowtiles, t), _tiles(v, n_rowtiles, t)
    qt, gt = _tiles(q, n_g, t), _tiles(g, n_g, t)
    m, den, delta = _row_stats(stats, n_g, t)
    src, dst = tile_row_t.long(), tile_col_t.long()
    dk = kt.new_zeros((n_rowtiles, t, d))
    dv = kt.new_zeros((n_rowtiles, t, d))
    for c in _chunks(vals_t.shape[0]):
        sr, ds_ = src[c], dst[c]
        qc, gc = qt[ds_], gt[ds_]
        s = torch.bmm(kt[sr], qc.transpose(1, 2)) * scale
        dav = torch.bmm(vt[sr], gc.transpose(1, 2))
        alpha, ds = _alpha_ds(s, vals_t[c] != 0, m[ds_][:, None, :], den[ds_][:, None, :],
                              delta[ds_][:, None, :], dav, scale)
        dk.index_add_(0, sr, torch.bmm(_rounded(ds, q), qc))
        dv.index_add_(0, sr, torch.bmm(_rounded(alpha, g), gc))
    return dk.reshape(-1, d)[:rows], dv.reshape(-1, d)[:rows]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(vals, tile_row, tile_col, tile_rowptr, own, gathered, stats=None, stats_rows=0):
    """Validate a call; returns (rows, rows_g): the own arrays' rows and the
    gathered arrays' (``stats`` has ``stats_rows`` of them)."""
    dev = own[0].device
    named = ([("vals", vals), ("tile_row", tile_row), ("tile_col", tile_col),
              ("tile_rowptr", tile_rowptr)] + [(f"own[{i}]", a) for i, a in enumerate(own)]
             + [(f"gathered[{i}]", a) for i, a in enumerate(gathered)])
    if stats is not None:
        named.append(("stats", stats))
    for name, a in named:
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the own rows on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name.startswith("tile_") and a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
    if vals.dtype not in _VALS_KIND:
        raise TypeError(f"vals must be int8, float32 or bfloat16, got {vals.dtype}")
    if vals.dim() != 3 or vals.shape[1] != vals.shape[2]:
        raise ValueError(f"vals must be (nt, T, T), got {tuple(vals.shape)}")
    t = vals.shape[1]
    if t % 16:
        raise ValueError(f"the tile size must be a multiple of 16, got {t}")
    if tile_row.shape != (vals.shape[0],) or tile_col.shape != (vals.shape[0],):
        raise ValueError("tile_row and tile_col must have one entry per tile")
    dtype = own[0].dtype
    if dtype not in _FEATURES:
        raise TypeError(f"features must be float32 or bfloat16, got {dtype}")
    for group, what in ((own, "own"), (gathered, "gathered")):
        shape = group[0].shape
        for a in group:
            if a.dtype != dtype:
                raise TypeError(f"q, k, v (and g) must share one dtype, got {a.dtype} and {dtype}")
            if a.dim() != 2 or a.shape != shape or a.shape[1] != own[0].shape[1]:
                raise ValueError(f"the {what} feature arrays must be one (rows, D) shape with "
                                 f"the own arrays' D, got {tuple(a.shape)}")
    rows, rows_g = own[0].shape[0], gathered[0].shape[0]
    if stats is not None and (stats.dtype != torch.float32 or stats.shape != (stats_rows, 3)):
        raise ValueError(f"stats must be float32 ({stats_rows}, 3), got {stats.dtype} "
                         f"{tuple(stats.shape)}")
    if rows > (tile_rowptr.shape[0] - 1) * t:
        raise ValueError(f"{rows} own rows exceed the row tiles of tile_rowptr")
    if dev.type == "cpu" and vals.shape[0] and int(tile_col.max()) >= _gathered_tiles(rows_g, t):
        raise ValueError(f"tile column {int(tile_col.max())} starts at row "
                         f"{int(tile_col.max()) * t}, past the {rows_g} gathered rows")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the flash tile kernels run on cuda or cpu, not {dev}")
    return rows, rows_g


def _launch(kind: str, feats, ptrs, vals, tile_rowptr, rows: int, rows_g: int, scale: float):
    d = feats[0].shape[1]
    bf16 = feats[0].dtype == torch.bfloat16
    if d % (16 // feats[0].element_size()) == 0 and any(a.data_ptr() % 16 for a in feats):
        # the kernels stage rows with 16-byte loads when a row is a whole
        # number of them (d a multiple of 4 in f32, of 8 in bf16)
        raise ValueError("q, k, v (and g) must be 16-byte aligned")
    if vals.data_ptr() % 16:
        # K4 and K5 read a tile row's 8 values a lane in one load
        raise ValueError("vals must be 16-byte aligned")
    from plnlp_tpu_torch import _build

    lib = _build.load("flash_tiles")
    fn = getattr(lib, f"plnlp_flash_tiles_{kind}" + ("_bf16" if bf16 else ""))
    fn.argtypes = _ARGTYPES[kind]
    fn.restype = ctypes.c_int
    t = vals.shape[1]
    device = feats[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(vals.data_ptr(), _VALS_KIND[vals.dtype], *ptrs,
                 tile_rowptr.shape[0] - 1, t, rows, rows_g, d, float(scale), stream)
    _build.check(lib, err, f"flash_tiles_{kind} launch ({feats[0].dtype}, T={t}, D={d}, "
                           f"rows {rows}, gathered {rows_g})")
    (LAUNCHES_BF16 if bf16 else LAUNCHES)[kind] += 1


def flash_tiles_fwd(vals, tile_row, tile_col, tile_rowptr, q, k, v, scale: float):
    """K3: (num (rows, D), ml (rows, 2) = (m, den)), float32, over the
    row-sorted tiles, for q's own rows from the gathered k and v.  CUDA
    tensors launch the kernel of q's dtype (never the other one, never
    through a cast); CPU tensors take :func:`flash_tiles_fwd_reference`."""
    rows, rows_g = _check(vals, tile_row, tile_col, tile_rowptr, (q,), (k, v))
    n_r = tile_rowptr.shape[0] - 1
    if q.device.type == "cpu":
        return flash_tiles_fwd_reference(vals, tile_row, tile_col, q, k, v, n_r, scale)
    d = q.shape[1]
    num = torch.empty((rows, d), dtype=torch.float32, device=q.device)
    ml = torch.empty((rows, 2), dtype=torch.float32, device=q.device)
    if rows and d:
        _launch("fwd", (q, k, v),
                (tile_col.data_ptr(), tile_rowptr.data_ptr(), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), num.data_ptr(), ml.data_ptr()),
                vals, tile_rowptr, rows, rows_g, scale)
    return num, ml


def flash_tiles_dq(vals, tile_row, tile_col, tile_rowptr, q, k, v, g, stats, scale: float):
    """K4: dq (rows, D) float32 over the row-sorted tiles, for q's own rows
    (with g and the global row stats (M, den, δ) of those rows) from the
    gathered k and v.  CUDA tensors launch the kernel of q's dtype; CPU
    tensors take :func:`flash_tiles_dq_reference`."""
    rows, rows_g = _check(vals, tile_row, tile_col, tile_rowptr, (q, g), (k, v), stats,
                          q.shape[0])
    n_r = tile_rowptr.shape[0] - 1
    if q.device.type == "cpu":
        return flash_tiles_dq_reference(vals, tile_row, tile_col, q, k, v, g, stats, n_r, scale)
    d = q.shape[1]
    dq = torch.empty((rows, d), dtype=torch.float32, device=q.device)
    if rows and d:
        _launch("dq", (q, k, v, g),
                (tile_col.data_ptr(), tile_rowptr.data_ptr(), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), g.data_ptr(), stats.data_ptr(), dq.data_ptr()),
                vals, tile_rowptr, rows, rows_g, scale)
    return dq


def flash_tiles_dkv(vals_t, tile_row_t, tile_col_t, tile_rowptr_t, q, k, v, g, stats,
                    scale: float):
    """K5: (dk, dv), each (rows, D) float32, over the transposed
    (source-sorted) tile set, for k's and v's own rows from the gathered q,
    g and stats.  CUDA tensors launch the kernel of q's dtype; CPU tensors
    take :func:`flash_tiles_dkv_reference`."""
    rows, rows_g = _check(vals_t, tile_row_t, tile_col_t, tile_rowptr_t, (k, v), (q, g), stats,
                          q.shape[0])
    n_r = tile_rowptr_t.shape[0] - 1
    if k.device.type == "cpu":
        return flash_tiles_dkv_reference(vals_t, tile_row_t, tile_col_t, q, k, v, g, stats,
                                         n_r, scale)
    d = k.shape[1]
    dk = torch.empty((rows, d), dtype=torch.float32, device=k.device)
    dv = torch.empty((rows, d), dtype=torch.float32, device=k.device)
    if rows and d:
        _launch("dkv", (q, k, v, g),
                (tile_col_t.data_ptr(), tile_rowptr_t.data_ptr(), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), g.data_ptr(), stats.data_ptr(), dk.data_ptr(), dv.data_ptr()),
                vals_t, tile_rowptr_t, rows, rows_g, scale)
    return dk, dv
