"""The plain versions of K3, K4 and K5 in bfloat16 (``ops/flash_tiles.py``,
which the bf16 CUDA entry points are held to on the card) against the
Pallas kernels of ``plnlp_tpu/ops/pallas_attention.py`` called directly in
interpret mode with bf16 q, k, v and g (CPU).

Int8, bf16 and f32 tile stores (a mask only).  Row tiles that no tile
reaches are left out (the TPU kernels leave them undefined).  The scores
and g·v are f32 sums of bf16 products on both sides; each weight is
rounded to bf16 before its second product (K3 ``bf16(p) v``, K4
``bf16(ds) k``, K5 ``bf16(ds) q`` and ``bf16(α) g``).  The TPU kernel
rounds K3's p against its running max over the row tile's tiles, the plain
version against the row's final max, so a term may land one bf16 ulp
apart: the outputs are held to the f32 sums' tolerance plus 2**-7 of the
sum of the terms' magnitudes, ``1e-5 + (1e-6 + 2**-7) Σ|terms|``; K3's m
and den (f32 sums of f32 terms) at rtol 1e-5, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.ops.pallas_attention as jpa
from chip_smoke import BF16_RTOL, SUM_ATOL, SUM_RTOL, flash_bwd_magnitudes
from plnlp_tpu_torch.ops import flash_tiles as ft
from tests.test_torch_attention import KERNEL_TOL, NR, SCALE, T, D, _covered, _ptr, _t, _tile_case
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

BF = torch.bfloat16
STORES = ["int8", "bfloat16", "float32"]


def _case(store):
    c = _tile_case(np.int8 if store == "int8" else np.float32)
    feats = {x: torch.from_numpy(c[x]).to(BF) for x in "qkvg"}
    vals, vals_t = _t(c["vals"]), _t(c["vals_t"])
    if store == "bfloat16":
        vals, vals_t = vals.to(BF), vals_t.to(BF)
    jv = {x: jnp.asarray(feats[x].float().numpy()).astype(jnp.bfloat16).reshape(NR, T, D)
          for x in "qkvg"}
    jvals, jvals_t = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) if store == "bfloat16"
                      else jnp.asarray(a.numpy()) for a in (vals, vals_t))
    return c, feats, vals, vals_t, jv, jvals, jvals_t


def _within(got, want, mags, rows):
    tol = SUM_ATOL + (SUM_RTOL + BF16_RTOL) * mags[rows]
    err = np.abs(got[rows] - np.asarray(want)[rows])
    assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.parametrize("store", STORES)
def test_flash_fwd_bf16_plain_matches_pallas_interpret(store):
    c, f, vals, _, jv, jvals, _ = _case(store)
    num_j, stats_j = jpa.flash_tiles_fwd(jvals, jnp.asarray(c["trow"]), jnp.asarray(c["tcol"]),
                                         jv["q"], jv["k"], jv["v"], NR, float(SCALE),
                                         interpret=True)
    args = (vals, _t(c["trow"]), _t(c["tcol"]), _ptr(c["trow"]))
    before = (dict(ft.LAUNCHES), dict(ft.LAUNCHES_BF16))
    num, ml = ft.flash_tiles_fwd(*args, f["q"], f["k"], f["v"], SCALE)
    assert (ft.LAUNCHES, ft.LAUNCHES_BF16) == before  # the CPU path is no launch
    assert num.dtype == ml.dtype == torch.float32
    mags, _ = ft.flash_tiles_fwd(*args, f["q"], f["k"], f["v"].abs(), SCALE)
    cov = _covered(c["trow"])
    stats_j = np.asarray(stats_j)
    _within(num.numpy(), num_j, mags.numpy(), cov)
    np.testing.assert_allclose(ml[cov, 1].numpy(), stats_j[cov, 0], **KERNEL_TOL)  # den
    np.testing.assert_allclose(ml[cov, 0].numpy(), stats_j[cov, 1], **KERNEL_TOL)  # m
    assert np.isneginf(ml[cov, 0].numpy()).any()  # rows of covered tiles with no edge


@pytest.mark.parametrize("store", STORES)
def test_flash_dq_dkv_bf16_plain_match_pallas_interpret(store):
    c, f, vals, vals_t, jv, jvals, jvals_t = _case(store)
    stat = jnp.asarray(c["stats"])
    dq_j = jpa.flash_tiles_dq(jvals, jnp.asarray(c["trow"]), jnp.asarray(c["tcol"]), jv["q"],
                              jv["k"], jv["v"], jv["g"], jpa.pack_mdd(stat), NR, float(SCALE),
                              interpret=True)
    dk_j, dv_j = jpa.flash_tiles_dkv(jvals_t, jnp.asarray(c["trow_t"]), jnp.asarray(c["tcol_t"]),
                                     jv["q"], jv["k"], jv["v"], jv["g"],
                                     jpa.pack_mdd_t(stat, T), NR, float(SCALE), interpret=True)
    feats = [f[x] for x in "qkvg"]
    stats = _t(c["stats"])
    fwd = (vals, _t(c["trow"]), _t(c["tcol"]))
    bwd = (vals_t, _t(c["trow_t"]), _t(c["tcol_t"]))
    dq = ft.flash_tiles_dq(*fwd, _ptr(c["trow"]), *feats, stats, SCALE)
    dk, dv = ft.flash_tiles_dkv(*bwd, _ptr(c["trow_t"]), *feats, stats, SCALE)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    (mq,) = flash_bwd_magnitudes(*fwd, *feats, stats, SCALE, False)
    mk, mv = flash_bwd_magnitudes(*bwd, *feats, stats, SCALE, True)
    cov, cov_t = _covered(c["trow"]), _covered(c["trow_t"])
    _within(dq.numpy(), dq_j, mq.numpy(), cov)
    _within(dk.numpy(), dk_j, mk.numpy(), cov_t)
    _within(dv.numpy(), dv_j, mv.numpy(), cov_t)
    # the bf16 roundings are there: the f32 plain versions on the same
    # (bf16-valued) features give other sums
    f32 = [a.float() for a in feats]
    assert not torch.equal(dq, ft.flash_tiles_dq(*fwd, _ptr(c["trow"]), *f32, stats, SCALE))
    with pytest.raises(TypeError, match="share one dtype"):
        ft.flash_tiles_dq(*fwd, _ptr(c["trow"]), feats[0], *f32[1:], stats, SCALE)
