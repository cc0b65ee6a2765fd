"""plnlp_tpu_torch losses against plnlp_tpu.losses (CPU): all ten names
through ``calculate_loss``, with and without a mask and a margin, values
and gradients.  Tolerance: float32 sums in another order, rtol = atol =
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plnlp_tpu.losses as jl
from plnlp_tpu_torch import losses as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def test_loss_names_match():
    assert tl.LOSS_NAMES == jl.LOSS_NAMES and len(tl.LOSS_NAMES) == 10


@pytest.mark.parametrize("name", jl.LOSS_NAMES)
@pytest.mark.parametrize("masked,with_margin", [(False, False), (True, True), (True, False)])
def test_calculate_loss_matches_jax(name, masked, with_margin):
    rng = np.random.default_rng(0)
    p, num_neg = 12, 3
    pos = rng.standard_normal((p, 1)).astype(np.float32)
    neg = rng.standard_normal((p * num_neg, 1)).astype(np.float32)
    margin = (rng.random(p) + 0.5).astype(np.float32) if with_margin else None
    mask = (rng.random(p) < 0.7).astype(np.float32) if masked else None

    def jax_loss(a, b):
        return jl.calculate_loss(
            name, a, b, num_neg,
            margin=None if margin is None else jnp.asarray(margin),
            mask=None if mask is None else jnp.asarray(mask),
        )

    want, (want_dp, want_dn) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(pos), jnp.asarray(neg)
    )
    tp = torch.from_numpy(pos).requires_grad_(True)
    tn = torch.from_numpy(neg).requires_grad_(True)
    got = tl.calculate_loss(
        name, tp, tn, num_neg,
        margin=None if margin is None else torch.from_numpy(margin),
        mask=None if mask is None else torch.from_numpy(mask),
    )
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_dp), **TOL)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(want_dn), **TOL)


def test_margin_losses_fall_back_to_auc_without_margin():
    pos, neg = torch.randn(5, 1), torch.randn(10, 1)
    auc = tl.calculate_loss("AUC", pos, neg, 2)
    for name in ("AdaAUC", "WeightedAUC", "AdaHingeAUC", "WeightedHingeAUC"):
        assert torch.equal(tl.calculate_loss(name, pos, neg, 2), auc)
        assert not torch.equal(tl.calculate_loss(name, pos, neg, 2, margin=torch.ones(5) * 3), auc)


def test_stable_info_nce_is_finite_where_info_nce_overflows():
    pos, neg = torch.full((4, 1), 200.0), torch.full((4, 2), 150.0)
    assert torch.isnan(tl.calculate_loss("InfoNCE", pos, neg, 2))
    stable = tl.calculate_loss("StableInfoNCE", pos, neg, 2)
    assert torch.isfinite(stable) and float(stable) < 1e-20
