"""plnlp_tpu_torch losses against plnlp_tpu.losses (CPU), the last five
names (AdaHingeAUC, LogRank, CE, InfoNCE, StableInfoNCE), as
tests/test_torch_losses.py holds the first five; ``MEAN_LOSSES`` names
exactly the losses that are means over the batch, which a rank's share of
the loss under a mesh is rescaled for (``Model.train_step``).  Tolerance:
float32 sums in another order, rtol = atol = 1e-5."""

import pytest
import torch

import plnlp_tpu.losses as jl
from plnlp_tpu_torch import losses as tl
from tests.test_torch_losses import MASKS, check_calculate_loss
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)


@pytest.mark.parametrize("name", jl.LOSS_NAMES[5:])
@pytest.mark.parametrize("masked,with_margin", MASKS)
def test_calculate_loss_matches_jax(name, masked, with_margin):
    check_calculate_loss(name, masked, with_margin)


def test_mean_losses_are_the_losses_that_average():
    """A loss is in MEAN_LOSSES iff repeating the batch leaves it as it is
    (a sum doubles)."""
    g = torch.Generator().manual_seed(0)
    pos, neg = torch.randn(6, 1, generator=g), torch.randn(12, 1, generator=g)
    margin = torch.rand(6, generator=g) + 0.5
    assert tl.MEAN_LOSSES <= set(tl.LOSS_NAMES)
    for name in tl.LOSS_NAMES:
        one = tl.calculate_loss(name, pos, neg, 2, margin=margin)
        two = tl.calculate_loss(name, pos.repeat(2, 1), neg.repeat(2, 1), 2,
                                margin=margin.repeat(2))
        want = one if name in tl.MEAN_LOSSES else 2 * one
        torch.testing.assert_close(two, want, rtol=1e-5, atol=1e-6, msg=name)


def test_stable_info_nce_is_finite_where_info_nce_overflows():
    pos, neg = torch.full((4, 1), 200.0), torch.full((4, 2), 150.0)
    assert torch.isnan(tl.calculate_loss("InfoNCE", pos, neg, 2))
    stable = tl.calculate_loss("StableInfoNCE", pos, neg, 2)
    assert torch.isfinite(stable) and float(stable) < 1e-20
