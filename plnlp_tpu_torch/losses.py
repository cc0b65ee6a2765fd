"""The pairwise ranking losses (port of plnlp_tpu/losses.py).

Shape contract: ``pos_out`` flattens to (P, 1), ``neg_out`` to
(P, num_neg); every loss compares a positive with its own negatives.
AUC-family losses are SUMS over the (P, num_neg) matrix; LogRank, CE and
InfoNCE are MEANS.  Each loss takes an optional (P,) ``mask``: masked
entries drop out of sums and mean denominators (the static last batch of
``Model.train_epoch``).  With ``mask=None`` the formula is the reference's.
"""

from __future__ import annotations

import torch

__all__ = [
    "auc_loss",
    "hinge_auc_loss",
    "weighted_auc_loss",
    "adaptive_auc_loss",
    "weighted_hinge_auc_loss",
    "adaptive_hinge_auc_loss",
    "log_rank_loss",
    "ce_loss",
    "info_nce_loss",
    "calculate_loss",
    "LOSS_NAMES",
    "MEAN_LOSSES",
]

_EPS = 1e-15


def _pair(pos_out, neg_out, num_neg):
    pos = pos_out.reshape(-1, 1)
    return pos, neg_out.reshape(pos.shape[0], num_neg)


def _masked_sum(x, mask):
    if mask is None:
        return x.sum()
    return (x * mask.reshape(-1, 1)).sum()


def _masked_mean(x, mask):
    if mask is None:
        return x.mean()
    m = mask.reshape(-1, 1)
    return (x * m).sum() / torch.clamp(m.sum() * x.shape[1], min=1.0)


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def auc_loss(pos_out, neg_out, num_neg, mask=None):
    """Σ (1 − (pos − neg))²."""
    pos, neg = _pair(pos_out, neg_out, num_neg)
    return _masked_sum(torch.square(1 - (pos - neg)), mask)


def hinge_auc_loss(pos_out, neg_out, num_neg, mask=None):
    """Σ clamp(1 − (pos − neg), 0)²."""
    pos, neg = _pair(pos_out, neg_out, num_neg)
    return _masked_sum(torch.square(torch.clamp(1 - (pos - neg), min=0)), mask)


def weighted_auc_loss(pos_out, neg_out, num_neg, weight, mask=None):
    """Σ w·(1 − (pos − neg))²."""
    pos, neg = _pair(pos_out, neg_out, num_neg)
    w = weight.reshape(-1, 1)
    return _masked_sum(w * torch.square(1 - (pos - neg)), mask)


def adaptive_auc_loss(pos_out, neg_out, num_neg, margin, mask=None):
    """Σ (m − (pos − neg))²."""
    pos, neg = _pair(pos_out, neg_out, num_neg)
    m = margin.reshape(-1, 1)
    return _masked_sum(torch.square(m - (pos - neg)), mask)


def weighted_hinge_auc_loss(pos_out, neg_out, num_neg, weight, mask=None):
    """Σ w·clamp(w − (pos − neg), 0)²: the weight doubles as the margin."""
    pos, neg = _pair(pos_out, neg_out, num_neg)
    w = weight.reshape(-1, 1)
    return _masked_sum(w * torch.square(torch.clamp(w - (pos - neg), min=0)), mask)


def adaptive_hinge_auc_loss(pos_out, neg_out, num_neg, weight, mask=None):
    """Σ clamp(w − (pos − neg), 0)²."""
    pos, neg = _pair(pos_out, neg_out, num_neg)
    w = weight.reshape(-1, 1)
    return _masked_sum(torch.square(torch.clamp(w - (pos - neg), min=0)), mask)


def log_rank_loss(pos_out, neg_out, num_neg, mask=None):
    """−mean log σ(pos − neg) (BPR)."""
    pos, neg = _pair(pos_out, neg_out, num_neg)
    return -_masked_mean(torch.log(_sigmoid(pos - neg) + _EPS), mask)


def ce_loss(pos_out, neg_out, mask=None, neg_mask=None):
    """Binary CE on pos and neg scores, each averaged on its own (no
    pairing).  ``neg_mask`` masks the flattened neg batch; by default it is
    ``mask`` repeated over each positive's negatives."""
    pl = -torch.log(_sigmoid(pos_out.reshape(-1)) + _EPS)
    nl = -torch.log(1 - _sigmoid(neg_out.reshape(-1)) + _EPS)
    if mask is None:
        pos_loss = pl.mean()
    else:
        m = mask.reshape(-1)
        pos_loss = (pl * m).sum() / torch.clamp(m.sum(), min=1.0)
    if neg_mask is None and mask is None:
        neg_loss = nl.mean()
    else:
        if neg_mask is None:
            neg_mask = torch.repeat_interleave(mask.reshape(-1), nl.shape[0] // mask.shape[0])
        nm = neg_mask.reshape(-1)
        neg_loss = (nl * nm).sum() / torch.clamp(nm.sum(), min=1.0)
    return pos_loss + neg_loss


def info_nce_loss(pos_out, neg_out, num_neg, mask=None, stable=False):
    """−mean log(eᵖ/(eᵖ + Σeⁿ)).  ``stable=False`` keeps the reference's
    unstabilized ``exp`` (nan once a score passes ~88 in f32);
    ``stable=True`` (``StableInfoNCE``) computes the same quantity as
    logsumexp([0, neg − pos])."""
    pos, neg = _pair(pos_out, neg_out, num_neg)
    if stable:
        z = torch.cat([torch.zeros_like(pos), neg - pos], dim=1)
        zmax = z.max(dim=1, keepdim=True).values
        x = zmax + torch.log(torch.exp(z - zmax).sum(dim=1, keepdim=True))
    else:
        pos_exp = torch.exp(pos)
        neg_exp = torch.exp(neg).sum(dim=1, keepdim=True)
        x = -torch.log(pos_exp / (pos_exp + neg_exp) + _EPS)
    if mask is None:
        return x.mean()
    m = mask.reshape(-1, 1)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


LOSS_NAMES = (
    "AUC",
    "HingeAUC",
    "WeightedAUC",
    "AdaAUC",
    "WeightedHingeAUC",
    "AdaHingeAUC",
    "LogRank",
    "CE",
    "InfoNCE",
    "StableInfoNCE",
)

# The losses that are means over the batch; the rest are sums.  Under a
# mesh a rank's share of a mean loss is rescaled to the global count of
# valid pairs (``Model.train_step``), so a new mean loss belongs here.
MEAN_LOSSES = frozenset({"LogRank", "CE", "InfoNCE", "StableInfoNCE"})

_MARGIN_LOSSES = {
    "AdaAUC": adaptive_auc_loss,
    "WeightedAUC": weighted_auc_loss,
    "AdaHingeAUC": adaptive_hinge_auc_loss,
    "WeightedHingeAUC": weighted_hinge_auc_loss,
}


def calculate_loss(loss_name: str, pos_out, neg_out, num_neg: int, margin=None, mask=None):
    """Name → loss, as plnlp_tpu's ``calculate_loss``: the margin-taking
    losses fall back to plain AUC when ``margin is None``, and so does an
    unknown name."""
    if loss_name == "CE":
        return ce_loss(pos_out, neg_out, mask=mask)
    if loss_name == "InfoNCE":
        return info_nce_loss(pos_out, neg_out, num_neg, mask=mask)
    if loss_name == "StableInfoNCE":
        return info_nce_loss(pos_out, neg_out, num_neg, mask=mask, stable=True)
    if loss_name == "LogRank":
        return log_rank_loss(pos_out, neg_out, num_neg, mask=mask)
    if loss_name == "HingeAUC":
        return hinge_auc_loss(pos_out, neg_out, num_neg, mask=mask)
    if loss_name in _MARGIN_LOSSES and margin is not None:
        return _MARGIN_LOSSES[loss_name](pos_out, neg_out, num_neg, margin, mask=mask)
    return auc_loss(pos_out, neg_out, num_neg, mask=mask)
