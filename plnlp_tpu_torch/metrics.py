"""OGB 1.3.2 link-prediction metrics (port of plnlp_tpu/metrics.py).

* Hits@K — fraction of positives scoring strictly above the K-th best
  shared negative; 1.0 when there are fewer than K negatives.
* MRR — each positive ranked among its own row of negatives, ties credited
  with the mean of the optimistic and pessimistic rank.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["hits_at_k", "mrr", "evaluate_hits", "evaluate_mrr"]


def _hits_many(pos, neg, ks) -> Dict[int, float]:
    pos = torch.as_tensor(pos).reshape(-1).float()
    neg = torch.as_tensor(neg).reshape(-1).float()
    live = [k for k in ks if k <= neg.numel()]
    out = {k: 1.0 for k in ks}
    if live:
        top = torch.topk(neg, max(live)).values
        vals = torch.stack([(pos > top[k - 1]).float().mean() for k in live])
        out.update(zip(live, vals.tolist()))
    return out


def hits_at_k(pos_pred, neg_pred, k: int) -> float:
    """Hits@k: 1.0 when there are fewer than k negatives."""
    return _hits_many(pos_pred, neg_pred, (k,))[k]


def mrr(pos_pred, neg_pred) -> float:
    """neg_pred: (P, num_neg_per_pos)."""
    pos = torch.as_tensor(pos_pred).reshape(-1, 1).float()
    neg = torch.as_tensor(neg_pred).reshape(pos.shape[0], -1).float()
    opt = (neg > pos).float().sum(1)
    pess = (neg >= pos).float().sum(1)
    return float((1.0 / (0.5 * (opt + pess) + 1.0)).mean())


def evaluate_hits(
    pos_val_pred, neg_val_pred, pos_test_pred, neg_test_pred, ks=(20, 50, 100)
) -> Dict[str, Tuple[float, float]]:
    """{'Hits@K': (valid, test)} for every K."""
    val = _hits_many(pos_val_pred, neg_val_pred, ks)
    test = _hits_many(pos_test_pred, neg_test_pred, ks)
    return {f"Hits@{k}": (val[k], test[k]) for k in ks}


def evaluate_mrr(
    pos_val_pred, neg_val_pred, pos_test_pred, neg_test_pred
) -> Dict[str, Tuple[float, float]]:
    """{'MRR': (valid, test)}; negatives reshaped to (num_pos, -1)."""
    return {
        "MRR": (mrr(pos_val_pred, neg_val_pred), mrr(pos_test_pred, neg_test_pred))
    }
