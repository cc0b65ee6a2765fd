"""Whole runs past the look for a card (``run.execute`` on the CPU, at a
tiny size) with the timed path broken underneath: ``correct`` comes out
false for each fault a cell can have (one chip: no exchange to leave out)."""

import pytest
import torch

from h100_bench import run as bench
from h100_bench.tests import small
from plnlp_tpu_torch import training
from plnlp_tpu_torch.serve import Scorer
from plnlp_tpu_torch.training import Model


def _unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)


def _half_batch(mp):
    whole = Model.loss

    def loss(self, graph, graph_t, node_feats, pos, neg, margin, mask, gen=None):
        h = pos.shape[0] // 2
        cut = (lambda t: None if t is None else t[:h])
        return 2 * whole(self, graph, graph_t, node_feats, pos[:h], neg[:h], cut(margin),
                         cut(mask), gen)

    mp.setattr(Model, "loss", loss)


def _ranking_answer_altered(mp):
    served = Scorer.rank_candidates_batch

    def rank(self, *a, **k):
        ids, scores = served(self, *a, **k)
        ids[:, 0] = (ids[:, 0] + 1) % self.model.num_nodes
        return ids, scores

    mp.setattr(Scorer, "rank_candidates_batch", rank)


def _scores_altered(mp):
    scored = Model.batch_predict

    def predict(self, h, edges, mesh=None):
        out = scored(self, h, edges, mesh=mesh)
        cut = min(out.numel(), 1 << 16)
        out[:cut] = -out[:cut]
        return out

    mp.setattr(Model, "batch_predict", predict)


def _mrr_input_altered(mp):
    whole = training.evaluate_mrr

    def evaluate(pos_valid, neg_valid, pos_test, neg_test):
        return whole(-pos_valid, neg_valid, -pos_test, neg_test)

    mp.setattr(training, "evaluate_mrr", evaluate)


CASES = [
    ("collab-sage-dot.train", None),
    ("collab-sage-dot.train", _unchanged),
    ("collab-sage-dot.train", _half_batch),
    ("citation2-gcn.train", _unchanged),
    ("citation2-gcn.train", _half_batch),
    ("collab-sage-dot.rank", None),
    ("collab-sage-dot.rank", _ranking_answer_altered),
    ("citation2-gcn.eval", None),
    ("citation2-gcn.eval", _scores_altered),
    ("citation2-gcn.eval", _mrr_input_altered),
]


@pytest.mark.parametrize(
    "name,fault", CASES, ids=[f"{n}-{f.__name__ if f else 'sound'}" for n, f in CASES]
)
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    if fault is not None:
        fault(monkeypatch)
    spec = small.spec(name, small.SCALES[name])
    result, _, checks = bench.execute(spec, 2**31 + 31, 0.3, False, torch.device("cpu"))
    assert result["correct"] is (fault is None), checks
    if fault is _mrr_input_altered:  # past the scores: only the MRR sees it
        failed = {c["name"] for c in checks if c["value"] > c["limit"]}
        assert failed == {"mrr_gap"}, checks
    assert result["attempted"] >= 1 and result["metrics"]
