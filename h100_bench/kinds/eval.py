"""Evaluation traffic: ``Model.test`` again and again, each call the
encode and the predictor over every valid and test pair, ranked into the
configuration's metric (``eval_metric``: MRR for citation2's layout).

Traffic parameters: ``sample_negatives``, the negatives of each split
whose scores are kept for the check (every positive's are).  Set-up puts
the evaluation pairs on the device as ``cli.prepare_experiment`` does and
warms up one call.  The unit is evaluation pairs scored (positives and
negatives of valid and test).

The check compares every call's MRR with the reference's, which catches
a fault between ``Model.batch_predict`` and the metric (the ranking, the
MRR), and the scores of a sample of its pairs, drawn from the seed, read
where ``Model.test`` gets them from ``Model.batch_predict``, which catch a
lower precision: MRR moves by a few rank flips, which rounding makes too.
The sample is a copy on the device, made without a sync.
"""

from __future__ import annotations

from typing import Dict

import torch

from h100_bench import cellbase, flops, inputs, port


class Run(cellbase.Cell):
    def start_check(self) -> None:
        self.raw_train = None  # the raw edges: only ranking draws from them
        self.eval_pairs = port.eval_edges(self.prog["split_edge"], self.device)
        self.pairs_per_call = sum(
            int(part[k].shape[0]) for part in self.eval_pairs.values() for k in ("pos", "neg")
        )
        self.answers, self.kept = [], []
        gen = inputs.generator(self.device, self.seed, 7)
        n = int(self.traffic["sample_negatives"])
        self.sample = {}
        for split in ("valid", "test"):
            for kind in ("pos", "neg"):
                size = self.eval_pairs[split][kind].shape[0]
                idx = (torch.arange(size, device=self.device) if kind == "pos" else
                       torch.randint(0, size, (n,), generator=gen, device=self.device))
                self.sample[id(self.eval_pairs[split][kind])] = (split, kind, idx)
        served = self.model.batch_predict

        def predict(h, edges, mesh=None):
            out = served(h, edges, mesh=mesh)
            if id(edges) in self.sample:
                split, kind, idx = self.sample[id(edges)]
                self.kept.append((split, kind, out[idx].clone()))
            return out

        self.model.batch_predict = predict

    def start_window(self) -> None:
        self._test()  # warm-up

    def _test(self):
        g = self.prog
        return self.model.test(
            g["graph"], g["graph_t"], self.node_feats, self.eval_pairs, self.model_cfg["eval_metric"]
        )

    def call(self, i: int) -> float:
        self.kept = []
        self.answers.append((self._test(), self.kept))
        return float(self.pairs_per_call)

    def end_to_end(self) -> Dict:
        w = self.readings["window"]
        return {"eval_pairs_per_s": w["work"] / w["seconds"]}

    def control_work(self, seconds: float) -> None:
        self.call(0)

    def trace_work(self) -> None:
        self.kept = []  # the traced call's scores are not judged
        self._test()

    def outputs(self):
        answers, self.answers = self.answers, []
        sample = {(split, kind): idx for split, kind, idx in self.sample.values()}
        return answers, sample

    def reference(self):
        raw, adj, pos, weights = self.reference_inputs()
        if self.model_cfg["eval_metric"] != "mrr":
            raise ValueError("the eval check compares MRR")
        h = self.ref.embed(self.model_cfg, weights, adj, raw["node_feat"])
        splits = {s: raw["split_edge"][s] for s in ("valid", "test")}
        mrr = [self.ref.mrr(self.model_cfg, weights, h, splits[s]) for s in ("valid", "test")]
        self.readings["reference_mrr"] = mrr
        return mrr, (lambda split, kind, idx: self.ref.pair_scores(
            self.model_cfg, weights, h, splits[split], kind, idx))

    def compare(self, outputs, reference) -> Dict:
        answers, sample = outputs
        mrr, scores_of = reference
        want = {key: scores_of(*key, idx) for key, idx in sample.items()}
        mrr_gap = score_gap = float("inf") if not answers else 0.0
        for got, kept in answers:
            mrr_gap = max(mrr_gap, *(abs(got["MRR"][j] - mrr[j]) for j in range(2)))
            if len(kept) != len(want):
                score_gap = float("inf")
            for split, kind, scores in kept:
                w = want[(split, kind)]
                gap = (scores.float() - w).abs().max() / w.abs().max().clamp(min=1e-30)
                score_gap = max(score_gap, float(gap))
        return {"score_gap": score_gap, "mrr_gap": mrr_gap}

    def layer_readings(self) -> Dict:
        r = self.readings
        r["window"]["flop"] = r["window"]["calls"] * flops.eval_flop(self.shape, self.pairs_per_call)
        return r
