"""Ranking traffic: ``Scorer.rank_candidates_batch`` requests over every
node from one caller in a closed loop, each sent when the last returns.

Traffic parameters: ``sources_min``, ``sources_max`` and ``size_levels``
(a request ranks S sources, S one of ``size_levels`` sizes spaced
log-uniformly from the least to the most; every seed sends the same sizes,
each cycle of ``size_levels`` requests a shuffle of them), ``k`` and
``exclude_edges`` (the top-k kept, known edges left out), ``keep_share``
(the share of requests whose answers are kept for the check, drawn from
the seed; the first request of the largest size is always kept),
``check_requests`` (how many kept answers the reference judges) and
``trace_requests``.  Sources are endpoints of training edges drawn
uniformly, so a node is asked for in proportion to its degree.

Set-up encodes once, as a restore does, and warms up each size once.  A
request's latency runs on the host clock from the call to when it returns
the (S, k) answers on the host.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import numpy as np
import torch

from h100_bench import cellbase, flops, inputs, port

_POOL = 1 << 22  # sources drawn in set-up; requests take them in turn


class Run(cellbase.Cell):
    def start_check(self) -> None:
        g = self.prog
        self.scorer = port.scorer(self.model, g["graph"], g["graph_t"], self.node_feats)
        t = self.traffic
        levels = int(t["size_levels"])
        lo, hi = float(t["sources_min"]), float(t["sources_max"])
        self.sizes = [int(round(lo * (hi / lo) ** (i / (levels - 1)))) for i in range(levels)]
        gen = inputs.generator(self.device, self.seed, 5)
        cycles = 4096
        self.order = torch.argsort(
            torch.rand((cycles, levels), generator=gen, device=self.device), dim=1
        ).reshape(-1).cpu().numpy()
        tr = self.raw_train
        edges = tr["edge"] if "edge" in tr else torch.stack([tr["source_node"], tr["target_node"]], 1)
        pick = torch.randint(0, edges.shape[0], (_POOL,), generator=gen, device=self.device)
        side = torch.randint(0, 2, (_POOL,), generator=gen, device=self.device)
        self.pool = edges[pick, side].cpu().numpy()
        self.keep = (torch.rand(self.order.size, generator=gen, device=self.device)
                     < float(t["keep_share"])).cpu().numpy()
        self.cursor = 0
        self.latencies, self.kept = [], {}
        self.sources_done = 0
        self.max_first = None

    def start_window(self) -> None:
        t = self.traffic
        for s in self.sizes:  # warm-up: each size once
            self.scorer.rank_candidates_batch(self.pool[:s], k=int(t["k"]),
                                              exclude_edges=bool(t["exclude_edges"]))

    def request(self, i: int):
        s = self.sizes[self.order[i % self.order.size]]
        if self.cursor + s > _POOL:
            self.cursor = 0
        srcs = self.pool[self.cursor:self.cursor + s]
        self.cursor += s
        return srcs

    def call(self, i: int) -> float:
        srcs = self.request(i)
        t0 = time.perf_counter()
        ids, scores = self.scorer.rank_candidates_batch(
            srcs, k=int(self.traffic["k"]), exclude_edges=bool(self.traffic["exclude_edges"])
        )
        self.latencies.append(1e3 * (time.perf_counter() - t0))
        self.sources_done += srcs.size
        first_max = srcs.size == self.sizes[-1] and self.max_first is None
        if first_max:
            self.max_first = i
        if first_max or self.keep[i % self.keep.size]:
            self.kept[i] = (srcs.copy(), ids, scores)
        return 1.0

    def window(self, seconds: float) -> Dict:
        out = super().window(seconds)
        out["latencies_ms"] = np.asarray(self.latencies)
        out["sources"] = self.sources_done
        return out

    def end_to_end(self) -> Dict:
        lat = self.readings["window"]["latencies_ms"]
        return {"rank_p95_ms": statistics.quantiles(lat, n=20)[-1]}

    def control_work(self, seconds: float) -> None:
        self.window(seconds)

    def trace_work(self) -> None:
        for j in range(int(self.traffic["trace_requests"])):
            srcs = self.request(10**6 + j)
            self.scorer.rank_candidates_batch(
                srcs, k=int(self.traffic["k"]), exclude_edges=bool(self.traffic["exclude_edges"])
            )

    def outputs(self):
        """The kept answers the reference judges, drawn from the seed, the
        first answer of the largest size among them."""
        kept = sorted(self.kept)
        gen = np.random.default_rng(inputs.stream_seed(self.seed, 6))
        n = int(self.traffic["check_requests"])
        rest = [i for i in kept if i != self.max_first]
        pick = list(gen.choice(rest, size=min(n - 1, len(rest)), replace=False)) if rest else []
        if self.max_first is not None:
            pick.append(self.max_first)
        answers = [self.kept[i] for i in sorted(pick)]
        self.kept = {}
        return answers

    def reference(self):
        raw, adj, pos, weights = self.reference_inputs()
        return self.ref.embed(self.model_cfg, weights, adj, raw["node_feat"]), adj

    def compare(self, outputs, reference) -> Dict:
        h, adj = reference
        worst = {"bad_ids": 0, "score_gap": 0.0, "rank_gap": 0.0}
        if not outputs:
            worst = {k: float("inf") for k in worst}
        for srcs, ids, scores in outputs:
            got = self.ref.rank_gaps(
                h, adj, torch.as_tensor(srcs, device=self.device),
                torch.as_tensor(ids, device=self.device),
                torch.as_tensor(scores, device=self.device), int(self.traffic["k"]),
            )
            worst = {k: max(worst[k], got[k]) for k in worst}
        self.readings["checked_requests"] = len(outputs)
        return worst

    def layer_readings(self) -> Dict:
        r = self.readings
        r["window"]["flop"] = flops.rank_flop(
            r["window"]["sources"], self.shape["num_nodes"], self.shape["hidden"]
        )
        return r
