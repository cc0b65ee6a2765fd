"""Training traffic: ``Model.train_epoch`` over the training positives.

Traffic parameters: ``call_positives`` ("all": each window call is a whole
epoch over every positive; a number: each call takes the next slice of that
many positives of one shuffled order, wrapping round), ``check_steps`` (the
optimiser steps set-up makes and the reference follows).

Set-up builds one model and optimizer, drives them through the check
steps (each one ``train_epoch`` call on its own batch of positives, rows
all different, its generator seeded from the run's seed), records what the
check compares, warms up one window call, and hands the same objects to
the window.  The unit is positive pairs trained (each with its
``num_neg`` negatives).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

from h100_bench import cellbase, flops, inputs, peaks, port


class Run(cellbase.Cell):
    def start_check(self) -> None:
        self.raw_train = None  # the raw edges: only ranking draws from them
        self.pos, self.pos_w = port.train_positives(self.prog["split_edge"], self.device)
        self.steps_total = 0
        self.check_program()

    def start_window(self) -> None:
        call = self.traffic["call_positives"]
        self.call_size = None if call == "all" else int(call)
        if self.call_size is not None:
            if self.call_size > self.pos.shape[0]:
                raise ValueError("call_positives exceeds the training positives")
            gen = inputs.generator(self.device, self.seed, 4)
            self.order = torch.randperm(self.pos.shape[0], generator=gen, device=self.device)
        self.call(-1)  # warm-up: the window's shapes

    def _check_batches(self, num_pos: int):
        """Row indices and generator seeds of the check steps."""
        b = self.args.batch_size
        steps = int(self.traffic["check_steps"])
        gen = inputs.generator(self.device, self.seed, 3)
        rows = torch.randperm(num_pos, generator=gen, device=self.device)[: steps * b]
        if rows.numel() < steps * b:
            raise ValueError("fewer positives than the check steps need")
        return [
            (rows[t * b:(t + 1) * b], inputs.stream_seed(self.seed, 10 + t)) for t in range(steps)
        ]

    def _train(self, pos, w, seed: int) -> float:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        g = self.prog
        loss = self.model.train_epoch(
            self.opt, g["graph"], g["graph_t"], self.node_feats, pos, w, gen, self.args.lr,
            sample_graph=g["graph"],
        )
        self.steps_total += max(1, math.ceil(pos.shape[0] / self.args.batch_size))
        return loss

    def check_program(self) -> None:
        """The check steps through the window's own call: each step's loss,
        each leaf's first gradient as Adam holds it, each leaf's change."""
        beta1 = self.opt.param_groups[0]["betas"][0]
        losses, grads = [], {}
        for t, (rows, seed) in enumerate(self._check_batches(self.pos.shape[0])):
            w = None if self.pos_w is None else self.pos_w[rows]
            losses.append(self._train(self.pos[rows], w, seed))
            if t == 0:
                grads = {
                    n: float((self.opt.state[p]["exp_avg"] / (1 - beta1)).norm())
                    for n, p in self.model.named_parameters() if p in self.opt.state
                }
        w0 = self.initial_weights()
        change = {n: float((p.detach() - w0[n]).norm()) for n, p in self.model.named_parameters()}
        self.out = {"loss": losses, "grad": grads, "change": change}

    def call(self, i: int) -> float:
        seed = inputs.stream_seed(self.seed, 1000 + i)
        if self.call_size is None:
            pos, w = self.pos, self.pos_w
        else:
            k = i % (self.pos.shape[0] // self.call_size)
            rows = self.order[k * self.call_size:(k + 1) * self.call_size]
            pos, w = self.pos[rows], (None if self.pos_w is None else self.pos_w[rows])
        self._train(pos, w, seed)
        return float(pos.shape[0])

    def window(self, seconds: float) -> Dict:
        s0 = self.steps_total
        out = super().window(seconds)
        out["steps"] = self.steps_total - s0
        return out

    def end_to_end(self) -> Dict:
        w = self.readings["window"]
        return {"train_pairs_per_s": w["work"] / w["seconds"]}

    def trace_work(self) -> None:
        l0, s0 = port.k1_launches(), self.steps_total
        self.call(10**6)
        self.readings["trace_counts"] = {
            "k1_launches": port.k1_launches() - l0, "steps": self.steps_total - s0,
        }

    def outputs(self):
        return self.out

    def reference(self):
        raw, adj, pos, weights = self.reference_inputs()
        batches = [(pos[rows], seed) for rows, seed in self._check_batches(pos.shape[0])]
        return self.ref.train_steps(self.model_cfg, weights, adj, raw["node_feat"], batches)

    def compare(self, outputs, reference) -> Dict:
        return compare(outputs, reference)

    def layer_readings(self) -> Dict:
        r = self.readings
        shape = self.shape
        r["window"]["flop"] = r["window"]["steps"] * flops.train_step_flop(
            shape, self.args.batch_size, self.args.num_neg
        )
        dims = flops.aggregation_dims(shape, backward=True)
        per_launch = statistics.fmean(
            peaks.bound_s(*flops.aggregation(shape["num_nodes"], shape["num_edges"], d))
            for d in dims
        )
        counts = r.get("trace_counts")
        if counts:
            r["k1"] = {"bound_s": counts["k1_launches"] * per_launch, "launches": counts["k1_launches"],
                       "launches_per_step": counts["k1_launches"] / max(counts["steps"], 1)}
        return r


def _leaf_gaps(prog: Dict, ref: Dict, names):
    """Each leaf's gap against its reference norm or the median leaf's,
    whichever is larger."""
    med = statistics.median(ref[k] for k in names)
    return [abs(prog.get(k, float("inf")) - ref[k]) / max(ref[k], med, 1e-30) for k in names]


def compare(prog: Dict, ref: Dict) -> Dict:
    """The check's numbers: the widest relative gap of a step's loss; the
    widest leaf's gap of the first gradient norm; the widest leaf's gap of
    the change after the last step.  Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone under
    Adam and are left out of the change."""
    if len(prog["loss"]) != len(ref["loss"]):
        return {k: float("inf") for k in ("loss_gap", "grad_gap", "change_gap")}
    loss = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
    med_g = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]
    return {
        "loss_gap": loss,
        "grad_gap": max(_leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"]))),
        "change_gap": max(_leaf_gaps(prog["change"], ref["change"], moved)),
    }
