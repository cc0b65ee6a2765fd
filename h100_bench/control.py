"""The readings the check's limits are set from, on the card at a cell's own
size: the program on many seeds, the lower precision that must fail, and
the faults a cell can have.  The benchmark's runs never run this.

    python3 -m h100_bench.control --workload <name> --seeds 1,2,3 \
        --variants program,bf16,half_batch [--seconds 3] [--out file.jsonl]

Per seed the inputs and the port's preparation are made once; each variant
builds its own model from the same weights, runs what the check compares
(training: the check steps; ranking: a short window at the cell's load;
evaluation: one call), and the plain reference runs once, after all of
them, to judge each.  Variants: ``program`` (the port as configured),
``bf16`` (the port's ``--compute_dtype bfloat16``: the control), and the
faults ``half_batch`` (each step's loss over half of its batch, scaled to
the whole), ``unchanged`` (the optimizer's step does nothing),
``answer_altered`` (ranking: one returned id of each answer replaced),
``scores_altered`` (evaluation: the first chunk's scores of each
``batch_predict`` call negated).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from h100_bench import manifest, port

FLAGS = {"bf16": ("--compute_dtype", "bfloat16")}


def _half_batch(run) -> None:
    whole = run.model.loss

    def loss(graph, graph_t, node_feats, pos, neg, margin, mask, gen=None):
        h = pos.shape[0] // 2
        cut = (lambda t: None if t is None else t[:h])
        return 2 * whole(graph, graph_t, node_feats, pos[:h], neg[:h], cut(margin), cut(mask), gen)

    run.model.loss = loss


def _unchanged(run) -> None:
    run.opt.step = lambda *a, **k: None


def _negate_first_chunk(scores):
    cut = min(scores.numel(), 1 << 16)
    scores[:cut] = -scores[:cut]
    return scores


def _answer_altered(run):
    if getattr(run, "scorer", None) is None:
        return _mrr_input_altered()
    served = run.scorer.rank_candidates_batch

    def rank(*a, **k):
        ids, scores = served(*a, **k)
        ids[0, 0] = (ids[0, 0] + 1) % run.num_nodes
        return ids, scores

    run.scorer.rank_candidates_batch = rank


def _mrr_input_altered():
    from plnlp_tpu_torch import training

    whole = training.evaluate_mrr

    def evaluate(pos_valid, neg_valid, pos_test, neg_test):
        return whole(_negate_first_chunk(pos_valid.clone()), neg_valid,
                     _negate_first_chunk(pos_test.clone()), neg_test)

    training.evaluate_mrr = evaluate
    return lambda: setattr(training, "evaluate_mrr", whole)


def _scores_altered(run) -> None:
    scored = run.model.batch_predict

    def predict(h, edges, mesh=None):
        return _negate_first_chunk(scored(h, edges, mesh=mesh))

    run.model.batch_predict = predict


# fault name -> (patch, applied after start_check rather than after build);
# a patch of the port's module returns what undoes it
FAULTS = {
    "half_batch": (_half_batch, False),
    "unchanged": (_unchanged, False),
    "answer_altered": (_answer_altered, True),
    "scores_altered": (_scores_altered, False),
}


def readings(spec, seed: int, variants, device, seconds: float = 3.0):
    """{variant: the check's numbers} for one seed."""
    run = manifest.kind(spec["traffic"]["kind"]).Run(spec, seed, device)
    run.prepare()
    outputs = {}
    for v in variants:
        run.args = port.args(run.model_cfg, FLAGS.get(v, ()))
        run.build(run.args)
        patch, late = FAULTS.get(v, (None, False))
        undo = None
        if patch is not None and not late:
            undo = patch(run)
        run.start_check()
        if patch is not None and late:
            undo = patch(run)
        run.control_work(seconds)
        if undo is not None:
            undo()
        outputs[v] = run.outputs()
        for name in ("model", "opt", "scorer", "eval_pairs", "pos", "pos_w"):
            setattr(run, name, None)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    run.free_program()
    ref = run.reference()
    return {v: run.compare(out, ref) for v, out in outputs.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="h100_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program,bf16")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("h100_bench.control reads the card: no CUDA device", file=sys.stderr)
        return 2
    spec = manifest.cell(Path.cwd(), a.workload)
    device = torch.device("cuda:0")
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(spec, seed, a.variants.split(","), device, a.seconds)
        for v, values in got.items():
            line = json.dumps({"workload": a.workload, "seed": seed, "variant": v, **values,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
