"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the same
configuration, traffic and limits with the dataset's counts scaled down."""

import copy
from pathlib import Path

import torch

from h100_bench import manifest

ROOT = Path(__file__).resolve().parents[2]

torch.set_num_threads(2)


def spec(name: str, scale: float):
    s = copy.deepcopy(manifest.cell(ROOT, name))
    d = s["config"]["dataset"]
    for k in ("num_nodes", "num_train", "num_valid", "num_test", "num_neg_eval"):
        if k in d:
            d[k] = max(64, int(d[k] * scale))
    if "neg_per_source" in d:
        d["neg_per_source"] = 20
    s["config"]["model"]["batch_size"] = 256
    t = s["traffic"]
    if t.get("call_positives") not in (None, "all"):
        t["call_positives"] = 512
    if "sources_max" in t:
        t.update(sources_min=8, sources_max=64, size_levels=4)
    return s


def run(name: str, scale: float, seed: int = 2**31 + 11, flags=()):
    s = spec(name, scale)
    return manifest.kind(s["traffic"]["kind"]).Run(s, seed, "cpu", flags)


SCALES = {
    "collab-sage-dot.train": 0.01,
    "citation2-gcn.train": 0.002,
    "collab-sage-dot.rank": 0.01,
    "citation2-gcn.eval": 0.002,
}
