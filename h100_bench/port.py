"""The system under test: the calls into ``plnlp_tpu_torch`` that a cell
makes, and nothing of the benchmark's own arithmetic.

The configuration's ``model`` dict holds the CLI's flags by name; the
port's own parser reads them (``cli.argument``), its own surgery and graph
build prepare the inputs (``cli.apply_dataset_surgery``, then
``graph.prepare_graph`` as ``cli.prepare_experiment`` calls it for the csr
backend), and its ``Model`` trains, evaluates and serves.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Sequence

import torch


def args(model: Dict, extra: Sequence[str] = ()):
    """The CLI's namespace for the configuration's flags plus ``extra``."""
    from plnlp_tpu_torch import cli

    argv = []
    for key, value in model.items():
        argv += [f"--{key}", str(value)]
    return cli.argument(argv + list(extra))


def prepare(ds: Dict, a, device) -> Dict:
    """The surgery and the blocked graph with its transpose, timed."""
    from plnlp_tpu_torch import cli
    from plnlp_tpu_torch.graph import prepare_graph

    if a.adj_backend != "csr" or a.num_shards > 1 or a.block_rows == 0:
        raise ValueError("the benchmark's configurations pin --adj_backend csr and --block_rows")
    t0 = time.perf_counter()
    surg = cli.apply_dataset_surgery(ds, a)
    graph, graph_t = prepare_graph(
        surg["adj_src"], surg["adj_dst"], surg["adj_weight"], num_nodes=ds["num_nodes"],
        block=(a.block_rows, a.block_edges), device=device,
        couple_transpose=a.encoder.upper() == "TRANSFORMER",
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {
        "graph": graph,
        "graph_t": graph_t,
        "split_edge": surg["split_edge"],
        "prepare_s": time.perf_counter() - t0,
    }


def build_model(a, num_nodes: int, num_feats: int, weights: Dict, device):
    """The port's Model for the flags, its parameters set to ``weights``
    (by state-dict name), and its optimizer."""
    from plnlp_tpu_torch.training import Model, ModelConfig

    cfg = ModelConfig(**{
        f.name: getattr(a, f.name) for f in dataclasses.fields(ModelConfig) if hasattr(a, f.name)
    })
    model = Model(cfg, num_nodes, num_feats, seed=a.seed, device=device)
    named = dict(model.named_parameters())
    if set(named) != set(weights):
        raise ValueError(
            f"the port's parameters {sorted(named)} are not the reference's {sorted(weights)}"
        )
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])
    return model, model.make_optimizer()


def train_positives(split_edge: Dict, device):
    """(P, 2) positives and their per-pair weights (or None), on device."""
    from plnlp_tpu_torch import cli

    pos, w = cli.get_train_edges(split_edge)
    return (
        torch.as_tensor(pos, device=device),
        None if w is None else torch.as_tensor(w, device=device),
    )


def eval_edges(split_edge: Dict, device) -> Dict:
    """The valid and test pairs as ``cli.prepare_experiment`` puts them on
    the device for ``Model.test``."""
    from plnlp_tpu_torch import cli

    return {
        split: {k: torch.as_tensor(v, device=device) for k, v in cli.get_eval_edges(split_edge, split).items()}
        for split in ("valid", "test")
    }


def scorer(model, graph, graph_t, node_feats):
    from plnlp_tpu_torch.serve import Scorer

    return Scorer(model, graph, graph_t, node_feats, exclude_graph=graph)


def k1_launches() -> int:
    """K1 launches so far, both dtypes (the wrapper's own counters)."""
    from plnlp_tpu_torch.ops import scatter_matmul

    return scatter_matmul.LAUNCHES + scatter_matmul.LAUNCHES_BF16
