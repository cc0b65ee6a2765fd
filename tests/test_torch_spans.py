"""The span recorder of plnlp_tpu_torch.profiling and the spans and
counters the port records with it (CPU).

* Off, a span is one shared no-op object and records nothing; on (or under
  a profiler), nested spans carry their parent and root ids, and a span's
  self time is its duration less its children's.
* A span's interval is on the profiler's export clock: its event in the
  export starts within 1 ms of the recorded ``t0_ns``.
* ``prepare_graph``, ``Model.train_epoch``, ``Model.test`` and
  ``Scorer.rank_candidates_batch`` emit their spans once per call, batch,
  split and kind, or chunk; the ranking counters count exact requests and
  bytes; ``--profile_dir`` logs the set-up's spans and the profiled
  epoch's span table and writes the spans beside the trace.
"""

import collections
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from plnlp_tpu_torch import cli, profiling, serve
from plnlp_tpu_torch.graph import prepare_graph
from plnlp_tpu_torch.profiling import span
from plnlp_tpu_torch.training import Model, ModelConfig
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

N = 48


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.drain()
    yield
    profiling.drain()


def _names(recorded):
    return collections.Counter(s.name for s in recorded)


def _graph():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, 300), rng.integers(0, N, 300)
    keep = src != dst
    return prepare_graph(src[keep], dst[keep], num_nodes=N, symmetrize=True,
                         block=(16, 32), device="cpu")


def _model(**kw):
    cfg = ModelConfig(encoder="SAGE", predictor="DOT", emb_hidden_channels=8,
                      gnn_hidden_channels=8, mlp_hidden_channels=8, batch_size=32, **kw)
    return Model(cfg, N, seed=0, device="cpu")


def test_off_records_nothing_and_returns_one_object():
    assert span("a") is span("b")
    with span("a"):
        with span("b"):
            pass
    assert profiling.spans() == []


def test_nested_parents_roots_and_self_time():
    with profiling.tracing():
        with span("root"):
            with span("a"):
                with span("a.inner"):
                    pass
            with span("b"):
                pass
        with span("next"):
            pass
    got = {s.name: s for s in profiling.drain()}
    assert profiling.spans() == []
    root, a, inner, b, nxt = (got[k] for k in ("root", "a", "a.inner", "b", "next"))
    assert root.parent_id is None and root.root_id == root.span_id
    assert a.parent_id == root.span_id and b.parent_id == root.span_id
    assert inner.parent_id == a.span_id
    assert {a.root_id, b.root_id, inner.root_id} == {root.span_id}
    assert nxt.parent_id is None and nxt.root_id == nxt.span_id != root.span_id
    assert root.t0_ns <= a.t0_ns <= inner.t0_ns <= inner.t1_ns <= a.t1_ns <= b.t0_ns
    assert b.t1_ns <= root.t1_ns <= nxt.t0_ns
    own = profiling.self_ns(list(got.values()))
    dur = {k: s.t1_ns - s.t0_ns for k, s in got.items()}
    assert own[root.span_id] == dur["root"] - dur["a"] - dur["b"]
    assert own[a.span_id] == dur["a"] - dur["a.inner"]
    assert own[inner.span_id] == dur["a.inner"] and own[nxt.span_id] == dur["next"]
    table = {r["name"]: r for r in profiling.span_table(list(got.values()))}
    assert table["a"]["count"] == 1
    assert abs(table["root"]["self_ms"] - own[root.span_id] / 1e6) < 1e-9
    with profiling.tracing(False):
        with span("off"):
            pass
    assert profiling.spans() == []


def test_records_kept_until_drained_at_most_max_spans(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):  # recorded under a profiler
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4"]
    assert [s.name for s in profiling.drain()] == ["s2", "s3", "s4"]
    assert profiling.spans() == []
    assert profiling.MAX_SPANS >= 1 << 16


def test_span_on_the_profilers_export_clock(tmp_path):
    path = str(tmp_path / "t.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("clock.warm"):  # recorded under the profiler, recorder off
            pass
        with span("clock.probe"):
            torch.ones(64).sum()
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    got = {s.name: s for s in profiling.drain()}
    assert set(got) == {"clock.warm", "clock.probe"}
    base = int(trace["baseTimeNanoseconds"])
    ann = [e for e in trace["traceEvents"]
           if e.get("name") == "clock.probe" and e.get("cat") in ("cpu_op", "user_annotation")]
    assert len(ann) == 1
    start_ns = base + float(ann[0]["ts"]) * 1000
    assert abs(start_ns - got["clock.probe"].t0_ns) < 1e6


def test_graph_train_and_eval_spans_once_per_unit():
    with profiling.tracing():
        graph, graph_t = _graph()
    assert _names(profiling.drain()) == {
        "graph.prepare_graph": 1, "graph.csr": 1, "graph.csr_t": 1, "graph.blocks": 1,
        "graph.upload": 1,
    }
    model = _model()
    opt = model.make_optimizer()
    pos = torch.as_tensor(np.stack([graph.senders[:80].numpy(), graph.receivers[:80].numpy()], 1))
    gen = torch.Generator().manual_seed(0)
    with profiling.tracing():
        model.train_epoch(opt, graph, graph_t, None, pos, None, gen, 0.01)
    recorded = profiling.drain()
    steps = 3  # ceil(80 / 32)
    assert _names(recorded) == {
        "train.epoch": 1, "train.sample": 1, "train.shuffle": 1, "train.sync": 1,
        **{k: steps for k in ("train.step", "train.forward", "train.backward",
                               "train.clip", "train.optim")},
    }
    epoch = next(s for s in recorded if s.name == "train.epoch")
    assert {s.root_id for s in recorded} == {epoch.span_id}
    edges = {split: {"pos": pos[:10], "neg": pos[10:30]} for split in ("valid", "test")}
    with profiling.tracing():
        model.test(graph, graph_t, None, edges, "hits")
    assert _names(profiling.drain()) == {
        "eval.test": 1, "eval.encode": 1, "eval.predict": 4, "eval.metric": 1,
    }


@pytest.mark.parametrize("candidates", [None, "subset"])
def test_rank_spans_and_counters(candidates):
    graph, graph_t = _graph()
    sc = serve.Scorer(_model(), graph, graph_t)
    cand = None if candidates is None else np.arange(0, N, 2)
    c = N if cand is None else cand.size
    sc._MAX_GRID_PAIRS = 3 * c  # chunks of 3 sources
    srcs = np.array([1, 5, 7, 9, 11, 13, 20])
    chunks = 3  # ceil(7 / 3)
    before = (serve.REQUESTS, serve.H2D_BYTES)
    with profiling.tracing():
        ids, scores = sc.rank_candidates_batch(srcs, cand, k=4, exclude_edges=True)
    assert ids.shape == scores.shape == (7, 4)
    mapped = 0 if cand is None else 8 * N  # the candidate map the mask reads
    assert serve.REQUESTS - before[0] == 1
    assert serve.H2D_BYTES - before[1] == 8 * c + 8 * srcs.size + mapped
    recorded = profiling.drain()
    assert _names(recorded) == {
        "serve.rank": 1, "serve.rank.prep": 1,
        **{k: chunks for k in ("serve.rank.grid", "serve.rank.mask", "serve.rank.topk",
                               "serve.rank.copy_out")},
    }
    root = next(s for s in recorded if s.name == "serve.rank")
    assert all(s.parent_id == root.span_id for s in recorded if s is not root)
    sc.rank_candidates_batch(srcs, cand, k=4, exclude_edges=True)  # off: counted, not recorded
    assert serve.REQUESTS - before[0] == 2 and profiling.spans() == []


def test_profile_dir_logs_set_up_and_span_table(tmp_path):
    pd = str(tmp_path / "trace")
    argv = ["--data_name=synthetic:hits:num_nodes=120,num_edges=600", "--epochs=2",
            "--eval_steps=2", "--runs=1", "--batch_size=256", "--adj_backend=csr",
            "--emb_hidden_channels=8", "--gnn_hidden_channels=8",
            "--mlp_hidden_channels=8", f"--profile_dir={pd}"]
    lines = []
    with contextlib.redirect_stdout(io.StringIO()):
        cli.run_experiment(cli.argument(argv), log=lines.append, device="cpu")
    setup = [str(x) for x in lines if str(x).startswith("[profile] set-up ")]
    assert len(setup) == 1
    assert "prepare.surgery" in setup[0] and "graph.prepare_graph" in setup[0]
    table = [str(x) for x in lines if str(x).startswith("[profile] span ")]
    assert table and any(x.endswith(" train.epoch") for x in table)
    files = os.listdir(pd)
    assert [f for f in files if f.endswith(".pt.trace.json")]
    (spans_file,) = [f for f in files if f.endswith(".spans.json")]
    with open(os.path.join(pd, spans_file)) as f:
        names = _names(profiling.Span(**s) for s in json.load(f))
    assert names["train.epoch"] == 1 and names["train.sample"] == 1
    assert profiling.spans() == []
