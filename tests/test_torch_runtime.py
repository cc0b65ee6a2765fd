"""plnlp_tpu_torch's run-time modules against plnlp_tpu (CPU): the Logger,
the dataset loaders, the walks and their pairs, checkpoints, preemption
and supervision, and the profiler's summary.

Exact comparisons throughout (text, arrays, bits): none of these modules
computes in floating point beyond what both packages do the same way.
"""

import collections
import contextlib
import gzip
import io
import json
import os
import pickle
import signal
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

import plnlp_tpu.augment as jaugment
import plnlp_tpu.data as jdata
import plnlp_tpu.graph as jgraph
import plnlp_tpu.ops.walk as jwalk
from plnlp_tpu.logger import Logger as JaxLogger
from plnlp_tpu_torch import data as tdata
from plnlp_tpu_torch import graph as tgraph
from plnlp_tpu_torch.augment import random_walk_pairs
from plnlp_tpu_torch.checkpoint import CheckpointManager
from plnlp_tpu_torch.cli import argument, run_experiment
from plnlp_tpu_torch.data import custom as tcustom
from plnlp_tpu_torch.data import ogb as togb
from plnlp_tpu_torch.logger import Logger
from plnlp_tpu_torch.ops.walk import random_walk
from plnlp_tpu_torch.profiling import (
    MetricsWriter,
    ThroughputMeter,
    profile_trace,
    summarize_trace,
)
from plnlp_tpu_torch.resilience import Preempted, PreemptionGuard, run_resilient
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

# ---------------------------------------------------------------------------
# Logger
# ---------------------------------------------------------------------------


def _logger_text(cls, results, runs, last_best):
    lg = cls(runs)
    for run, series in enumerate(results):
        for r in series:
            lg.add_result(run, r)
    buf = io.StringIO()
    for run in range(runs):
        lg.print_statistics(run, f=buf, last_best=last_best)
    lg.print_statistics(f=buf, last_best=last_best)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        lg.print_statistics(last_best=last_best)
    return buf.getvalue() + out.getvalue(), lg.summary(last_best)


@pytest.mark.parametrize("last_best", [False, True])
def test_logger_text_matches_jax(last_best):
    rng = np.random.default_rng(0)
    # run 0 has a saturated valid (two argmaxes: last_best picks the later
    # one), run 1 random, run 2 one eval point, run 3 none
    results = [
        [(1.0, 0.2), (0.5, 0.3), (1.0, 0.8)],
        [tuple(map(float, r)) for r in rng.random((5, 2))],
        [(0.25, 0.125)],
        [],
    ]
    got = _logger_text(Logger, results, 4, last_best)
    want = _logger_text(JaxLogger, results, 4, last_best)
    assert got[0] == want[0]
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert "Highest Eval Point: 3" in got[0] if last_best else "Highest Eval Point: 1" in got[0]
    with pytest.raises(IndexError):
        Logger(1).add_result(1, (0.0, 0.0))


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: keys {set(a)} vs {set(b)}"
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, f"{path}: {a} vs {b}"


@pytest.mark.parametrize("kind", ["hits", "mrr"])
def test_npz_round_trip_matches_jax(tmp_path, kind):
    """A file the port writes reads back the same in both packages (and
    the other way round), extras included; the synthetic spec gives the
    JAX package's dataset."""
    spec = f"synthetic:{kind}:num_nodes=120,num_edges=900,num_node_feats=3,seed=2"
    ds = tdata.load_dataset(spec)
    _tree_equal(ds, jdata.load_dataset(spec))
    ew = np.random.default_rng(1).random(ds["edge_index"].shape[1]).astype(np.float32)
    ds = dict(ds, edge_weight=ew, edge_year=np.arange(len(ew)))
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tcustom.export_npz_dataset(ds, pt)
    jdata.export_npz_dataset(ds, pj)
    for p in (pt, pj):
        got = tdata.load_dataset(f"npz:{p}")
        _tree_equal({k: v for k, v in got.items() if k != "name"},
                    {k: v for k, v in jdata.load_dataset(p).items() if k != "name"})
        assert got["eval_metric"] == kind and got["directed"] == (kind == "mrr")
        np.testing.assert_array_equal(got["edge_weight"], ew)
        _tree_equal(got["split_edge"], {k: dict(v) for k, v in ds["split_edge"].items()})


def test_npz_validation_errors_match_jax(tmp_path):
    ds = tdata.make_synthetic_dataset("hits", num_nodes=100, num_edges=800, seed=6)
    bad = {k: dict(v) for k, v in ds["split_edge"].items()}
    del bad["valid"]["edge_neg"]
    oob = {k: dict(v) for k, v in ds["split_edge"].items()}
    oob["test"]["edge_neg"] = oob["test"]["edge_neg"] + 1000
    cases = [
        (dict(num_nodes=100, split_edge=bad), "edge_neg"),
        (dict(num_nodes=5, split_edge=ds["split_edge"]), "num_nodes"),
        (dict(num_nodes=100, split_edge=oob, edge_index=ds["edge_index"]), "outside"),
        (dict(num_nodes=100, split_edge=ds["split_edge"], eval_metric="auc"), "eval_metric"),
    ]
    for i, (kw, match) in enumerate(cases):
        msgs = []
        for save in (tcustom.save_npz_dataset, jdata.save_npz_dataset):
            with pytest.raises(ValueError, match=match) as exc:
                save(str(tmp_path / f"{i}.npz"), **kw)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(FileNotFoundError):
        tdata.load_dataset(f"npz:{tmp_path / 'missing.npz'}")
    # the converter entry point (python -m plnlp_tpu_torch.data.custom)
    out = str(tmp_path / "conv.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        tcustom._main(["synthetic:hits:num_nodes=100,num_edges=800,seed=6", out])
    _tree_equal(tdata.load_dataset(out)["split_edge"], ds["split_edge"])


def _fake_ogb(root, name, edges, splits):
    base = root / name.replace("-", "_")
    (base / "raw").mkdir(parents=True)
    (base / "split" / "target").mkdir(parents=True)
    with gzip.open(base / "raw" / "edge.csv.gz", "wt") as f:
        f.writelines(f"{u},{v}\n" for u, v in edges)
    with gzip.open(base / "raw" / "num-node-list.csv.gz", "wt") as f:
        f.write(f"{int(edges.max()) + 2}\n")
    with gzip.open(base / "raw" / "node-feat.csv.gz", "wt") as f:
        f.writelines(",".join(["0.5", "1.5"]) + "\n" for _ in range(int(edges.max()) + 2))
    for split, d in splits.items():
        torch.save(d, base / "split" / "target" / f"{split}.pt")


def test_ogb_directory_matches_jax(tmp_path):
    """The OGB layout reads the same in both packages (citation2-style
    names give mrr and directed)."""
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [4, 2]])
    t = torch.tensor(edges)
    splits = {
        "train": {"source_node": t[:, 0], "target_node": t[:, 1]},
        "valid": {"source_node": t[:2, 0], "target_node": t[:2, 1],
                  "target_node_neg": t[:2].repeat(1, 3)},
        "test": {"source_node": t[2:, 0], "target_node": t[2:, 1],
                 "target_node_neg": t[2:].repeat(1, 3)},
    }
    _fake_ogb(tmp_path, "ogbl-citation2", edges, splits)
    got = tdata.load_dataset("ogbl-citation2", str(tmp_path))
    _tree_equal(got, jdata.load_dataset("ogbl-citation2", str(tmp_path)))
    assert got["num_nodes"] == 6 and got["eval_metric"] == "mrr" and got["directed"]
    assert got["node_feat"].shape == (6, 2)
    with pytest.raises(FileNotFoundError, match="no network access"):
        tdata.load_dataset("ogbl-ddi", str(tmp_path))


class _CustomPayload:
    """A class torch.load(weights_only=True) refuses to construct."""

    def __eq__(self, other):
        return isinstance(other, _CustomPayload)


def test_restricted_pt_reader_refuses_like_jax(tmp_path, monkeypatch):
    """Plain tensors come back without torch; constructors are blocked;
    an archive both safe readers reject is refused unless opted in;
    tensor metadata reaching past its storage is rejected."""
    from plnlp_tpu.data import ogb as jogb

    path = tmp_path / "plain.pt"
    base = torch.arange(40, dtype=torch.int64).reshape(5, 8)
    torch.save({"t": base.T, "s": base[1:4, 2:7], "w": torch.linspace(0, 1, 6)}, path)
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(sys.modules, "torch", None)  # the reader must not need torch
        got = togb._load_split_file(str(path))
    finally:
        mp.undo()
    _tree_equal(got, jogb._load_split_file(str(path)))
    np.testing.assert_array_equal(got["t"], base.T.numpy())

    buf = io.BytesIO()
    pickle.dump(collections.Counter(), buf)
    evil = tmp_path / "evil.pt"
    with zipfile.ZipFile(evil, "w") as zf:
        zf.writestr("archive/data.pkl", buf.getvalue())
    with pytest.raises(pickle.UnpicklingError, match="blocked unpickle"):
        togb._load_pt_without_torch(str(evil))

    exotic = tmp_path / "exotic.pt"
    torch.save({"o": _CustomPayload()}, exotic)
    monkeypatch.delenv("PLNLP_UNSAFE_PT_LOAD", raising=False)
    with pytest.raises(RuntimeError, match="PLNLP_UNSAFE_PT_LOAD"):
        togb._load_split_file(str(exotic))
    monkeypatch.setenv("PLNLP_UNSAFE_PT_LOAD", "1")
    with pytest.warns(UserWarning, match="weights_only=False"):
        assert togb._load_split_file(str(exotic))["o"] == _CustomPayload()

    storage = np.arange(4, dtype=np.int64)
    for size, stride, offset in (((1000000,), (1,), 0), ((2, 2), (8, 1), 0), ((4,), (-1,), 3),
                                 ((2,), (1,), -1)):
        with pytest.raises(pickle.UnpicklingError, match="bounds|reaches|offset"):
            togb._rebuild_tensor_v2(storage, offset, size, stride, False, {})
    with pytest.raises(FileNotFoundError):
        togb._load_split_file(str(tmp_path / "missing.pt"))


# ---------------------------------------------------------------------------
# Walks and walk pairs
# ---------------------------------------------------------------------------


def test_walk_pairs_match_jax_on_a_deterministic_graph():
    """Every node has at most one neighbor in the CSR layout, so the walk
    has no choice: pairs, weights and validity equal JAX's exactly (a node
    without one stays put, which makes self-pairs, masked invalid)."""
    n, steps = 40, 4
    rng = np.random.default_rng(0)
    dst = rng.permutation(n)[:30]  # 30 nodes get one in-edge, 10 none
    src = rng.integers(0, n, 30)
    tg = tgraph.build_graph(src, dst, None, num_nodes=n, device="cpu")
    jg = jgraph.build_graph(src, dst, None, num_nodes=n)
    start = rng.integers(0, n, 25)
    got = random_walk_pairs(tg, torch.as_tensor(start), steps, torch.Generator().manual_seed(1))
    want = jaugment.random_walk_pairs(jg, start, steps, jax.random.PRNGKey(1))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.float32
    assert not got[2].all() and got[2].any()
    walk = random_walk(tg, torch.as_tensor(start), steps, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(
        walk.numpy(), np.asarray(jwalk.random_walk(jg, start, steps, jax.random.PRNGKey(1)))
    )


def test_walk_steps_are_edges():
    n = 60
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, n, 400), rng.integers(0, n, 400)
    keep = dst % 7 != 0  # nodes 0, 7, ... have no neighbor: they stay
    tg = tgraph.build_graph(src[keep], dst[keep], None, num_nodes=n, symmetrize=False,
                            device="cpu")
    walk = random_walk(tg, torch.arange(n).repeat(5), 6, torch.Generator().manual_seed(3))
    assert walk.shape == (5 * n, 7)
    indptr, senders = tg.indptr.numpy(), tg.senders.numpy()
    nbrs = [set(senders[indptr[v]:indptr[v + 1]].tolist()) for v in range(n)]
    for a, b in zip(walk[:, :-1].reshape(-1).tolist(), walk[:, 1:].reshape(-1).tolist()):
        assert b in nbrs[a] if nbrs[a] else b == a
    assert len({(a, b) for a, b in zip(walk[:, 0].tolist(), walk[:, 1].tolist())}) > n


# ---------------------------------------------------------------------------
# Checkpoints, preemption, supervision
# ---------------------------------------------------------------------------


def _state():
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.randn(5, 4)).sum().backward()
    opt.step()
    return model, opt


def test_checkpoint_round_trip_retention_and_atomic_save(tmp_path, monkeypatch):
    model, opt = _state()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    extra = {"run": 1, "epoch": 7, "results": {"Hits@20": [[[0.1, 0.2]]]}}
    for step in (3, 7, 5, 9):
        mgr.save(step, model.state_dict(), opt.state_dict(), extra)
    assert mgr.all_steps() == [5, 7, 9] and mgr.latest_step() == 9  # the newest 3
    ms, os_, ex = mgr.restore()
    assert ex == extra
    assert all(torch.equal(ms[k], v) for k, v in model.state_dict().items())
    model2, opt2 = _state()
    model2.load_state_dict(ms)
    opt2.load_state_dict(os_)
    for k, v in opt.state_dict()["state"][0].items():
        assert torch.equal(opt2.state_dict()["state"][0][k], v)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()

    # a kill during a save leaves the last checkpoint whole
    def dying_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(11, model.state_dict(), opt.state_dict(), extra)
    monkeypatch.undo()
    assert mgr.latest_step() == 9
    assert mgr.restore()[2] == extra


def _args(tmp_path, **overrides):
    base = dict(
        data_name="synthetic:hits:num_nodes=200,num_edges=1500", epochs=4, eval_steps=1,
        runs=1, batch_size=512, emb_hidden_channels=8, gnn_hidden_channels=8,
        mlp_hidden_channels=8, checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1,
    )
    base.update(overrides)
    return argument([f"--{k}={v}" for k, v in base.items()])


def _quiet(*_):
    pass


def test_sigterm_checkpoints_exits_75_and_resumes(tmp_path):
    args = _args(tmp_path, epochs=3, checkpoint_every=100)

    def log_hook(msg):
        if "Epoch: 02" in str(msg):
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(Preempted) as exc:
            run_experiment(args, log=log_hook, device="cpu")
        assert exc.value.code == 75 and exc.value.epoch == 2
        assert signal.getsignal(signal.SIGTERM) is before
        assert CheckpointManager(args.checkpoint_dir).latest_step() == 2
        args.resume = True
        lines = []
        loggers = run_experiment(args, log=lines.append, device="cpu")
    assert "Resumed from run 1, epoch 3" in lines
    assert len(loggers["Hits@20"].results[0]) == 3

    with PreemptionGuard() as g:
        assert g.active and not g.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.preempted and g.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before


def test_run_resilient_restarts_from_checkpoint(tmp_path):
    args = _args(tmp_path)
    calls = {"n": 0}

    def flaky_run(a, log):
        calls["n"] += 1
        if calls["n"] == 1:
            short = argument([])
            vars(short).update(vars(a), epochs=2)
            run_experiment(short, log=log, device="cpu")
            raise RuntimeError("injected failure")
        assert a.resume is True
        return run_experiment(a, log=log, device="cpu")

    with contextlib.redirect_stdout(io.StringIO()):
        loggers = run_resilient(args, max_restarts=2, backoff_seconds=0.0, log=_quiet,
                                _run=flaky_run)
    assert calls["n"] == 2 and len(loggers["Hits@20"].results[0]) == 4

    def always_fail(a, log):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="after 1 restarts"):
        run_resilient(args, max_restarts=1, backoff_seconds=0.0, log=_quiet, _run=always_fail)

    def preempted(a, log):
        raise Preempted(0, 3)

    with pytest.raises(Preempted):
        run_resilient(args, max_restarts=3, backoff_seconds=0.0, log=_quiet, _run=preempted)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_resilient(_args(tmp_path, checkpoint_dir=""))


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def test_meter_and_metrics_writer(tmp_path):
    m = ThroughputMeter(num_edges=1000, gnn_layers=2, batch_size=64)
    m.start()
    m.stop(100)  # 2 batches run (128 slots), 100 of them real
    assert m.last_edges_per_sec > 0
    assert abs(m.last_useful_edges_per_sec / m.last_edges_per_sec - 100 / 128) < 1e-9
    path = str(tmp_path / "m" / "m.jsonl")
    w = MetricsWriter(path)
    w.write(epoch=1, loss=2.5)
    w.write(epoch=2, loss=1.5)
    lines = [json.loads(line) for line in open(path)]
    assert [line["epoch"] for line in lines] == [1, 2] and all("ts" in line for line in lines)
    MetricsWriter(None).write(epoch=3)


def test_summarize_trace_parses_a_chrome_trace(tmp_path):
    """Device kernels, copies and memsets are summed by name; host events
    (operators, runtime calls, Python) are not counted."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "plnlp_scatter_matmul", "dur": 2700.0},
        {"ph": "X", "cat": "kernel", "name": "plnlp_scatter_matmul", "dur": 2300.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 80.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 700.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 99999.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 5000.0},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]
    d = tmp_path / "trace"
    d.mkdir()
    (d / "old.pt.trace.json").write_text(json.dumps({"traceEvents": events[:1]}))
    os.utime(d / "old.pt.trace.json", (1, 1))
    (d / "new.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    rows = summarize_trace(str(d))
    assert [r["name"] for r in rows] == ["plnlp_scatter_matmul", "Memcpy HtoD", "Memset (Device)"]
    assert rows[0]["count"] == 2 and abs(rows[0]["total_ms"] - 5.0) < 1e-12
    assert abs(rows[0]["mean_ms"] - 2.5) < 1e-12
    assert len(summarize_trace(str(d), top=1)) == 1
    assert len(summarize_trace(str(d), top=None)) == 3
    with pytest.raises(FileNotFoundError):
        summarize_trace(str(tmp_path / "nope"))

    pd = str(tmp_path / "captured")
    with profile_trace(pd):
        torch.ones(8) @ torch.ones(8)
    with profile_trace(None):
        pass
    files = os.listdir(pd)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert summarize_trace(pd) == []  # a CPU run has no device events
