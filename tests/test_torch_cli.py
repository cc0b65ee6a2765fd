"""plnlp_tpu_torch's CLI against plnlp_tpu's (CPU).

* ``run_experiment(device="cpu")`` runs every backend, with walk
  augmentation, and a run resumed from its checkpoint ends with the same
  parameter bits and Logger results as the run without the break.
* ``--score_pairs`` equals the restored model's Scorer, under the hybrid
  relabel too, with pairs in original ids.
* Flag values whose code is not ported (the partition of TRANSFORMER and
  of the hybrid operand) raise NotImplementedError naming their ROADMAP
  item.

The JAX ``run_experiment`` is never called (its compiles cost seconds a
case); the two packages' random draws never agree, so runs are compared
with themselves, and numeric parity is held per module in the other
``tests/test_torch_*.py`` files.  The flag surface, the dataset surgery
and ``prepare_experiment``'s choices are held against the JAX CLI's in
tests/test_torch_cli_prepare.py.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from plnlp_tpu_torch import cli
from plnlp_tpu_torch.checkpoint import CheckpointManager
from plnlp_tpu_torch.serve import Scorer
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)

SMALL = "synthetic:hits:num_nodes=300,num_edges=3000"
SBM = "synthetic:hits-sbm:num_nodes=600,num_edges=6000,num_communities=10"
TILES = dict(tile_size=32, tile_min_fill=8, dense_threshold=10)


def _argv(**kw):
    base = dict(data_name=SMALL, epochs=2, eval_steps=1, runs=1, batch_size=512,
                emb_hidden_channels=8, gnn_hidden_channels=8, mlp_hidden_channels=8)
    base.update(kw)
    return [f"--{k}={v}" for k, v in base.items()]


def _args(**kw):
    return cli.argument(_argv(**kw))


def _run(args, log=None):
    with contextlib.redirect_stdout(io.StringIO()):
        return cli.run_experiment(args, log=log or (lambda *_: None), device="cpu")


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


@pytest.mark.parametrize("case,kw", [
    ("csr", dict(adj_backend="csr", block_rows=64, block_edges=64)),
    ("dense", dict(adj_backend="dense", encoder="TRANSFORMER")),
    ("hybrid", dict(data_name=SBM, **TILES)),
    ("mrr", dict(data_name="synthetic:mrr:num_nodes=200,num_edges=1500", eval_metric="mrr",
                 neg_sampler="local", encoder="GCN", num_neg=3, adj_backend="csr")),
    ("walks", dict(random_walk_augment=True, walk_length=3, loss_func="WeightedHingeAUC",
                   gnn_num_layers=1, use_lr_decay=True, predictor="DOT")),
])
def test_run_experiment_runs(tmp_path, case, kw):
    mf = str(tmp_path / "metrics.jsonl")
    loggers = _run(_args(metrics_file=mf, res_dir=str(tmp_path / "res"), **kw))
    metric = "MRR" if case == "mrr" else "Hits@20"
    res = np.asarray(loggers[metric].results[0])
    assert res.shape == (2, 2) and np.isfinite(res).all() and (res >= 0).all()
    lines = [json.loads(line) for line in open(mf)]
    assert [line["epoch"] for line in lines] == [1, 2]
    assert all(np.isfinite(line["loss"]) and line["agg_edges_per_sec"] > 0 for line in lines)
    text = open(os.path.join(tmp_path / "res", os.listdir(tmp_path / "res")[0])).read()
    assert "Total number of model parameters is" in text and "Final Test:" in text


def _final_state(ckpt_dir):
    return CheckpointManager(ckpt_dir).restore()


def test_resume_equals_uninterrupted_run_bitwise(tmp_path):
    """Two epochs in one go against one epoch, then a resume for the
    second: the same parameter bits, optimizer state and Logger results
    (positional generators, the optimizer state restored)."""
    common = dict(adj_backend="csr", block_rows=64, block_edges=64, checkpoint_every=1,
                  dropout=0.3, seed=4)
    full = _run(_args(checkpoint_dir=str(tmp_path / "a"), **common))
    _run(_args(epochs=1, checkpoint_dir=str(tmp_path / "b"), **common))
    lines = []
    resumed = _run(_args(checkpoint_dir=str(tmp_path / "b"), resume=True, **common),
                   log=lines.append)
    assert "Resumed from run 1, epoch 2" in lines
    epochs = [str(line)[:22] for line in lines if str(line).startswith("Run: ")]
    assert epochs == ["Run: 01, Epoch: 02, Lo"] * 3  # one epoch, three Hits@K
    for k in full:
        assert resumed[k].results == full[k].results
    (ma, oa, ea), (mb, ob, eb) = _final_state(str(tmp_path / "a")), _final_state(str(tmp_path / "b"))
    assert ea == eb
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_reset_optimizer_multi_run():
    """The optimizer state carries across runs unless --reset_optimizer
    (reference model.py:85-96): run 1 is the same either way, run 2 not."""
    carry = _run(_args(runs=2, seed=9, adj_backend="csr"))
    reset = _run(_args(runs=2, seed=9, adj_backend="csr", reset_optimizer=True))
    assert carry["Hits@20"].results[0] == reset["Hits@20"].results[0]
    assert carry["Hits@20"].results[1] != reset["Hits@20"].results[1]


@pytest.mark.parametrize("train_backend", ["csr", "auto"])
def test_score_pairs_equals_restored_scorer(tmp_path, train_backend):
    """Serve with the default auto (-> csr, no estimate) what was trained
    over csr, or over hybrid through auto: pairs in original ids through
    the trained run's relabel give the trained model's scores.  Over csr
    the encode is the same computation (rtol = atol = 1e-6); against the
    hybrid encode the sums run in another order (rtol = atol = 1e-5)."""
    ck = str(tmp_path / "ck")
    kw = dict(data_name=SBM, adj_backend=train_backend, checkpoint_dir=ck, checkpoint_every=1,
              predictor="DOT", **TILES)
    lines = []
    _run(_args(**kw), log=lines.append)
    assert any("-> hybrid" in str(line) for line in lines) == (train_backend == "auto")
    pairs = np.random.default_rng(0).integers(0, 600, (300, 2))
    np.save(tmp_path / "pairs.npy", pairs)
    out = str(tmp_path / "scores.npy")
    serve_args = _args(**dict(kw, adj_backend="auto", score_pairs=str(tmp_path / "pairs.npy"),
                              score_out=out))
    with contextlib.redirect_stdout(io.StringIO()):
        scores = cli.run_scoring(serve_args, log=lambda *_: None, device="cpu")
    np.testing.assert_array_equal(np.load(out), scores)
    # the trained run's own operand and id space
    exp = cli.prepare_experiment(_args(**kw), log=lambda *_: None, device="cpu")
    relabel = exp["node_relabel"]
    assert (relabel is not None) == (train_backend == "auto")
    sc = Scorer.from_checkpoint(exp["model"], ck, exp["graph"], exp["graph_t"])
    want = sc.score(pairs if relabel is None else relabel[pairs])
    tol = 1e-6 if relabel is None else 1e-5
    np.testing.assert_allclose(scores, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("flag,item", [
    (dict(num_shards=2, encoder="TRANSFORMER"), "item 11b"),
    (dict(num_shards=2, adj_backend="hybrid"), "item 11b"),
])
def test_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        _run(_args(**flag))


@pytest.mark.parametrize("backend", ["csr", "hybrid"])
def test_transformer_bf16_runs(backend):
    """TRANSFORMER in bf16 trains and evaluates over blocked CSR (the
    blocked hand VJP) and over the hybrid operand (K3-K5's bf16 plain
    versions)."""
    kw = dict(data_name=SBM, **TILES) if backend == "hybrid" else dict(adj_backend="csr")
    lines = []
    loggers = _run(_args(encoder="TRANSFORMER", compute_dtype="bfloat16", **kw),
                   log=lines.append)
    assert any("-> hybrid" in str(line) for line in lines) == (backend == "hybrid")
    res = np.asarray(loggers["Hits@20"].results[0])
    assert res.shape == (2, 2) and np.isfinite(res).all()


def test_profile_dir_and_main(tmp_path):
    """--profile_dir traces epoch 2 (on the CPU the trace has no device
    events, so no [profile] line); main() and ``python -m`` parse the
    JAX package's command lines and run on cuda:<--device>."""
    pd = str(tmp_path / "trace")
    _run(_args(adj_backend="csr", profile_dir=pd))
    assert [f for f in os.listdir(pd) if f.endswith(".pt.trace.json")]
    if not torch.cuda.is_available():
        with contextlib.redirect_stdout(io.StringIO()), pytest.raises(RuntimeError, match="no GPU"):
            cli.main(_argv())
