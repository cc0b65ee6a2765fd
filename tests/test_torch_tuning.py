"""plnlp_tpu_torch.tuning (CPU): ``autotune_block``'s choice and its
fallbacks (only an out-of-memory error skips a candidate), and
``grid_search`` and ``random_search`` through the port's
``run_experiment(device="cpu")``.  The CLI's ``--block_rows 0`` is in
tests/test_torch_bf16.py.
"""

import contextlib
import io

import pytest
import torch

from plnlp_tpu_torch import tuning
from tests.test_torch_bf16 import N, _cli_args, _sbm
import tests.torch_cpu  # noqa: F401  (one PyTorch thread a test process)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autotune_block_picks_a_measured_candidate(dtype):
    src, dst, _ = _sbm()
    lines = []
    best = tuning.autotune_block(src, dst, None, num_nodes=N, dim=8, block_edges=64,
                                 candidates=((32, 64), (64, 64), (256, 64)), iters=1,
                                 dtype=dtype, log=lines.append, device="cpu")
    assert best in ((32, 64), (64, 64)) and best[0] <= N
    assert len(lines) == 2 and all("spmm fwd+bwd" in line and dtype in line for line in lines)
    # the default sweep keeps the caller's block_edges and skips R > num_nodes
    r, b = tuning.autotune_block(src, dst, None, num_nodes=300, dim=4, block_edges=48,
                                 iters=1, device="cpu")
    assert r == 256 and b == 48


def test_autotune_block_fallbacks_and_errors(monkeypatch):
    src, dst, _ = _sbm()
    # every candidate above num_nodes: the largest power of two <= N
    assert tuning.autotune_block(src, dst, None, num_nodes=N, dim=4, block_edges=64,
                                 device="cpu") == (64, 64)
    lines = []

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(tuning, "_fwd_bwd_seconds", oom)
    got = tuning.autotune_block(src, dst, None, num_nodes=N, dim=4,
                                candidates=((64, 32), (16, 32), (512, 32)),
                                log=lines.append, device="cpu")
    assert got == (16, 32) and len(lines) == 2 and "out of device memory" in lines[0]

    def broken(*a, **k):
        raise RuntimeError("scatter_matmul launch: CUDA error 98")

    monkeypatch.setattr(tuning, "_fwd_bwd_seconds", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tuning.autotune_block(src, dst, None, num_nodes=N, dim=4, device="cpu",
                              candidates=((16, 32),))


def test_grid_and_random_search_run_the_port():
    logs = []
    with contextlib.redirect_stdout(io.StringIO()):
        best, results = tuning.grid_search(
            _cli_args(), {"lr": [1e-3, 1e-2], "num_neg": [1, 2]}, log=logs.append,
            device="cpu",
        )
    assert [(r["lr"], r["num_neg"]) for r in results] == [(1e-3, 1), (1e-3, 2), (1e-2, 1),
                                                         (1e-2, 2)]
    assert best == max(results, key=lambda r: r["valid"])
    assert {"valid", "valid_std", "test", "test_std"} <= set(best) and len(logs) == 5
    with pytest.raises(ValueError, match="unknown CLI flag"):
        tuning.grid_search(_cli_args(), {"not_a_flag": [1]}, log=None, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        best, results = tuning.random_search(
            _cli_args(), {"lr": [1e-3, 1e-2]}, num_trials=6, seed=1, log=None, device="cpu"
        )
    assert 1 <= len(results) <= 2 and len({r["lr"] for r in results}) == len(results)
    assert best == max(results, key=lambda r: r["valid"])
    with pytest.raises(ValueError, match="num_trials"):
        tuning.random_search(_cli_args(), {"lr": [1e-3]}, num_trials=0, log=None, device="cpu")
    with pytest.raises(ValueError, match="eval points"):
        tuning.grid_search(_cli_args(eval_steps=5), {"lr": [1e-3]}, log=None, device="cpu")
