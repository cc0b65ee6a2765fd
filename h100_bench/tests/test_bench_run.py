"""The entry: without a card it exits 2 and prints no result; on a card
(marked ``cuda``) a short run of the cheapest cell prints one."""

import json
import subprocess
import sys

import pytest
import torch

from h100_bench.tests.small import ROOT

_CMD = [sys.executable, "-m", "h100_bench", "--workload", "collab-sage-dot.train",
        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(_CMD, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""


def test_unknown_cell_no_result():
    cmd = _CMD[:4] + ["no-such-cell"] + _CMD[5:]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(_CMD, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", "train_pairs_per_s"}
    assert list(result)[-1] == "check"
