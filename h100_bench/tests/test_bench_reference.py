"""The plain reference against the port's CPU path at a tiny size: the
port as configured agrees to rounding; the port's bf16 path (the control)
fails at least one of the cell's limits; so does each fault a cell can
have."""

import math

import pytest
import torch

from h100_bench import control
from h100_bench.tests import small

CASES = [
    ("collab-sage-dot.train", ["program", "bf16", "half_batch", "unchanged"]),
    ("citation2-gcn.train", ["program", "bf16", "half_batch", "unchanged"]),
    ("collab-sage-dot.rank", ["program", "bf16", "answer_altered"]),
    ("citation2-gcn.eval", ["program", "bf16", "scores_altered"]),
]


def _fails(values, limits):
    return any(not math.isfinite(values[k]) or values[k] > lim for k, lim in limits.items())


@pytest.mark.parametrize("name,variants", CASES, ids=[c[0] for c in CASES])
def test_program_passes_control_and_faults_fail(name, variants):
    spec = small.spec(name, small.SCALES[name])
    limits = spec["limits"]["limits"]
    got = control.readings(spec, 2**31 + 21, variants, torch.device("cpu"), seconds=0.5)
    assert set(limits) <= set(got["program"])
    # at this size a leaf holds few elements, so rounding reads up to ~1e-3
    # where the card's size reads 1e-7 to 1e-4: the port is held to that,
    # the control and the faults to the cell's own limits
    assert all(got["program"][k] < max(lim, 1e-3) for k, lim in limits.items()), got["program"]
    for v in variants[1:]:
        assert _fails(got[v], limits), (v, got[v])


def test_a_run_of_a_cell_is_correct_on_the_cpu():
    run = small.run("collab-sage-dot.train", 0.01)
    run.setup()
    window = run.window(0.2)
    assert window["calls"] >= 1 and window["work"] > 0
    assert run.end_to_end()["train_pairs_per_s"] > 0
    checks = run.check()
    assert all(c["value"] <= c["limit"] for c in checks), checks
    r = run.layer_readings()
    assert r["window"]["flop"] > 0 and r["setup"]["prepare_s"] > 0
