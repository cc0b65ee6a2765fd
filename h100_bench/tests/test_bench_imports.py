"""Nothing the harness loads pulls in JAX or the JAX package, compared by
whole top-level names."""

import subprocess
import sys

from h100_bench import run
from h100_bench.tests.small import ROOT

_LOAD_ALL = """
import json, sys
sys.argv = ['x']
from pathlib import Path
from h100_bench import control, manifest, run
import plnlp_tpu_torch.cli, plnlp_tpu_torch.serve, plnlp_tpu_torch.training
root = Path('.')
for w in manifest.load_benchmark(root)['workloads']:
    spec = manifest.cell(root, w['name'])
    manifest.kind(spec['traffic']['kind'])
    manifest.reference(spec['config']['reference'])
    for m in spec['per_layer']:
        manifest.metric_reader(m['name'])
print(json.dumps(run.forbidden_modules()))
"""


def test_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _LOAD_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_names_compared_whole():
    assert run.forbidden_modules(["plnlp_tpu_torch", "plnlp_tpu_torch.ops", "jaxtyping"]) == []
    assert run.forbidden_modules(["plnlp_tpu.ops", "jax.numpy", "flax"]) == ["flax", "jax", "plnlp_tpu"]
