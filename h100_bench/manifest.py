"""Find a cell's pieces by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name, so that adding one
adds files and entries and edits none:

* a configuration: the ``file`` its ``configs`` entry names (a JSON object
  with ``model``, the CLI's flags; ``dataset``, the generator's counts;
  ``reference``, the module under ``refs/``);
* a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the
  module under ``kinds/`` that drives it;
* a cell's limits: ``cells/<workload>.json``;
* a per-layer metric: ``metrics/<name>.py``, whose ``read(r)`` returns the
  number or None; a metric split by cell (``idle_share.train``) without a
  file of its own is read by its quantity's reader (``idle_share.py``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> Dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: Dict, workload: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def cell(root: Path, name: str, bench_dir: Path = HERE) -> Dict:
    """The workload entry ``name`` with its configuration, traffic mix,
    limits and the metrics it reports; raises KeyError for an unknown name."""
    root = Path(root)
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return {
        "workload": work,
        "config": _load_json(root / conf_entry["file"]),
        "traffic": _load_json(bench_dir / "traffic" / f"{work['traffic']}.json"),
        "limits": _load_json(bench_dir / "cells" / f"{name}.json"),
        "end_to_end": e2e,
        "per_layer": per_layer,
        "run_seconds": bench["run_seconds"],
    }


def kind(name: str, bench_dir: Path = HERE):
    """The module under ``kinds/`` that drives a traffic mix of ``kind``."""
    return load_module(bench_dir / "kinds" / f"{name}.py", f"h100_bench_kind_{name}")


def reference(name: str, bench_dir: Path = HERE):
    return load_module(bench_dir / "refs" / f"{name}.py", f"h100_bench_ref_{name}")


def metric_reader(name: str, bench_dir: Path = HERE):
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench_dir / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, f"h100_bench_metric_{path.stem}").read
