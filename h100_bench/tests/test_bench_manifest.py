"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and entries, in a copy of the benchmark, with no file edited."""

import hashlib
import json
import shutil
from pathlib import Path

from h100_bench import manifest
from h100_bench.tests.small import ROOT


def _digests(root: Path):
    return {
        str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts
    }


def test_new_pieces_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "h100_bench"
    shutil.copytree(ROOT / "h100_bench", bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(bench_dir)

    cfg = json.loads((bench_dir / "configs" / "collab-sage-dot.json").read_text())
    cfg["name"] = "collab-sage-mlp"
    cfg["model"]["predictor"] = "MLP"
    (bench_dir / "configs" / "collab-sage-mlp.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "train-half-epochs.json").write_text(
        json.dumps({"kind": "train", "call_positives": 4096, "check_steps": 3}))
    (bench_dir / "cells" / "collab-sage-mlp.train.json").write_text(
        json.dumps({"limits": {"loss_gap": 1e-4}}))
    (bench_dir / "metrics" / "steps_per_s.py").write_text(
        "def read(r):\n    return r['window']['steps'] / r['window']['seconds']\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "collab-sage-mlp", "source": "x",
                             "file": "h100_bench/configs/collab-sage-mlp.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "collab-sage-mlp.train", "config": "collab-sage-mlp",
                               "traffic": "train-half-epochs", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "training step",
                               "moves": "train_pairs_per_s",
                               "workloads": ["collab-sage-mlp.train"]})
    bench["end_to_end"][1]["workloads"].append("collab-sage-mlp.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = manifest.cell(tmp_path, "collab-sage-mlp.train", bench_dir)
    assert spec["config"]["model"]["predictor"] == "MLP"
    assert spec["traffic"]["call_positives"] == 4096
    assert spec["limits"]["limits"] == {"loss_gap": 1e-4}
    assert [m["name"] for m in spec["end_to_end"]] == ["setup_s", "train_pairs_per_s"]
    assert [m["name"] for m in spec["per_layer"]] == ["prepare_s", "steps_per_s"]
    read = manifest.metric_reader("steps_per_s", bench_dir)
    assert read({"window": {"steps": 10, "seconds": 2.0}}) == 5.0
    assert manifest.kind("train", bench_dir).Run is not None
    # a quantity split by cell is read by its shared reader, unless the
    # split metric brings a file of its own
    shared = manifest.metric_reader("idle_share.new-cell", bench_dir)
    assert shared({"trace": {"busy_s": 3.0, "window_s": 4.0}}) == 25.0
    (bench_dir / "metrics" / "idle_share.new-cell.py").write_text("def read(r):\n    return 1.0\n")
    assert manifest.metric_reader("idle_share.new-cell", bench_dir)({}) == 1.0
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


def test_cells_of_the_benchmark_resolve():
    bench = manifest.load_benchmark(ROOT)
    for w in bench["workloads"]:
        spec = manifest.cell(ROOT, w["name"])
        reported = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec["per_layer"], w["name"]
        for m in spec["per_layer"]:
            assert m["moves"] in reported
            manifest.metric_reader(m["name"])
        assert spec["limits"]["limits"]
