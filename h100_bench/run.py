"""One run of one cell: set-up, the measured window, optionally a traced
window, the check against the plain reference, one result line.

    python -m h100_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Exits 2, printing no result, without a
CUDA device or with fewer than the cell asks for, for an unknown cell, or
when JAX or the JAX package is loaded once the window has closed.  The
check's numbers, each beside its limit, are the last lines on standard
error and the last key of the result line.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "plnlp_tpu")


def forbidden_modules(names=None):
    """Top-level names among ``names`` (default: the loaded modules) that
    the port must not pull in, compared whole (``plnlp_tpu_torch`` is not
    ``plnlp_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(prog="h100_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _metric(value, unit):
    return {"value": value, "unit": unit}


def end_to_end(spec, run, setup_s):
    values = {"setup_s": setup_s, **run.end_to_end()}
    return {
        m["name"]: _metric(values[m["name"]], m["unit"]) for m in spec["end_to_end"]
        if m["name"] in values
    }


def per_layer(spec, readings):
    from h100_bench import manifest

    out = {}
    for m in spec["per_layer"]:
        value = manifest.metric_reader(m["name"])(readings)
        if value is not None and math.isfinite(value):
            out[m["name"]] = _metric(value, m["unit"])
    return out


def execute(spec, seed: int, seconds: float, traced: bool, device, started: float = 0.0):
    """Set-up, the window, the traced window where asked, the check.
    Returns the result (without ``device``), the run and the checks."""
    import torch

    from h100_bench import manifest, trace

    on_card = device.type == "cuda"
    run = manifest.kind(spec["traffic"]["kind"]).Run(spec, seed, device)
    run.readings["setup"]["start_s"] = started
    run.setup()
    setup_s = time.perf_counter() - T_START
    run.readings["setup"]["setup_s"] = setup_s

    run.window(seconds)
    if on_card:
        torch.cuda.synchronize(device)
        run.readings["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    tr = trace.capture(run.trace_work, device) if traced else None
    run.readings["trace"] = tr

    checks = run.check()
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
    if traced:
        metrics = per_layer(spec, run.layer_readings())
    else:
        metrics = end_to_end(spec, run, setup_s)
    result = {
        "correct": correct,
        "attempted": int(run.readings["window"]["calls"]),
        "failed": 0,
        "metrics": metrics,
    }
    return result, run, checks


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from h100_bench import manifest, peaks

    root = Path.cwd()
    try:
        spec = manifest.cell(root, args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"h100_bench: no cell {args.workload!r} ({e})", file=sys.stderr)
        return 2
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.init()
    torch.empty(1, device=device)
    result, run, checks = execute(
        spec, args.seed, args.seconds, bool(args.trace), device, time.perf_counter() - T_START
    )
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: loaded {bad}: the port must not load JAX or the JAX package",
              file=sys.stderr)
        return 2
    tr = run.readings["trace"]
    result["device"] = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": chips,
        "memory_peak_bytes": run.readings["memory_peak_bytes"],
    }
    if tr is not None:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    window = run.readings["window"]
    print(json.dumps({
        "h100_bench": args.workload, "seed": args.seed, "power_limit": peaks.power_limit(),
        "window": {k: v for k, v in window.items() if k != "latencies_ms"},
        "setup": run.readings["setup"], "k1": run.readings.get("k1"),
        **{k: run.readings[k] for k in ("reference_mrr", "checked_requests")
           if k in run.readings},
    }, default=float))
    result["check"] = {c["name"]: [c["value"], c["limit"]] for c in checks}
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"check correct = {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
