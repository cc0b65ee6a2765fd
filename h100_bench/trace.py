"""A traced window: ``torch.profiler`` over a fixed piece of work, read
back from its Chrome-trace export.

The work runs twice.  The first pass traces the device alone, so that the
profiler adds little host time between launches: its busy time (the union
of the device's kernel, copy and memset intervals), its window (from a
marker launched before the work to one launched after it) and its device
time by op name (as the port's ``profiling.summarize_trace`` reads it) are
the readings.  The second pass traces the host's ops too, only to name
the idle gaps by the innermost host event running at each gap's middle
(what the host was doing while the card waited); the profiler's own host
cost stretches that pass's gaps, so their lengths are not the first
pass's.  Each export goes to a temporary directory under ``TMPDIR`` and is
deleted once read.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Callable, Dict, List

import torch

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "h100_bench.traced_window"
_NAME = 160  # characters of an op's name kept (C++ template names run to thousands)


def _events(prof, tmp: str, name: str) -> List[Dict]:
    path = os.path.join(tmp, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def capture(work: Callable[[], None], device) -> Dict:
    """Run ``work`` under the profiler, twice; returns the trace's readings."""
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mark.add_(1)  # opens the window as the host starts the work
            work()
            mark.add_(1)  # closes it once the host has launched all of it
            torch.cuda.synchronize(device)
            host_s = time.perf_counter() - t0
        device_events = _events(prof, tmp, "device.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                work()
                torch.cuda.synchronize(device)
        host_events = _events(prof, tmp, "host.json")
    out = read(device_events)
    out["idle_gaps"] = idle_gaps(host_events)
    out["host_s"] = host_s
    return out


def _merge(intervals):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _span(e: Dict):
    a = float(e.get("ts", 0.0))
    return a, a + float(e.get("dur", 0.0))


def read(events: List[Dict], top: int = 10) -> Dict:
    """Busy and window seconds and device seconds by op name, from the
    device-only pass's Chrome-trace events (times in us); the window runs
    from the first device event's start to the last one's end."""
    spans, ops = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _DEVICE:
            a, b = _span(e)
            spans.append((a, b))
            name = e.get("name", "?")[:_NAME]
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    if not spans:
        raise ValueError("the trace holds no device operation")
    merged = _merge(spans)
    return {
        "busy_s": sum(b - a for a, b in merged) / 1e6,
        "window_s": (merged[-1][1] - merged[0][0]) / 1e6,
        "ops": ops,
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:top],
    }


def idle_gaps(events: List[Dict], top: int = 10) -> List:
    """The idle gaps inside the traced window's annotation, summed by the
    innermost host event running at each gap's middle, longest first."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no traced window")
    w0, w1 = _span(win[0])
    busy, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        a, b = _span(e)
        cat = e.get("cat")
        if cat in _DEVICE:
            lo, hi = max(a, w0), min(b, w1)
            if hi > lo:
                busy.append((lo, hi))
        elif cat in _HOST and e.get("name") != WINDOW:
            host.append((a, b, e.get("name", "?")[:_NAME]))
    merged = _merge(busy)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host.sort()
    starts = [h[0] for h in host]
    by_label: Dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = 0.5 * (a + b)
        label = "host: no traced op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 4000, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e6
    return sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
