"""Observability: throughput counters and profiler hooks (port of
plnlp_tpu/profiling.py).

A per-epoch throughput meter (aggregated edges/s through the encoder
forward and backward), a JSON-lines metrics sink, and a ``torch.profiler``
capture that exports a Chrome trace (viewable in Perfetto or
chrome://tracing) with a summary of its device time by kernel name.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import time
from typing import Dict, List, Optional

__all__ = [
    "ThroughputMeter",
    "MetricsWriter",
    "profile_trace",
    "summarize_trace",
]

# Chrome-trace categories of the device's own work in a torch.profiler
# export: kernels, copies and memsets (not the host-side runtime calls)
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class ThroughputMeter:
    """Aggregated-edges/s for the full-graph-encoder-per-batch train loop.

    Per epoch the encoder runs forward and backward over ALL edges once
    per pair batch (reference model.py:150-151 inside the loop), so
        agg_edges = num_batches × num_edges × gnn_layers × 2.

    ``last_edges_per_sec`` counts EXECUTED work (the padded final batch
    runs a full-graph encoder pass too); ``last_useful_edges_per_sec``
    discounts it by the share of real (unmasked) pairs.  ``stop`` reads
    the host clock: call it after something has waited for the device
    (``Model.train_epoch`` returns a Python float, which does).
    """

    def __init__(self, num_edges: int, gnn_layers: int, batch_size: int):
        self.num_edges = num_edges
        self.gnn_layers = gnn_layers
        self.batch_size = batch_size
        self._t0: Optional[float] = None
        self.last_edges_per_sec = 0.0
        self.last_useful_edges_per_sec = 0.0
        self.last_pairs_per_sec = 0.0

    def start(self):
        self._t0 = time.time()

    def stop(self, num_pos: int) -> float:
        dt = max(time.time() - self._t0, 1e-9)
        num_batches = max(1, math.ceil(num_pos / self.batch_size))
        agg_edges = num_batches * self.num_edges * self.gnn_layers * 2
        useful_frac = num_pos / max(num_batches * self.batch_size, 1)
        self.last_edges_per_sec = agg_edges / dt
        self.last_useful_edges_per_sec = agg_edges * useful_frac / dt
        self.last_pairs_per_sec = num_pos / dt
        return dt


class MetricsWriter:
    """Append-only JSON-lines metrics file (one dict per line)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, **metrics):
        if not self.path:
            return
        metrics.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(metrics) + "\n")


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (host and, where a GPU is
    present, CUDA activity) and export a Chrome trace
    ``<log_dir>/plnlp_<pid>_<ns>.pt.trace.json``; no-op when ``log_dir``
    is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"plnlp_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    )


def summarize_trace(log_dir: str, top: Optional[int] = 20) -> List[Dict]:
    """Device time by name from the newest :func:`profile_trace` export.

    Sums the trace's kernel, memcpy and memset events (categories
    ``kernel``, ``gpu_memcpy``, ``gpu_memset``) by name and returns the
    ``top`` rows (all with ``top=None``) by total time::

        [{"name", "count", "total_ms", "mean_ms"}, ...]

    Host events (Python frames, CUDA runtime calls) are not counted, so a
    trace of a CPU-only run gives ``[]``.  Raises FileNotFoundError when
    ``log_dir`` holds no trace.
    """
    traces = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.trace.json"), recursive=True),
        key=os.path.getmtime,
    )
    if not traces:
        raise FileNotFoundError(f"no *.trace.json under {log_dir}")
    with open(traces[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    agg: Dict[str, Dict] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATEGORIES:
            continue
        name = e.get("name", "?")
        row = agg.setdefault(name, {"name": name, "count": 0, "total_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += float(e.get("dur", 0)) / 1e3
    rows = sorted(agg.values(), key=lambda r: -r["total_ms"])[:top]
    for r in rows:
        r["mean_ms"] = r["total_ms"] / max(r["count"], 1)
    return rows
