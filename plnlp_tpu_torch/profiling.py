"""Observability: throughput counters and profiler hooks (port of
plnlp_tpu/profiling.py).

A per-epoch throughput meter (aggregated edges/s through the encoder
forward and backward), a JSON-lines metrics sink, a ``torch.profiler``
capture that exports a Chrome trace (viewable in Perfetto or
chrome://tracing) with a summary of its device time by kernel name, and
an in-memory recorder of named spans over the port's phases.

Spans (:func:`span`) are recorded while the recorder is on
(:func:`tracing`) or while a ``torch.profiler`` session is recording,
so that any profile of the port names its phases; otherwise a span costs
two checks and allocates nothing.  A recorded span is a :class:`Span`
whose times come from ``time.time_ns()``, the clock of the profiler's
Chrome-trace export (``baseTimeNanoseconds + ts * 1000``), so a span's
interval lies straight over the device ops of a trace taken at the same
time.  While a profiler records, a span also enters torch's record
function, so a profiler that traces the host exports it by name (a
``cpu_op``, or a ``user_annotation`` where torch has no C++ record
function).  The recorder keeps one stack of open spans (spans nest on one
thread) and the closed ones until :func:`drain`, at most :data:`MAX_SPANS`
of them, the newest.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import math
import os
import time
from typing import Deque, Dict, List, NamedTuple, Optional

import torch

__all__ = [
    "ThroughputMeter",
    "MetricsWriter",
    "profile_trace",
    "summarize_trace",
    "Span",
    "span",
    "MAX_SPANS",
    "tracing",
    "spans",
    "drain",
    "self_ns",
    "span_table",
    "write_spans",
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


# -- spans ------------------------------------------------------------------


class Span(NamedTuple):
    """One recorded span: ``parent_id`` is None for a root, ``root_id`` is
    the id of the outermost span open around it (its own for a root)."""

    name: str
    span_id: int
    parent_id: Optional[int]
    root_id: int
    t0_ns: int
    t1_ns: int


# Closed spans kept until drained; past this many the oldest go, so a
# process that is profiled again and again without a drain stays bounded
MAX_SPANS = 1 << 18
_tracing = False
_records: Deque[Span] = collections.deque(maxlen=MAX_SPANS)
_stack: List[tuple] = []  # (span_id, root_id) of the open spans, innermost last
_ids = itertools.count(1)
_profiling = torch.autograd._profiler_enabled
# A span's event in the profiler's trace: torch's C++ record function where
# this build has it (a third of record_function's host cost under a
# profiler, which a traced run adds to its gaps), exported as a ``cpu_op``
_annotation = getattr(torch._C._profiler, "_RecordFunctionFast", None) or (
    torch.profiler.record_function
)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "ids", "t0", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        span_id = next(_ids)
        parent, root = _stack[-1] if _stack else (None, span_id)
        self.ids = (span_id, parent, root)
        _stack.append((span_id, root))
        self.t0 = time.time_ns()
        self.annotation = _annotation(self.name) if _profiling() else None
        if self.annotation is not None:
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        t1 = time.time_ns()
        _stack.pop()
        _records.append(Span(self.name, *self.ids, self.t0, t1))
        return False


def span(name: str):
    """A context manager that records ``name`` over its block while the
    recorder is on or a profiler records, and does nothing otherwise (the
    same shared object comes back)."""
    if not (_tracing or _profiling()):
        return _NO_SPAN
    return _OpenSpan(name)


@contextlib.contextmanager
def tracing(on: bool = True):
    """The recorder on (or off) over the block, as it was after it (spans
    are recorded under a profiler either way)."""
    global _tracing
    was, _tracing = _tracing, bool(on)
    try:
        yield
    finally:
        _tracing = was


def spans() -> List[Span]:
    """The closed spans recorded so far (at most :data:`MAX_SPANS`, the
    newest), in the order they closed."""
    return list(_records)


def drain() -> List[Span]:
    """:func:`spans`, and forget them."""
    out = spans()
    _records.clear()
    return out


def self_ns(recorded: List[Span]) -> Dict[int, int]:
    """Each span's self time by id: its duration minus the part of it that
    its children cover (children on one thread do not overlap)."""
    out = {s.span_id: s.t1_ns - s.t0_ns for s in recorded}
    for s in recorded:
        if s.parent_id in out:
            out[s.parent_id] -= s.t1_ns - s.t0_ns
    return out


def span_table(recorded: List[Span], top: Optional[int] = 20) -> List[Dict]:
    """Spans summed by name, the most self time first::

        [{"name", "count", "total_ms", "self_ms"}, ...]
    """
    own = self_ns(recorded)
    agg: Dict[str, Dict] = {}
    for s in recorded:
        row = agg.setdefault(s.name, {"name": s.name, "count": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += (s.t1_ns - s.t0_ns) / 1e6
        row["self_ms"] += own[s.span_id] / 1e6
    return sorted(agg.values(), key=lambda r: -r["self_ms"])[:top]


def write_spans(path: str, recorded: List[Span]) -> None:
    """The spans as a JSON list of objects (:class:`Span`'s fields)."""
    with open(path, "w") as f:
        json.dump([s._asdict() for s in recorded], f)
