"""The port's own spans (``plnlp_tpu_torch.profiling.span``), as the
readers of the per-layer metrics that come from spans take them.

The port records a span whenever a profiler records, so the traced window
(``trace.py``) records the spans of each of its passes.  The readers take
those of the pass that traces the device alone, the first: the spans that
open within its host seconds (``host_s``) of the first span's open.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def port_spans() -> Optional[List]:
    """The spans the port has recorded so far, or None where the port has
    no recorder."""
    from plnlp_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def first_pass(recorded, host_s: float) -> List:
    """The spans of the traced window's first pass: those that open within
    ``host_s`` seconds (the pass's length on the host clock, from before
    its work starts to after the device has finished it) of the earliest
    open among ``recorded``.  A later pass opens its spans after the first
    pass's trace has been exported, so none of them falls inside."""
    if not recorded:
        return []
    t0 = min(s.t0_ns for s in recorded)
    return [s for s in recorded if s.t0_ns - t0 <= host_s * 1e9]


def per_root(recorded, root: str) -> List[Dict]:
    """For each root named ``root`` among ``recorded``: its duration and
    the summed duration of each child name under it, in ns."""
    out: Dict[int, Dict] = {}
    for s in recorded:
        if s.name == root and s.parent_id is None:
            out.setdefault(s.span_id, {})[root] = s.t1_ns - s.t0_ns
    for s in recorded:
        if s.root_id in out and s.span_id != s.root_id:
            row = out[s.root_id]
            row[s.name] = row.get(s.name, 0) + s.t1_ns - s.t0_ns
    return [row for row in out.values() if root in row]
