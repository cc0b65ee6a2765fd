"""Multi-run result tracking (port of plnlp_tpu/logger.py; reference
plnlp/logger.py:6-49 semantics).

Records (valid, test) per eval point per run; model selection is
test-at-argmax-valid, with the ``last_best`` variant picking the LAST argmax
(needed for ogbl-collab where valid saturates at 100.00 —
reference logger.py:19-22,36-39).  Pure NumPy, no device involvement.
"""

from __future__ import annotations

import sys
from typing import Optional, TextIO, Tuple

import numpy as np

__all__ = ["Logger"]


def _argmax_valid(valid: np.ndarray, last_best: bool) -> int:
    if last_best:
        return len(valid) - 1 - int(np.argmax(valid[::-1]))
    return int(np.argmax(valid))


class Logger:
    def __init__(self, runs: int, info=None):
        self.info = info
        self.results = [[] for _ in range(runs)]

    def add_result(self, run: int, result: Tuple[float, float]) -> None:
        if len(result) != 2:
            raise ValueError(f"result must be (valid, test), got {result!r}")
        if not 0 <= run < len(self.results):
            raise IndexError(f"run {run} outside [0, {len(self.results)})")
        self.results[run].append(tuple(float(x) for x in result))

    def best(self, run: int, last_best: bool = False) -> Tuple[float, float, int]:
        """(highest valid, test at that eval point, argmax index) — ×100."""
        if not self.results[run]:  # no eval points (epochs < eval_steps)
            return float("nan"), float("nan"), -1
        r = 100 * np.asarray(self.results[run])
        idx = _argmax_valid(r[:, 0], last_best)
        return float(r[:, 0].max()), float(r[idx, 1]), idx

    def summary(self, last_best: bool = False):
        """Across runs: (valid mean, valid std, test mean, test std) — ×100."""
        best = []
        for r in self.results:
            if not r:
                continue
            a = 100 * np.asarray(r)
            idx = _argmax_valid(a[:, 0], last_best)
            best.append((float(a[:, 0].max()), float(a[idx, 1])))
        if not best:  # no eval points recorded (epochs < eval_steps)
            return float("nan"), 0.0, float("nan"), 0.0
        b = np.asarray(best)
        # ddof=1 matches torch.std (reference logger.py:45-48)
        std = b.std(axis=0, ddof=1) if len(b) > 1 else np.zeros(2)
        return b[:, 0].mean(), std[0], b[:, 1].mean(), std[1]

    def print_statistics(
        self,
        run: Optional[int] = None,
        f: Optional[TextIO] = None,
        last_best: bool = False,
    ) -> None:
        if f is None:
            # resolve at CALL time so contextlib.redirect_stdout works (a
            # def-time sys.stdout default would pin the original stream)
            f = sys.stdout
        if run is not None:
            hv, test, idx = self.best(run, last_best)
            print(f"Run {run + 1:02d}:", file=f)
            print(f"Highest Valid: {hv:.2f}", file=f)
            print(f"Highest Eval Point: {idx + 1}", file=f)
            print(f"   Final Test: {test:.2f}", file=f)
        else:
            vm, vs, tm, ts = self.summary(last_best)
            print("All runs:", file=f)
            print(f"Highest Valid: {vm:.2f}  {vs:.2f}", file=f)
            print(f"   Final Test: {tm:.2f}  {ts:.2f}", file=f)
