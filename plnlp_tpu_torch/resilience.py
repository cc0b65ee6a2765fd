"""Failure recovery: restart-and-resume supervision for long runs (port
of plnlp_tpu/resilience.py).

The reference has no failure handling: a crashed run loses everything but
its text log (reference main.py:100-103).  The CLI checkpoints parameters,
optimizer state and Logger progress (``--checkpoint_dir`` + ``--resume``);
this module closes the loop with a supervisor that reruns a crashed
experiment from its latest checkpoint, bounding lost work to
``--checkpoint_every`` epochs, and a guard that turns SIGTERM (a
scheduler's preemption notice) into a checkpoint at the epoch's end and
exit code 75::

    from plnlp_tpu_torch.resilience import run_resilient
    loggers = run_resilient(args, max_restarts=5)
"""

from __future__ import annotations

import functools
import signal
import threading
import time
from typing import Callable, Optional

__all__ = ["run_resilient", "Preempted", "PreemptionGuard"]


class Preempted(SystemExit):
    """Clean early exit after a preemption signal.

    Subclasses SystemExit with code 75 (EX_TEMPFAIL) so schedulers can
    distinguish "relaunch me with --resume" from success (0) and failure
    (1) — and so ``run_resilient``'s ``except Exception`` does NOT swallow
    it: restarting in-process on a machine that is being reclaimed would
    burn the preemption grace period for nothing.
    """

    def __init__(self, run: int, epoch: int):
        super().__init__(75)
        self.run = run
        self.epoch = epoch


class PreemptionGuard:
    """Converts SIGTERM (the preemption notice schedulers deliver at the
    start of the grace window) into a cooperative flag
    the epoch loop checks at its boundaries, where state is consistent and
    cheap to checkpoint.  The reference loses the whole run on any kill
    (reference main.py:100-103 persists only a text log).

    Signal handlers may only be installed from the main thread; anywhere
    else (e.g. a test runner worker) the guard degrades to inactive and
    ``preempted`` simply stays False.  The previous handlers are restored
    on exit so library callers (pytest, notebooks) are left untouched.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._saved = {}
        self.preempted = False
        self.signum: Optional[int] = None
        self.active = False

    def _handler(self, signum, frame):
        self.preempted = True
        self.signum = signum

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            try:
                for s in self._signals:
                    self._saved[s] = signal.signal(s, self._handler)
                self.active = True
            except ValueError:  # pragma: no cover - non-main interpreter
                # Partial install: put back any handlers already swapped so
                # the guard never leaks past a failed __enter__.
                for s, old in self._saved.items():
                    signal.signal(s, old)
                self._saved.clear()
        return self

    def __exit__(self, *exc) -> bool:
        for s, old in self._saved.items():
            signal.signal(s, old)
        self._saved.clear()
        self.active = False
        return False


def run_resilient(
    args,
    max_restarts: int = 3,
    backoff_seconds: float = 10.0,
    log: Callable = print,
    device=None,
    _run=None,
):
    """run_experiment with automatic restart-from-checkpoint on failure.

    Requires ``args.checkpoint_dir`` (otherwise a restart would replay from
    scratch, which silently duplicates work — refused instead).  After the
    first failure ``args.resume`` is forced on so every retry continues from
    the latest checkpoint.  KeyboardInterrupt is never retried.  ``device``
    goes to ``run_experiment``; ``_run(args, log=...)`` replaces it.
    """
    from plnlp_tpu_torch.cli import run_experiment

    run = _run or functools.partial(run_experiment, device=device)
    if not getattr(args, "checkpoint_dir", ""):
        raise ValueError(
            "run_resilient needs args.checkpoint_dir — without checkpoints a "
            "restart replays the whole run from scratch"
        )
    attempt = 0
    last_err: Optional[BaseException] = None
    while attempt <= max_restarts:
        try:
            return run(args, log=log)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — supervisor boundary
            last_err = e
            attempt += 1
            if attempt > max_restarts:
                break
            log(
                f"run failed ({type(e).__name__}: {e}); restart "
                f"{attempt}/{max_restarts} from latest checkpoint in "
                f"{backoff_seconds:.0f}s"
            )
            args.resume = True
            time.sleep(backoff_seconds)
    raise RuntimeError(
        f"experiment failed after {max_restarts} restarts"
    ) from last_err
