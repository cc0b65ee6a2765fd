"""How the test run is spread over xdist's workers, and the time limit of a test.

The tier-1 run is ``pytest tests/ -n 6 --dist loadfile``.  ``loadfile`` gives
each file to one worker whole, so a file's cases run one after another on one
core and the run lasts at least as long as its longest file.  The files in
``LONG_POLES`` are those whose cases alone sum to more than a third of the
run: under ``loadfile`` each of their cases is a unit of work of its own,
queued before every whole file, so that all the workers share them.  The
slowest case goes first, so that it does not start late and end the run.
The files hold no module- or session-scoped fixture, so a case runs the same
on any worker; what their cases no longer share is JAX's compile cache in
the worker's process.

Every phase of a test (set-up, call, teardown) runs under two limits.  At
``SOFT_LIMIT_S`` an alarm fails the case with its node id.  At
``HARD_LIMIT_S`` faulthandler prints every thread's stack and ends the
process, for a case stuck in C (an XLA compile, a gloo wait) where the
alarm's Python handler never runs; under xdist the case is reported as
failed, a new worker takes the old one's place, and the run goes on.
"""

import contextlib
import faulthandler
import os
import signal

import pytest

# Queued first, in this order, each of their cases a unit of its own: an
# entry is a file or one case's node id.  Summed case seconds in the 6-worker
# tier-1 run on an 8-core host (JAX on the CPU) while each file still ran
# whole on one worker (2,100 s in all), and in two runs once spread (772 and
# 933 s, the slowest case last in both):
LONG_POLES = (
    # the slowest case: 304 s, then 337 and 397 s
    "tests/test_graph_parallel.py::test_tiled_partitioned_transformer_extremes",
    "tests/test_graph_parallel.py",  # 1,421 s; 1,563 and 1,868 s: 50 cases
    "tests/test_fuzz_parity.py",  # 2,072 s; 1,282 and 1,338 s: 17 cases
    "tests/test_cli.py",  # 374 s; 314 and 418 s: 62 cases
)

# About twice the slowest phase of a case in those runs (397 s).
SOFT_LIMIT_S = 800
HARD_LIMIT_S = SOFT_LIMIT_S + 60

_STDERR = pytest.StashKey[int]()


def _pole(nodeid):
    """The index of the first entry of ``LONG_POLES`` that names ``nodeid``
    or its file, or None."""
    path = nodeid.split("::", 1)[0]
    return next((i for i, e in enumerate(LONG_POLES) if e in (nodeid, path)), None)


def long_pole_scheduling():
    """xdist's ``LoadFileScheduling`` with the long poles' cases split out and
    queued first (imported here: xdist is only needed when ``-n`` is given)."""
    from xdist.scheduler import LoadFileScheduling

    class LongPoleScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return nodeid if _pole(nodeid) is not None else nodeid.split("::", 1)[0]

        def _assign_work_unit(self, node):
            # The long poles' cases go before every whole file, in
            # LONG_POLES's order.
            split = sorted((s for s in self.workqueue if "::" in s), key=_pole)
            for scope in reversed(split):
                self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

        def remove_node(self, node):
            # xdist's own puts the crashed case back in the queue with the
            # rest of its worker's units, finished ones included, so the next
            # worker would crash on it too.  Here it runs once, and only what
            # is left to run goes back in the queue.
            workload = self.assigned_work.pop(node)
            left = [n for unit in workload.values() for n, done in unit.items() if not done]
            if not left:
                return None
            workload[self._split_scope(left[0])][left[0]] = True
            self.workqueue.update(
                (scope, unit) for scope, unit in workload.items() if not all(unit.values()))
            for other in self.assigned_work:
                self._reschedule(other)
            return left[0]

    return LongPoleScheduling


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.option.dist == "loadfile":
        return long_pole_scheduling()(config, log)
    return None


@contextlib.contextmanager
def time_limit(nodeid, soft_s=SOFT_LIMIT_S, hard_s=HARD_LIMIT_S, stderr=2):
    """Fail ``nodeid`` after ``soft_s`` seconds; end the process after
    ``hard_s``, printing every thread's stack to the descriptor ``stderr``."""

    def alarm(signum, frame):
        pytest.fail(f"{nodeid} ran past the {soft_s:g}-s limit of a test phase")

    previous = signal.signal(signal.SIGALRM, alarm)
    signal.setitimer(signal.ITIMER_REAL, soft_s)
    faulthandler.dump_traceback_later(hard_s, exit=True, file=stderr)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def pytest_configure(config):
    # The stderr of the process, kept before a test's output capture
    # redirects descriptor 2.
    config.stash[_STDERR] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])


def _limited(item):
    return time_limit(item.nodeid, stderr=item.config.stash[_STDERR])


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _limited(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _limited(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _limited(item):
        return (yield)
