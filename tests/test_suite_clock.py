"""The root conftest.py's pieces: a test's time limit, and the xdist
scheduler that spreads the long-pole files' cases over the workers."""

import importlib.util
import re
import signal
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("suite_clock", ROOT / "conftest.py")
clock = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(clock)

SLOW = "tests/test_p.py::test_slowest"
POLES = (SLOW, "tests/test_q.py", "tests/test_p.py")
IDS = [
    "tests/test_a.py::test_one",
    "tests/test_a.py::test_two[1]",
    "tests/test_p.py::test_case[0]",
    SLOW,
    "tests/test_p.py::test_case[1]",
    "tests/test_q.py::test_other",
    "tests/test_b.py::Suite::test_three",
]


class _Node:
    """What the scheduler calls on an xdist worker."""

    def __init__(self, name):
        self.gateway = SimpleNamespace(id=name)
        self.sent = []
        self.shutting_down = False

    def send_runtest_some(self, indices):
        self.sent.extend(IDS[i] for i in indices)

    def shutdown(self):
        self.shutting_down = True


@pytest.fixture
def scheduled(monkeypatch):
    """A scheduler over ``IDS`` with ``POLES`` as the long poles, and its
    two workers, once the first units are sent."""
    monkeypatch.setattr(clock, "LONG_POLES", POLES)
    config = SimpleNamespace(getvalue=lambda name: ["2*popen"],
                             option=SimpleNamespace(dist="loadfile", loadscopereorder=True))
    sched = clock.pytest_xdist_make_scheduler(config, None)
    nodes = [_Node("gw0"), _Node("gw1")]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, IDS)
    sched.schedule()
    return sched, nodes


def test_soft_limit_fails_a_slow_body_with_its_node_id():
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match=r"tests/test_x\.py::test_slow ran past the 0\.2-s limit"):
        with clock.time_limit("tests/test_x.py::test_slow", soft_s=0.2, hard_s=30):
            time.sleep(2)
    assert time.monotonic() - start < 1.5
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_body_in_time_passes_and_disarms_the_alarm():
    before = signal.getsignal(signal.SIGALRM)
    with clock.time_limit("tests/test_x.py::test_quick", soft_s=0.5, hard_s=30):
        time.sleep(0.05)
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    assert signal.getsignal(signal.SIGALRM) is before
    time.sleep(0.6)  # an alarm left armed would fail the test here


def test_long_pole_cases_are_units_of_their_own(scheduled):
    sched, _ = scheduled
    assert {nodeid: sched._split_scope(nodeid) for nodeid in IDS} == {
        "tests/test_a.py::test_one": "tests/test_a.py",
        "tests/test_a.py::test_two[1]": "tests/test_a.py",
        "tests/test_p.py::test_case[0]": "tests/test_p.py::test_case[0]",
        SLOW: SLOW,
        "tests/test_p.py::test_case[1]": "tests/test_p.py::test_case[1]",
        "tests/test_q.py::test_other": "tests/test_q.py::test_other",
        "tests/test_b.py::Suite::test_three": "tests/test_b.py",
    }


def test_long_pole_cases_are_queued_first_in_list_order(scheduled):
    sched, (a, b) = scheduled
    assert a.sent == [SLOW, "tests/test_p.py::test_case[0]"]
    assert b.sent == ["tests/test_q.py::test_other", "tests/test_p.py::test_case[1]"]
    assert list(sched.workqueue) == ["tests/test_a.py", "tests/test_b.py"]


def test_crashed_case_runs_once_and_the_rest_is_queued_again(scheduled):
    sched, (a, b) = scheduled
    assert sched.remove_node(a) == SLOW
    for nodeid in b.sent:  # b is sent more as it completes
        sched.mark_test_complete(b, IDS.index(nodeid))
    assert sorted(b.sent) == sorted(set(IDS) - {SLOW})
    assert sched.tests_finished and not sched.workqueue


def test_scheduler_only_replaces_loadfile():
    for dist in ("load", "loadscope", "loadgroup", "worksteal", "each", "no"):
        assert clock.pytest_xdist_make_scheduler(
            SimpleNamespace(option=SimpleNamespace(dist=dist)), None) is None


def test_long_poles_exist():
    assert clock.LONG_POLES
    for entry in clock.LONG_POLES:
        path, _, name = entry.partition("::")
        assert path.startswith("tests/test_") and (ROOT / path).is_file(), entry
        if name:
            assert re.search(rf"^def {re.escape(name)}\(", (ROOT / path).read_text(), re.M), entry
