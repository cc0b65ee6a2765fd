"""The readers of the port's spans and counters: each reads the spans of
the traced window's first pass, the one that traces the device alone,
chosen by that pass's host seconds, and reports nothing where the port
records nothing."""

import pytest

from h100_bench import manifest, spans
from plnlp_tpu_torch import serve
from plnlp_tpu_torch.profiling import Span

BASE = 1_000_000_000


def _s(name, sid, parent, root, a_us, b_us):
    return Span(name, sid, parent, root, BASE + int(a_us * 1000), BASE + int(b_us * 1000))


def _passes(root, children, passes=2, n=2):
    """``passes`` passes 1 s apart of ``n`` roots each, the second pass's
    children twice as long; each root 10 ms, its children as ``(name,
    ms)``."""
    out, sid = [], 1
    for p in range(passes):
        for i in range(n):
            t0 = (p * 1000 + i * 20) * 1000.0
            rid = sid
            out.append(_s(root, rid, None, rid, t0, t0 + 10_000))
            sid += 1
            at = t0
            for name, ms in children:
                dur = ms * 1000 * (1 + p)
                out.append(_s(name, sid, rid, rid, at, at + dur))
                sid += 1
                at += dur
    return out


RANK = [("serve.rank.prep", 1), ("serve.rank.copy_out", 2), ("serve.rank.copy_out", 1)]
TRACE = {"host_s": 0.05, "busy_s": 0.01, "window_s": 0.02}  # the first pass: 50 ms


def _reader(name, monkeypatch, recorded):
    monkeypatch.setattr(spans, "port_spans", lambda: recorded)
    return manifest.metric_reader(name)


def test_first_pass_by_the_pass_host_seconds():
    rec = _passes("serve.rank", RANK)
    first = [s for s in rec if s.t0_ns < BASE + 10**9]
    assert spans.first_pass(rec, 0.05) == first
    assert spans.first_pass(list(reversed(rec)), 0.05) == list(reversed(first))
    one = _passes("serve.rank", RANK, passes=1)  # a window traced once
    assert spans.first_pass(one, 0.05) == one
    assert spans.first_pass([], 0.05) == [] and spans.first_pass(None, 0.05) == []


@pytest.mark.parametrize("passes", [1, 2])
def test_rank_readers_take_the_first_pass(monkeypatch, passes):
    rec = _passes("serve.rank", RANK, passes=passes)
    rows = spans.per_root(spans.first_pass(rec, TRACE["host_s"]), "serve.rank")
    assert rows == [{"serve.rank": 10**7, "serve.rank.prep": 10**6,
                     "serve.rank.copy_out": 3 * 10**6}] * 2
    assert _reader("rank_host_ms", monkeypatch, rec)({"trace": TRACE}) == pytest.approx(7.0)
    assert _reader("rank_wait_ms", monkeypatch, rec)({"trace": TRACE}) == pytest.approx(3.0)


@pytest.mark.parametrize("name", ["rank_host_ms", "rank_wait_ms"])
@pytest.mark.parametrize("recorded", [None, [], "untraced"])
def test_span_readers_report_nothing_without_spans(monkeypatch, name, recorded):
    if recorded == "untraced":  # spans, but the run traced no window
        read = _reader(name, monkeypatch, _passes("serve.rank", RANK))
        assert read({"trace": None}) is None
        return
    read = _reader(name, monkeypatch, recorded)
    assert read({"trace": TRACE}) is None


def test_h2d_reader_per_request(monkeypatch):
    read = manifest.metric_reader("rank_h2d_kb")
    monkeypatch.setattr(serve, "REQUESTS", 4)
    monkeypatch.setattr(serve, "H2D_BYTES", 4 * 1_890_000)
    assert read({}) == pytest.approx(1890.0)
    monkeypatch.setattr(serve, "REQUESTS", 0)
    assert read({}) is None
    monkeypatch.delattr(serve, "H2D_BYTES")
    monkeypatch.setattr(serve, "REQUESTS", 4)
    assert read({}) is None
