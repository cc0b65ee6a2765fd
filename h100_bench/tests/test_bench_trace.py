"""The trace reader on hand-made Chrome-trace events: busy time is the
union of the device intervals, the window spans the first to the last of
them; gaps are named by the host event running at their middle."""

from h100_bench import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


DEVICE = [
    _x("mark", "kernel", 0, 2),         # 0-2, the window opens
    _x("k1", "kernel", 10, 20),         # 10-30
    _x("k2", "kernel", 20, 20),         # 20-40, overlaps k1
    _x("copy", "gpu_memcpy", 60, 10),   # 60-70
    _x("k1", "kernel", 95, 10),         # 95-105
    _x("mark", "kernel", 108, 2),       # 108-110, the window closes
    _x("cudaLaunchKernel", "cuda_runtime", 50, 5),  # host side: not device time
]


def test_busy_union_and_named_gaps():
    r = trace.read(DEVICE)
    assert abs(r["window_s"] - 110e-6) < 1e-12
    assert abs(r["busy_s"] - (2 + 30 + 10 + 10 + 2) * 1e-6) < 1e-12
    assert abs(dict(r["device_ops"])["k1"] - 30e-6) < 1e-12
    events = [
        _x(trace.WINDOW, "user_annotation", 0, 100),
        _x(trace.WINDOW, "gpu_user_annotation", 0, 100),
        _x("k1", "kernel", 10, 20),       # 10-30
        _x("k2", "kernel", 20, 20),       # 20-40, overlaps k1
        _x("copy", "gpu_memcpy", 60, 10),  # 60-70
        _x("k1", "kernel", 95, 10),       # 95-105, clipped at 100
        _x("aten::item", "cpu_op", 38, 24),
        _x("python_step", "user_annotation", 0, 100),
    ]
    gaps = dict(trace.idle_gaps(events))
    assert abs(gaps["aten::item"] - 20e-6) < 1e-12       # 40-60
    assert abs(gaps["python_step"] - (10 + 25) * 1e-6) < 1e-12  # 0-10, 70-95
