"""K1 (``ops/scatter_matmul``: ``scatter_runs_kernel`` and
``scatter_carries_kernel``, either dtype) against its bound: the least time
of the traced window's launches, each the larger of its FLOP and its bytes
over the H100's peaks (``flops.aggregation``: x read once, the real edges
once, out written once), over the device time of K1's kernels in the
trace, in percent."""

_NAMES = ("scatter_runs", "scatter_carries")


def read(r):
    t, k1 = r.get("trace"), r.get("k1")
    if not t or not k1 or not k1["launches"]:
        return None
    spent = sum(s for name, s in t["ops"].items() if any(n in name for n in _NAMES))
    if spent <= 0:
        return None
    return 100.0 * k1["bound_s"] / spent
