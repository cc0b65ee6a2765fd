"""Share of the traced window in which no operation ran on the device
(``idle_share.train``, ``.rank``, ``.eval``): 1 - the union of the
device's kernel, copy and memset intervals over the window's length, from
the device-only trace (``trace.py``), in percent."""


def read(r):
    t = r.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
