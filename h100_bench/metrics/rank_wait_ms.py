"""Time a ranking request's host waits on the card (``rank_wait_ms``): the
median, over the requests of the traced window's device-only pass
(``spans.first_pass``), of the summed ``serve.rank.copy_out`` spans (each
chunk's blocking copies out), in ms.  None where the port records no
spans."""

import statistics

from h100_bench import spans


def read(r):
    t = r.get("trace")
    if not t:
        return None
    rows = spans.per_root(spans.first_pass(spans.port_spans(), t["host_s"]), "serve.rank")
    if not rows:
        return None
    return statistics.median(x.get("serve.rank.copy_out", 0) / 1e6 for x in rows)
