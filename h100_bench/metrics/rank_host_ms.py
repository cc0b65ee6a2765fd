"""Host time of a ranking request (``rank_host_ms``): the median, over the
requests of the traced window's device-only pass (``spans.first_pass``),
of the port's ``serve.rank`` span less its ``serve.rank.copy_out`` spans,
in ms.  None where the port records no spans."""

import statistics

from h100_bench import spans


def read(r):
    t = r.get("trace")
    if not t:
        return None
    rows = spans.per_root(spans.first_pass(spans.port_spans(), t["host_s"]), "serve.rank")
    if not rows:
        return None
    return statistics.median((x["serve.rank"] - x.get("serve.rank.copy_out", 0)) / 1e6
                             for x in rows)
