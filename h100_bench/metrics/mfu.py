"""The whole step's share of the peak (``mfu.train``, ``mfu.rank``,
``mfu.eval``): the window's products (``flops.py``: GEMMs, aggregations,
predictor products of the work the window completed) over its host-clock
seconds and the H100's float32 peak, in percent."""

from h100_bench import peaks


def read(r):
    w = r["window"]
    if not w.get("flop") or w["seconds"] <= 0:
        return None
    return 100.0 * w["flop"] / w["seconds"] / peaks.FLOP_PER_S["float32"]
