"""Median latency of the window's ranking requests, host clock."""

import statistics


def read(r):
    lat = r["window"].get("latencies_ms")
    if lat is None or not len(lat):
        return None
    return statistics.median(lat)
