"""The 95th percentile of the wall time of a structure, over every
structure of the window (a failed request counts as missing it)."""
import math
import statistics

WRAPS = []


def read(run):
    times = [(r["t1"] - r["t0"]) if r["ok"] else math.inf for r in run.requests]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20)[18]
