"""Device time per trained token: the card's busy time in the profiled
slice (the union of its operations' intervals) over the unpadded tokens of
the steps run in it, in microseconds. Read from the device's own clock, so
a slower host moves it only through what it launches."""
WRAPS = []


def read(run):
    prof = run.profile
    tokens = sum(r["tokens"] for r in run.profiled if r["ok"])
    if prof is None or prof.busy_s <= 0 or not tokens:
        return None
    return 1e6 * prof.busy_s / tokens
