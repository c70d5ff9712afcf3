"""Share of the profiled slice in which no operation ran on the card (the
union of the device operations' intervals against the slice)."""
WRAPS = []


def read(run):
    prof = run.profile
    if prof is None or prof.window_s <= 0 or prof.busy_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
