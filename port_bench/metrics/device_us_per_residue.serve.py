"""Device time per served residue: the card's busy time in the profiled
slice (the union of its operations' intervals) over the residues of the
structures served in it, in microseconds. Read from the device's own
clock, so a slower host moves it only through what it launches."""
WRAPS = []


def read(run):
    prof = run.profile
    residues = sum(r["residues"] for r in run.profiled if r["ok"])
    if prof is None or prof.busy_s <= 0 or not residues:
        return None
    return 1e6 * prof.busy_s / residues
