"""Residues of every structure completed in the window, per second of the
window."""
WRAPS = []


def read(run):
    return sum(r["residues"] for r in run.requests if r["ok"]) / run.window_s
