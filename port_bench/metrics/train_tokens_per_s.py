"""Unpadded residue tokens of every training step completed in the window,
per second of the window."""
WRAPS = []


def read(run):
    return sum(r["tokens"] for r in run.requests if r["ok"]) / run.window_s
