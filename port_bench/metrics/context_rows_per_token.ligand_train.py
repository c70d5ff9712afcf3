"""Atom-pair rows the context features build per unpadded token: the
program's count ``rows`` of ``features.context`` (batch x padded length x
25 x 25) over the window's steps, against their unpadded residues. A dense
implementation reads 625 times the padded share; rows built for padded
residues or padded atom slots raise it."""
from port_bench import program_trace

WRAPS = []


def read(run):
    spans, count = program_trace.within(run, "train.step", "features.context")
    tokens = sum(r["tokens"] for r in run.requests if r["ok"])
    rows = sum(r.counts.get("rows", 0) for r in spans)
    if not count or not rows or not tokens:
        return None
    return rows / tokens
