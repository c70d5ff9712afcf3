"""Rows the encoder ran (the ``rows`` of ``model.encode`` spans) per
structure served (``cli.structure``) in the window's requests. One would do for every
mode: the structure is the same in every row. A count from the program's
own spans (``program_trace``)."""
from port_bench import program_trace

WRAPS = []


def read(run):
    spans, _ = program_trace.within(run, "cli.call", "cli.structure", "model.encode")
    structures = sum(r.name == "cli.structure" for r in spans)
    rows = sum(r.counts["rows"] for r in spans if r.name == "model.encode")
    if not structures or not rows:
        return None
    return rows / structures
