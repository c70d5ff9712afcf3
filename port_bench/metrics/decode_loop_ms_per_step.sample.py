"""Milliseconds of one step of the sampler's decode loop: the time in
``sample.decode`` spans (the step loop alone, without the encoder and the
per-layer statics before it) over the steps they ran (their ``steps``
count), in the window's requests. Host time, from the program's own spans
(``program_trace``); the loop does not wait for the card within a step."""
from port_bench import program_trace

WRAPS = []


def read(run):
    spans, _ = program_trace.within(run, "cli.call", "sample.decode")
    steps = sum(r.counts["steps"] for r in spans)
    if not steps:
        return None
    return 1e3 * sum(r.t1 - r.t0 for r in spans) / steps
