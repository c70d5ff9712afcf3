"""Share of the sampler's decode steps that ran as a replay of the step's
CUDA graph: the ``replayed`` count of ``sample.decode`` spans over their
``steps`` count, in the window's requests. A count from the program's own
spans (``program_trace``), known on the host from L and the steps run
before the capture, so it never waits for the card. A program whose decode
spans count no ``replayed`` records nothing for it, and the reader reads
None."""
from port_bench import program_trace

WRAPS = []


def read(run):
    spans, _ = program_trace.within(run, "cli.call", "sample.decode")
    spans = [r for r in spans if "replayed" in r.counts]
    steps = sum(r.counts["steps"] for r in spans)
    if not steps:
        return None
    return sum(r.counts["replayed"] for r in spans) / steps
