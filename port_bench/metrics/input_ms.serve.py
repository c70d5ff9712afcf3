"""Milliseconds a CLI request spends reading its structure (``cli.parse``:
the PDB parse and residue encoding) and featurising it (``cli.featurize``:
masks, features, bias, pair bias, score's tiling), averaged over the
window's requests (``cli.call``). Host time, from the program's own spans
(``program_trace``)."""
from port_bench import program_trace

WRAPS = []


def read(run):
    return program_trace.ms_per(run, ["cli.parse", "cli.featurize"], "cli.call")
