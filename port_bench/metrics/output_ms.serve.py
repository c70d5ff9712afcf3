"""Milliseconds a CLI request spends after its model calls
(``cli.outputs``: copies to the host, scores, recovery, stats, PPM,
backbone PDBs, FASTA), averaged over the window's requests (``cli.call``).
Host time, from the program's own spans (``program_trace``): the first
copy to the host holds the wait for the card's queue."""
from port_bench import program_trace

WRAPS = []


def read(run):
    return program_trace.ms_per(run, ["cli.outputs"], "cli.call")
