"""Milliseconds a CLI request spends writing its backbone PDB files
(``cli.pdbs``, inside ``cli.outputs``: one template of the structure's
fixed columns, then each sample's file), averaged over the window's
requests (``cli.call``). Host time, from the program's own spans
(``program_trace``); None where the program has no such span."""
from port_bench import program_trace

WRAPS = []


def read(run):
    return program_trace.ms_per(run, ["cli.pdbs"], "cli.call")
