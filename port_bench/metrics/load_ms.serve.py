"""Milliseconds a CLI request spends loading (``cli.load``: arguments,
mode defaults, folders, the checkpoint, the bias and omit specs), averaged
over the window's requests (``cli.call``). Host time, from the program's
own spans (``program_trace``)."""
from port_bench import program_trace

WRAPS = []


def read(run):
    return program_trace.ms_per(run, ["cli.load"], "cli.call")
