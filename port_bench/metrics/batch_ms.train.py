"""Milliseconds a training step spends in the host batch's copy to the card
(``train.batch``: ``device_batch``), averaged over the window's steps
(``train.step``). Host time, from the program's own spans
(``program_trace``): where the card sets the pace, the stage that waits for
it holds the wait."""
from port_bench import program_trace

WRAPS = []


def read(run):
    return program_trace.ms_per(run, ["train.batch"], "train.step")
