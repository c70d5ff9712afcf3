"""Milliseconds a training step spends in LigandMPNN's context encoder's
forward: the program's spans ``features.context`` (the nearest atoms, the
context atoms' noise, the context features) and ``model.context`` (the 2+2
context layers), per training step (``train.step``) of the window. Host
time, from the program's own spans (``program_trace``): where the card sets
the pace, the stage that waits for it holds the wait."""
from port_bench import program_trace

WRAPS = []


def read(run):
    return program_trace.ms_per(run, ["features.context", "model.context"], "train.step")
