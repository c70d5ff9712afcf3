"""Milliseconds a training step spends in the forward and the loss
(``train.forward``: ``_log_probs``, ``mask_for_loss``, ``_loss``), averaged
over the window's steps (``train.step``). Host time, from the program's own
spans (``program_trace``): where the card sets the pace, the stage that
waits for it holds the wait."""
from port_bench import program_trace

WRAPS = []


def read(run):
    return program_trace.ms_per(run, ["train.forward"], "train.step")
