"""Milliseconds of host work a training step spends in the kernel wrappers:
the time in ``kernel.<launch>`` spans (a wrapper's body from its operand
checks to its return, the launch call included; those of the backward on
autograd's thread too) per training step (``train.step``) of the window.
Host time, from the program's own spans (``program_trace``)."""
from port_bench import program_trace

WRAPS = []


def read(run):
    return program_trace.ms_per(run, ["kernel."], "train.step")
