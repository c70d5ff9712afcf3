"""Seconds from the process's start to the first timed request."""
WRAPS = []


def read(run):
    return run.setup_s
