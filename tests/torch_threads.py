"""Importing this module gives torch one share of the machine's cores in
each pytest-xdist worker: ``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT``
intra-op threads (at least one). Left alone, every worker (and every
process it spawns) starts a thread per core, and with six workers on eight
cores the spinning OpenMP threads slow the port's tests several times over.
A run without xdist keeps torch's default. The port's test files import
it; the thread count changes no result a test holds (the tests compare
within one process, or against JAX at stated tolerances)."""
import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
