"""Hand-written CUDA kernels of the port (``csrc/*.cu``) and their wrappers.

Each wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version of the same function (in the same module) for CPU tensors.
``LAUNCHES`` counts kernel launches by name, so that a run can show which
kernels its path went through. A wrapper runs its host work, from the
operand checks to the return, inside ``launch(name)``, which counts the
launch when the body returns and marks it as the span ``kernel.<name>``
(``trace.py``). ``LAUNCHES`` is global state of the package, as are the
tracer's flag and buffer.
"""
from __future__ import annotations

import collections

from .. import trace

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches():
    LAUNCHES.clear()


class launch:
    """``with launch(name):`` around a wrapper's body: the span
    ``kernel.<name>`` over it, and one more launch of ``name`` in
    ``LAUNCHES`` once it returns without raising."""

    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name = name
        self.span = trace.span("kernel." + name)

    def __enter__(self):
        self.span.__enter__()

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        if exc[0] is None:
            LAUNCHES[self.name] += 1
        return False


def check_operand(t, name, dtype, shape=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where given): the kernels take nothing else."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def check_aligned(t, name, nbytes=16):
    """Raise unless ``t`` starts on an ``nbytes`` boundary (a kernel that
    reads its rows as vectors; a view at an odd offset would fault)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: expected a {nbytes}-byte aligned start")


def raise_on_error(code: int, kernel: str):
    """Raise for a nonzero ``cudaError_t`` returned by a launcher."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {code}")


# The wrappers import ``models.modules``, whose package imports the model,
# which imports the wrappers: load the model package first, so that a
# wrapper module imported on its own finds its siblings complete.
from .. import models  # noqa: E402,F401
