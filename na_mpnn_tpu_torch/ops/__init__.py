"""Hand-written CUDA kernels of the port (``csrc/*.cu``) and their wrappers.

Each wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version of the same function (in the same module) for CPU tensors.
``LAUNCHES`` counts kernel launches by name, so that a run can show which
kernels its path went through; it is the package's only global state.
"""
from __future__ import annotations

import collections

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches():
    LAUNCHES.clear()


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
