"""Build ``csrc/*.cu`` with ``nvcc`` for sm_90a and load them with ctypes.

Every source has a plain C interface (no PyTorch headers), so each builds
in seconds. All sources are compiled at first use, one ``nvcc`` process per
source, started together, into ``build/na_mpnn_tpu_torch/<hash>/`` at the
root of the checkout; the hash covers the sources and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "na_mpnn_tpu_torch"
SOURCES = ("knn", "rbf_classed", "rbf_classed_dw", "rbf_edge", "rbf_edge_dw",
           "message_table", "message_table_bwd", "message_mlp", "message_mlp_bwd",
           "fused_layers")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet, all in parallel.
    The compiler's report (registers, shared memory, spills) is kept beside
    each library as ``<name>.log``. Returns the build directory."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first use)."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}")
    return ctypes.CDLL(str(build_all() / f"lib{name}.so"))


def stream_ptr(device) -> ctypes.c_void_p:
    """The current PyTorch CUDA stream of ``device``, as a launcher argument."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
