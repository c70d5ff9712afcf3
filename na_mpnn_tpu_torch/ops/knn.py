"""Masked exact k-nearest-neighbour graph: CUDA kernel ``csrc/knn.cu`` and
its plain PyTorch version.

Replaces ``na_mpnn_tpu/ops/knn.py::knn_graph_pallas``. Invalid pairs get the
row max added, ties go to the lowest column index, and the outputs are
sorted ascending: the contract of ``lax.top_k(-D)``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_operand, raise_on_error

# Shared memory a block may use on Hopper; the kernel keeps one row of L
# distances there.
MAX_SHARED_BYTES = 232448


def knn_graph_plain(X_ref, mask, k, eps=1e-6):
    """``X_ref [B,L,3]``, ``mask [B,L]`` -> (``D_neighbors [B,L,k]``
    ascending, ``E_idx [B,L,k]`` int64). The squared distance is summed as
    ``(dx*dx + dy*dy) + dz*dz``, the order the kernel follows."""
    mask = mask.to(X_ref.dtype)
    mask_2d = mask[:, None, :] * mask[:, :, None]
    dX = X_ref[:, :, None, :] - X_ref[:, None, :, :]
    d2 = dX[..., 0] * dX[..., 0] + dX[..., 1] * dX[..., 1]
    d2 = d2 + dX[..., 2] * dX[..., 2]
    D = mask_2d * torch.sqrt(d2 + eps)
    D_max = D.amax(dim=-1, keepdim=True)
    D_adjust = D + (1.0 - mask_2d) * D_max
    k = min(k, X_ref.shape[1])
    vals, idx = torch.sort(D_adjust, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def knn_graph_cuda(X_ref, mask, k, eps=1e-6):
    """Launch ``csrc/knn.cu`` on fp32 CUDA tensors (same contract)."""
    from ._build import library, ptr, stream_ptr

    B, L, _ = X_ref.shape
    check_operand(X_ref, "X_ref", torch.float32, (B, L, 3))
    check_operand(mask, "mask", torch.float32, (B, L))
    if 4 * L > MAX_SHARED_BYTES:
        raise ValueError(f"knn kernel: L={L} rows exceed shared memory")
    k = min(k, L)
    D = torch.empty((B, L, k), dtype=torch.float32, device=X_ref.device)
    E_idx = torch.empty((B, L, k), dtype=torch.int64, device=X_ref.device)
    fn = library("knn").knn_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ptr(X_ref), ptr(mask), B, L, k, eps, ptr(D), ptr(E_idx),
             stream_ptr(X_ref.device))
    raise_on_error(err, "knn")
    LAUNCHES["knn"] += 1
    return D, E_idx


def knn_graph(X_ref, mask, k, eps=1e-6):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if X_ref.is_cuda:
        return knn_graph_cuda(X_ref, mask, k, eps)
    return knn_graph_plain(X_ref, mask, k, eps)
