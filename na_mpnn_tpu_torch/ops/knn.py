"""Masked exact k-nearest-neighbour graph: CUDA kernel ``csrc/knn.cu`` and
its plain PyTorch version, in two forms.

``knn_graph`` replaces ``na_mpnn_tpu/ops/knn.py::knn_graph_pallas`` (the L
rows of each structure against each other); ``knn_graph_qk`` replaces
``knn_graph_pallas_qk`` (Lq query rows against Lk key rows, the
graph-parallel forward's shard against the gathered structure). Invalid
pairs get the row max over the keys added, ties go to the lowest key index,
and the outputs are sorted ascending: the contract of ``lax.top_k(-D)``.
The kernel runs one warp per query row (the source's header); it takes any
``Lk``, streaming the keys through shared memory in tiles where they do not
fit, and any ``k <= Lk``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, check_operand, raise_on_error


def masked_distances(X_q, X_k, mask_q, mask_k, eps=1e-6):
    """The ``[B,Lq,Lk]`` matrix the k smallest are taken from: masked
    distances with the row max added to invalid pairs. The squared distance
    is summed as ``(dx*dx + dy*dy) + dz*dz``, the order the kernel
    follows."""
    mask_q, mask_k = mask_q.to(X_q.dtype), mask_k.to(X_q.dtype)
    mask_2d = mask_k[:, None, :] * mask_q[:, :, None]
    dX = X_q[:, :, None, :] - X_k[:, None, :, :]
    d2 = dX[..., 0] * dX[..., 0] + dX[..., 1] * dX[..., 1]
    d2 = d2 + dX[..., 2] * dX[..., 2]
    D = mask_2d * torch.sqrt(d2 + eps)
    D_max = D.amax(dim=-1, keepdim=True)
    return D + (1.0 - mask_2d) * D_max


def knn_graph_qk_plain(X_q, X_k, mask_q, mask_k, k, eps=1e-6):
    """``X_q [B,Lq,3]``, ``X_k [B,Lk,3]``, ``mask_q [B,Lq]``, ``mask_k
    [B,Lk]`` -> (``D_neighbors [B,Lq,k]`` ascending, ``E_idx [B,Lq,k]``
    int64 key indices), ``k = min(k, Lk)``."""
    D_adjust = masked_distances(X_q, X_k, mask_q, mask_k, eps)
    k = min(k, X_k.shape[1])
    vals, idx = torch.sort(D_adjust, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def knn_graph_plain(X_ref, mask, k, eps=1e-6):
    """``X_ref [B,L,3]``, ``mask [B,L]`` -> (``D_neighbors [B,L,k]``
    ascending, ``E_idx [B,L,k]`` int64): the query/key form with the keys
    equal to the queries."""
    return knn_graph_qk_plain(X_ref, X_ref, mask, mask, k, eps)


@functools.cache
def _entry(entry):
    """The ctypes function of ``knn_forward`` or ``knn_qk_forward``, its
    argument types set once."""
    from ._build import library

    if entry == "knn":
        fn = library("knn").knn_forward
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_float] + [ctypes.c_void_p] * 3)
    else:
        fn = library("knn").knn_qk_forward
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def _launch(entry, X_q, X_k, mask_q, mask_k, k, eps):
    from ._build import stream_ptr

    B, Lq, _ = X_q.shape
    Lk = X_k.shape[1]
    check_operand(X_q, "X_q", torch.float32, (B, Lq, 3))
    check_operand(mask_q, "mask_q", torch.float32, (B, Lq))
    if entry == "knn_qk":
        check_operand(X_k, "X_k", torch.float32, (B, Lk, 3))
        check_operand(mask_k, "mask_k", torch.float32, (B, Lk))
    k = min(k, Lk)
    D = torch.empty((B, Lq, k), dtype=torch.float32, device=X_q.device)
    E_idx = torch.empty((B, Lq, k), dtype=torch.int64, device=X_q.device)
    if entry == "knn":
        args = (X_q.data_ptr(), mask_q.data_ptr(), B, Lq, k)
    else:
        args = (X_q.data_ptr(), mask_q.data_ptr(), X_k.data_ptr(),
                mask_k.data_ptr(), B, Lq, Lk, k)
    err = _entry(entry)(*args, eps, D.data_ptr(), E_idx.data_ptr(),
                        stream_ptr(X_q.device))
    raise_on_error(err, entry)
    LAUNCHES[entry] += 1
    return D, E_idx


def knn_graph_cuda(X_ref, mask, k, eps=1e-6):
    """Launch ``knn_forward`` of ``csrc/knn.cu`` on fp32 CUDA tensors (the
    contract of ``knn_graph_plain``)."""
    return _launch("knn", X_ref, X_ref, mask, mask, k, eps)


def knn_graph_qk_cuda(X_q, X_k, mask_q, mask_k, k, eps=1e-6):
    """Launch ``knn_qk_forward`` of ``csrc/knn.cu`` on fp32 CUDA tensors (the
    contract of ``knn_graph_qk_plain``)."""
    return _launch("knn_qk", X_q, X_k, mask_q, mask_k, k, eps)


def knn_graph(X_ref, mask, k, eps=1e-6):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if X_ref.is_cuda:
        return knn_graph_cuda(X_ref, mask, k, eps)
    return knn_graph_plain(X_ref, mask, k, eps)


def knn_graph_qk(X_q, X_k, mask_q, mask_k, k, eps=1e-6):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if X_q.is_cuda:
        return knn_graph_qk_cuda(X_q, X_k, mask_q, mask_k, k, eps)
    return knn_graph_qk_plain(X_q, X_k, mask_q, mask_k, k, eps)
