"""Class-specialised all-pair-atom RBF edge features fused with their
projection: CUDA kernel ``csrc/rbf_classed.cu``; its plain PyTorch version
is the dense ``all_pair_rbf(...) @ W``.

Replaces ``na_mpnn_tpu/ops/rbf_classed.py::rbf_edge_features_classed``
(forward) and its query/key entry ``rbf_edge_features_classed_qk`` (the
graph-parallel forward: a shard's query rows against the all-gathered
structure's key rows; one kernel, which takes the key rows as their own
operand). The 18 augmented atom slots split into the protein block P (N, CA,
C, O, virtual Cb) and the nucleic block N (12 backbone atoms + virtual
base-N); the host permutes them (``PERM``) so each block is contiguous, and
the reference-order ``[18*18*16, H]`` weight splits into one table per
(query block, neighbour block) group (``split_weight_tables``).

The weight gradient is ``csrc/rbf_classed_dw.cu`` (replaces
``_classed_dw``), which writes the reference-order ``[5184, H]`` gradient
directly. The plain versions are the dense ones of ``ops/rbf_edge.py``, and
the projection is its ``RbfProjection`` Function (a gradient for ``W``
only: coordinates and masks are structural, as in the JAX package,
``rbf_classed.py:592-596``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import LAUNCHES, check_operand, raise_on_error
from .rbf_edge import (A, NUM_RBF, RbfProjection, edge_operands,
                       rbf_edge_dw_plain, rbf_edge_features_plain)

P_SEL = (0, 1, 2, 3, 16)                                  # N, CA, C, O, vCb
N_SEL = (4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 17)    # NA backbone + vN
GROUP_SELS = [(P_SEL, P_SEL), (P_SEL, N_SEL), (N_SEL, P_SEL), (N_SEL, N_SEL)]
PERM = list(P_SEL) + list(N_SEL)


def group_rows(num_rbf=NUM_RBF):
    """Row indices (into the reference ``[A*A*R, H]`` weight) of each
    group's table, in kernel order ``r*(Aq*An) + qpos*An + npos``."""
    rows = []
    for selq, seln in GROUP_SELS:
        Aq, An = len(selq), len(seln)
        r, q, n = np.meshgrid(np.arange(num_rbf), np.arange(Aq), np.arange(An),
                              indexing="ij")
        a = np.asarray(selq)[q]
        b = np.asarray(seln)[n]
        rows.append(((a * A + b) * num_rbf + r).reshape(-1))
    return rows


@functools.cache
def _group_index(device):
    return [torch.as_tensor(r, dtype=torch.int64, device=device)
            for r in group_rows()]


def split_weight_tables(W):
    """Reference-order ``[A*A*R, H]`` weight -> the 4 kernel-order tables."""
    return [W.index_select(0, r) for r in _group_index(W.device)]


@functools.cache
def _row_map(device):
    """Kernel-order row -> reference row, the four tables one after another."""
    return torch.cat(_group_index(device))


# The class split changes the work, not the function: the plain versions
# are the dense ones (``ops/rbf_edge.py``).
rbf_edge_features_classed_plain = rbf_edge_features_plain
rbf_classed_dw_plain = rbf_edge_dw_plain


def rbf_classed_dw_cuda(X_aug, X_m_aug, E_idx, g, X_aug_k=None, X_m_k=None):
    """Launch ``csrc/rbf_classed_dw.cu`` on fp32 CUDA tensors (same contract
    as ``rbf_classed_dw_plain``)."""
    from ._build import library, ptr, stream_ptr

    B, L, K = E_idx.shape
    H = g.shape[-1]
    E = B * L * K
    Xq, Mq, Xk, Mk, nbr = edge_operands(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k,
                                        PERM)
    g = g.reshape(E, H)
    check_operand(g, "g", torch.float32, (E, H))
    dev = X_aug.device
    lib = library("rbf_classed_dw")
    lib.rbf_classed_dw_splits.restype = ctypes.c_int
    splits = lib.rbf_classed_dw_splits()
    rows = A * A * NUM_RBF
    code = torch.empty(((E + 31) // 32,), dtype=torch.int32, device=dev)
    part = torch.empty((splits, rows, H), dtype=torch.float32, device=dev)
    dW = torch.empty((rows, H), dtype=torch.float32, device=dev)
    fn = lib.rbf_classed_dw
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    err = fn(ptr(Xq), ptr(Mq), ptr(Xk), ptr(Mk), ptr(nbr), ptr(g),
             ptr(_row_map(dev)), E, K, H, ptr(code), ptr(part), ptr(dW),
             stream_ptr(dev))
    raise_on_error(err, "rbf_classed_dw")
    LAUNCHES["rbf_classed_dw"] += 1
    return dW


def rbf_edge_features_classed_cuda(X_aug, X_m_aug, E_idx, W, X_aug_k=None,
                                   X_m_k=None):
    """Launch ``csrc/rbf_classed.cu`` on fp32 CUDA tensors (same contract)."""
    from ._build import library, ptr, stream_ptr

    B, L, K = E_idx.shape
    H = W.shape[1]
    Xq, Mq, Xk, Mk, nbr = edge_operands(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k,
                                        PERM)
    check_operand(W, "W", torch.float32, (A * A * NUM_RBF, H))
    tables = split_weight_tables(W)
    E = B * L * K
    out = torch.empty((E, H), dtype=torch.float32, device=X_aug.device)
    fn = library("rbf_classed").rbf_classed_forward
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    err = fn(ptr(Xq), ptr(Mq), ptr(Xk), ptr(Mk), ptr(nbr), E, K, H,
             *[ptr(t) for t in tables], ptr(out), stream_ptr(X_aug.device))
    raise_on_error(err, "rbf_classed")
    LAUNCHES["rbf_classed"] += 1
    return out.view(B, L, K, H)


_KERNELS = (rbf_edge_features_classed_cuda, rbf_classed_dw_cuda)


def rbf_edge_features_classed(X_aug, X_m_aug, E_idx, W):
    """``[B,L,18,3]`` coords + ``[B,L,18]`` masks + ``[B,L,K]`` neighbours +
    reference-order ``[5184, H]`` weight -> ``[B,L,K,H]``. Kernel for CUDA
    tensors, plain version for CPU tensors; differentiable in ``W``."""
    return RbfProjection.apply(_KERNELS, X_aug, X_m_aug, X_aug, X_m_aug, E_idx, W)


def rbf_edge_features_classed_qk(X_aug_q, X_m_q, X_aug_k, X_m_k, E_idx, W):
    """Query/key form: query rows ``[B,Lq,18,3]`` and ``[B,Lq,18]``, key rows
    ``[B,Lk,18,3]`` and ``[B,Lk,18]``, ``E_idx [B,Lq,K]`` key indices ->
    ``[B,Lq,K,H]``. The same kernels as ``rbf_edge_features_classed``."""
    return RbfProjection.apply(_KERNELS, X_aug_q, X_m_q, X_aug_k, X_m_k, E_idx, W)
