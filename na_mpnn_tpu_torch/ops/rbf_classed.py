"""Class-specialised all-pair-atom RBF edge features fused with their
projection: CUDA kernel ``csrc/rbf_classed.cu`` and its plain PyTorch
version (the dense ``all_pair_rbf(...) @ W``).

Replaces ``na_mpnn_tpu/ops/rbf_classed.py::rbf_edge_features_classed``
(forward). The 18 augmented atom slots split into the protein block P (N, CA,
C, O, virtual Cb) and the nucleic block N (12 backbone atoms + virtual
base-N); the host permutes them (``PERM``) so each block is contiguous, and
the reference-order ``[18*18*16, H]`` weight splits into one table per
(query block, neighbour block) group (``split_weight_tables``).

The weight gradient is ``csrc/rbf_classed_dw.cu`` (replaces
``_classed_dw``), which writes the reference-order ``[5184, H]`` gradient
directly; ``rbf_classed_dw_plain`` is its plain version. The projection is a
``torch.autograd.Function`` with a gradient for ``W`` only: coordinates and
masks are structural, as in the JAX package (``rbf_classed.py:592-596``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import LAUNCHES, check_operand, raise_on_error

A = 18
NUM_RBF = 16

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


def rbf_edge_features_classed_plain(X_aug, X_m_aug, E_idx, W):
    """Dense semantic reference: ``all_pair_rbf(X_aug, E_idx, X_m_aug) @ W``
    -> ``[B,L,K,H]``."""
    from ..models.features import all_pair_rbf
    return all_pair_rbf(X_aug, E_idx, X_m_aug, NUM_RBF) @ W


def rbf_classed_dw_plain(X_aug, X_m_aug, E_idx, g):
    """Plain version of the weight-gradient kernel: the cotangent ``g``
    ``[B,L,K,H]`` of the projection -> ``all_pair_rbf(...)^T @ g``, the
    reference-order ``[A*A*R, H]`` gradient of ``W``."""
    from ..models.features import all_pair_rbf
    H = g.shape[-1]
    rbf = all_pair_rbf(X_aug, E_idx, X_m_aug, NUM_RBF)
    return rbf.reshape(-1, rbf.shape[-1]).T @ g.reshape(-1, H)


def _operands(X_aug, X_m_aug, E_idx):
    """Check the kernels' common operands and lay them out: node rows in
    PERM order ``[x-plane | y-plane | z-plane]`` ``[B*L, 54]``, their masks
    ``[B*L, 18]`` and the flat neighbour row of every edge ``[E]``."""
    from ..models.modules import flat_rows

    B, L, A_, _ = X_aug.shape
    K = E_idx.shape[2]
    if A_ != A:
        raise ValueError(f"rbf kernel: needs the {A}-atom frame, got {A_}")
    check_operand(X_aug, "X_aug", torch.float32, (B, L, A, 3))
    check_operand(X_m_aug, "X_m_aug", torch.float32, (B, L, A))
    check_operand(E_idx, "E_idx", torch.int64, (B, L, K))
    perm = torch.as_tensor(PERM, device=X_aug.device)
    Xq = X_aug[:, :, perm, :].permute(0, 1, 3, 2).reshape(B * L, 3 * A)
    Mq = X_m_aug[:, :, perm].reshape(B * L, A)
    nbr = flat_rows(E_idx, L).reshape(-1)
    return Xq.contiguous(), Mq.contiguous(), nbr.contiguous()


def rbf_classed_dw_cuda(X_aug, X_m_aug, E_idx, g):
    """Launch ``csrc/rbf_classed_dw.cu`` on fp32 CUDA tensors (same contract
    as ``rbf_classed_dw_plain``)."""
    from ._build import library, ptr, stream_ptr

    B, L, K = E_idx.shape
    H = g.shape[-1]
    E = B * L * K
    Xq, Mq, nbr = _operands(X_aug, X_m_aug, E_idx)
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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    err = fn(ptr(Xq), ptr(Mq), ptr(nbr), ptr(g), ptr(_row_map(dev)), E, K, H,
             ptr(code), ptr(part), ptr(dW), stream_ptr(dev))
    raise_on_error(err, "rbf_classed_dw")
    LAUNCHES["rbf_classed_dw"] += 1
    return dW


def rbf_edge_features_classed_cuda(X_aug, X_m_aug, E_idx, W):
    """Launch ``csrc/rbf_classed.cu`` on fp32 CUDA tensors (same contract)."""
    from ._build import library, ptr, stream_ptr

    B, L, _, _ = X_aug.shape
    K = E_idx.shape[2]
    H = W.shape[1]
    Xq, Mq, nbr = _operands(X_aug, X_m_aug, E_idx)
    check_operand(W, "W", torch.float32, (A * A * NUM_RBF, H))
    tables = split_weight_tables(W)
    E = B * L * K
    out = torch.empty((E, H), dtype=torch.float32, device=X_aug.device)
    fn = library("rbf_classed").rbf_classed_forward
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    err = fn(ptr(Xq), ptr(Mq), ptr(nbr), E, K, H, *[ptr(t) for t in tables],
             ptr(out), stream_ptr(X_aug.device))
    raise_on_error(err, "rbf_classed")
    LAUNCHES["rbf_classed"] += 1
    return out.view(B, L, K, H)


class _RbfClassed(torch.autograd.Function):
    """The projection with its weight-gradient kernel (plain versions on the
    CPU); no gradient to coordinates, masks or neighbours."""

    @staticmethod
    def forward(ctx, X_aug, X_m_aug, E_idx, W):
        ctx.save_for_backward(X_aug, X_m_aug, E_idx)
        if X_aug.is_cuda:
            return rbf_edge_features_classed_cuda(X_aug, X_m_aug, E_idx, W)
        return rbf_edge_features_classed_plain(X_aug, X_m_aug, E_idx, W)

    @staticmethod
    def backward(ctx, g):
        X_aug, X_m_aug, E_idx = ctx.saved_tensors
        fn = rbf_classed_dw_cuda if g.is_cuda else rbf_classed_dw_plain
        return None, None, None, fn(X_aug, X_m_aug, E_idx, g.contiguous())


def rbf_edge_features_classed(X_aug, X_m_aug, E_idx, W):
    """``[B,L,18,3]`` coords + ``[B,L,18]`` masks + ``[B,L,K]`` neighbours +
    reference-order ``[5184, H]`` weight -> ``[B,L,K,H]``. Kernel for CUDA
    tensors, plain version for CPU tensors; differentiable in ``W``."""
    return _RbfClassed.apply(X_aug, X_m_aug, E_idx, W)
