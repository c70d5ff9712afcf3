"""Dense all-pair-atom RBF edge features fused with their projection
(``rbf_mode="dense"``): CUDA kernels ``csrc/rbf_edge.cu`` (forward) and
``csrc/rbf_edge_dw.cu`` (weight gradient) and their plain PyTorch versions.

Replaces ``na_mpnn_tpu/ops/rbf_edge.py::rbf_edge_embed`` and
``rbf_edge_embed_dw`` behind the custom VJP ``_rbf_proj``, at fp32 and in
their ``compute_dtype=bfloat16`` branch (``low=True``: each masked exact
bin rounded to bf16, times ``bf16(W)``, summed in fp32 into an fp32
``[E, H]``; the weight gradient sums ``bf16(bin) * bf16(g)`` in fp32; the
``*_bf16`` entries of the same sources, launches counted as
``rbf_edge_bf16`` / ``rbf_edge_dw_bf16``). The function is
``all_pair_rbf(...) @ W`` over the full 18×18 atom-pair × 16-bin grid, the
same function as the class-specialised kernel of ``ops/rbf_classed.py``,
which computes only the populated class blocks. ``W`` stays in the reference
row order ``(a*18 + b)*16 + r``: the TPU kernel's bin-major permutation of
the weight serves its one-hot expansion matmuls and is not carried over.

Each function takes query rows and, optionally, key rows (the graph-parallel
forward's shard against the all-gathered structure); ``E_idx`` indexes the
key rows. The projection is a ``torch.autograd.Function`` with a gradient for
``W`` only: coordinates and masks are structural, as in the JAX package
(``rbf_edge.py:246-252``).
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_operand, raise_on_error

A = 18                   # augmented atom slots
NUM_RBF = 16
ROWS = A * A * NUM_RBF   # 5184


def rbf_edge_features_plain(X_aug, X_m_aug, E_idx, W, X_aug_k=None,
                            X_m_k=None):
    """``all_pair_rbf(...) @ W`` -> ``[B,Lq,K,H]``."""
    from ..models.features import all_pair_rbf
    return all_pair_rbf(X_aug, E_idx, X_m_aug, NUM_RBF, X_aug_k, X_m_k) @ W


def rbf_edge_dw_plain(X_aug, X_m_aug, E_idx, g, X_aug_k=None, X_m_k=None):
    """Plain version of the weight-gradient kernel: the cotangent ``g``
    ``[B,Lq,K,H]`` -> ``all_pair_rbf(...)^T @ g`` ``[5184, H]``."""
    from ..models.features import all_pair_rbf
    rbf = all_pair_rbf(X_aug, E_idx, X_m_aug, NUM_RBF, X_aug_k, X_m_k)
    return rbf.reshape(-1, ROWS).T @ g.reshape(-1, g.shape[-1])


def rbf_edge_bf16_plain(X_aug, X_m_aug, E_idx, W, X_aug_k=None, X_m_k=None):
    """Plain version of the bf16 forward: the masked exact bins rounded to
    bf16, times ``bf16(W)``, summed in fp32 -> ``[B,Lq,K,H]`` fp32."""
    from ..models.features import all_pair_rbf
    bins = all_pair_rbf(X_aug, E_idx, X_m_aug, NUM_RBF, X_aug_k, X_m_k)
    return bins.to(torch.bfloat16).float() @ W.to(torch.bfloat16).float()


def rbf_edge_dw_bf16_plain(X_aug, X_m_aug, E_idx, g, X_aug_k=None, X_m_k=None):
    """Plain version of the bf16 weight gradient: ``bf16 bins^T @ bf16(g)``
    summed in fp32 -> ``[5184, H]`` fp32."""
    from ..models.features import all_pair_rbf
    rbf = all_pair_rbf(X_aug, E_idx, X_m_aug, NUM_RBF, X_aug_k, X_m_k)
    rbf = rbf.to(torch.bfloat16).float().reshape(-1, ROWS)
    return rbf.T @ g.reshape(-1, g.shape[-1]).to(torch.bfloat16).float()


def edge_operands(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k, perm):
    """Check the RBF kernels' operands and lay them out: query rows as
    ``[x-plane | y-plane | z-plane]`` ``[B*Lq, 54]`` with their masks
    ``[B*Lq, 18]``, the same of the key rows ``[B*Lk, ...]``, and the flat
    key row of every edge ``[E]``; atom slots in ``perm`` order (None: the
    reference order). Without key rows (None) the keys are the queries, and
    keys that are the query tensors are laid out once."""
    from ..models.modules import flat_rows

    if X_aug_k is None:
        X_aug_k, X_m_k = X_aug, X_m_aug
    B, Lq, A_, _ = X_aug.shape
    K = E_idx.shape[2]
    if A_ != A:
        raise ValueError(f"rbf kernel: needs the {A}-atom frame, got {A_}")
    check_operand(E_idx, "E_idx", torch.int64, (B, Lq, K))
    idx = None if perm is None else torch.as_tensor(perm, device=X_aug.device)

    def rows(X, M, name):
        L = X.shape[1]
        check_operand(X, f"X_aug{name}", torch.float32, (B, L, A, 3))
        check_operand(M, f"X_m{name}", torch.float32, (B, L, A))
        if idx is not None:
            X, M = X[:, :, idx, :], M[:, :, idx]
        return (X.permute(0, 1, 3, 2).reshape(B * L, 3 * A).contiguous(),
                M.reshape(B * L, A).contiguous())

    Xq, Mq = rows(X_aug, X_m_aug, "")
    Xk, Mk = ((Xq, Mq) if X_aug_k is X_aug and X_m_k is X_m_aug
              else rows(X_aug_k, X_m_k, "_k"))
    nbr = flat_rows(E_idx, X_aug_k.shape[1]).reshape(-1).contiguous()
    return Xq, Mq, Xk, Mk, nbr


def _forward_launch(symbol, X_aug, X_m_aug, E_idx, W, X_aug_k, X_m_k, name,
                    w_dtype):
    from ._build import library, ptr, stream_ptr

    B, L, K = E_idx.shape
    H = W.shape[1]
    Xq, Mq, Xk, Mk, nbr = edge_operands(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k,
                                        None)
    check_operand(W, "W", torch.float32, (ROWS, H))
    W = W.to(w_dtype).contiguous()
    E = B * L * K
    out = torch.empty((E, H), dtype=torch.float32, device=X_aug.device)
    fn = getattr(library("rbf_edge"), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    err = fn(ptr(Xq), ptr(Mq), ptr(Xk), ptr(Mk), ptr(nbr), E, K, H, ptr(W),
             ptr(out), stream_ptr(X_aug.device))
    raise_on_error(err, name)
    LAUNCHES[name] += 1
    return out.view(B, L, K, H)


def rbf_edge_cuda(X_aug, X_m_aug, E_idx, W, X_aug_k=None, X_m_k=None):
    """Launch ``csrc/rbf_edge.cu`` on fp32 CUDA tensors (the contract of
    ``rbf_edge_features_plain``)."""
    return _forward_launch("rbf_edge_forward", X_aug, X_m_aug, E_idx, W,
                           X_aug_k, X_m_k, "rbf_edge", torch.float32)


def rbf_edge_bf16_cuda(X_aug, X_m_aug, E_idx, W, X_aug_k=None, X_m_k=None):
    """Launch the bf16 entry of ``csrc/rbf_edge.cu`` (the contract of
    ``rbf_edge_bf16_plain``): the fp32 ``W`` is rounded to bf16 here."""
    return _forward_launch("rbf_edge_forward_bf16", X_aug, X_m_aug, E_idx, W,
                           X_aug_k, X_m_k, "rbf_edge_bf16", torch.bfloat16)


def _dw_launch(symbol, X_aug, X_m_aug, E_idx, g, X_aug_k, X_m_k, name):
    from ._build import library, ptr, stream_ptr

    B, L, K = E_idx.shape
    H = g.shape[-1]
    E = B * L * K
    Xq, Mq, Xk, Mk, nbr = edge_operands(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k,
                                        None)
    g = g.reshape(E, H)
    check_operand(g, "g", torch.float32, (E, H))
    lib = library("rbf_edge_dw")
    lib.rbf_edge_dw_splits.restype = ctypes.c_int
    dev = X_aug.device
    part = torch.empty((lib.rbf_edge_dw_splits(), ROWS, H), dtype=torch.float32,
                       device=dev)
    dW = torch.empty((ROWS, H), dtype=torch.float32, device=dev)
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    err = fn(ptr(Xq), ptr(Mq), ptr(Xk), ptr(Mk), ptr(nbr), ptr(g), E, K, H,
             ptr(part), ptr(dW), stream_ptr(dev))
    raise_on_error(err, name)
    LAUNCHES[name] += 1
    return dW


def rbf_edge_dw_cuda(X_aug, X_m_aug, E_idx, g, X_aug_k=None, X_m_k=None):
    """Launch ``csrc/rbf_edge_dw.cu`` on fp32 CUDA tensors (the contract of
    ``rbf_edge_dw_plain``)."""
    return _dw_launch("rbf_edge_dw", X_aug, X_m_aug, E_idx, g, X_aug_k, X_m_k,
                      "rbf_edge_dw")


def rbf_edge_dw_bf16_cuda(X_aug, X_m_aug, E_idx, g, X_aug_k=None, X_m_k=None):
    """Launch the bf16 entry of ``csrc/rbf_edge_dw.cu`` (the contract of
    ``rbf_edge_dw_bf16_plain``; fp32 ``g`` and result)."""
    return _dw_launch("rbf_edge_dw_bf16", X_aug, X_m_aug, E_idx, g, X_aug_k,
                      X_m_k, "rbf_edge_dw_bf16")


class RbfProjection(torch.autograd.Function):
    """An RBF projection with its weight-gradient kernel, ``kernels = (the
    forward's CUDA entry, the weight gradient's, their two plain
    versions)``, the plain versions on the CPU; no gradient to coordinates,
    masks or neighbours. The classed projection (``ops/rbf_classed.py``, fp32
    and bf16) runs through it too."""

    @staticmethod
    def forward(ctx, kernels, X_aug, X_m_aug, X_aug_k, X_m_k, E_idx, W):
        ctx.dw = kernels[1] if X_aug.is_cuda else kernels[3]
        ctx.save_for_backward(X_aug, X_m_aug, X_aug_k, X_m_k, E_idx)
        fn = kernels[0] if X_aug.is_cuda else kernels[2]
        return fn(X_aug, X_m_aug, E_idx, W, X_aug_k, X_m_k)

    @staticmethod
    def backward(ctx, g):
        X_aug, X_m_aug, X_aug_k, X_m_k, E_idx = ctx.saved_tensors
        return (None,) * 6 + (ctx.dw(X_aug, X_m_aug, E_idx, g.contiguous(),
                                     X_aug_k, X_m_k),)


_KERNELS = (rbf_edge_cuda, rbf_edge_dw_cuda, rbf_edge_features_plain,
            rbf_edge_dw_plain)
_KERNELS_BF16 = (rbf_edge_bf16_cuda, rbf_edge_dw_bf16_cuda, rbf_edge_bf16_plain,
                 rbf_edge_dw_bf16_plain)
# kernels="torch": the plain bf16 versions on every device
_PLAIN_BF16 = (rbf_edge_bf16_plain, rbf_edge_dw_bf16_plain,
               rbf_edge_bf16_plain, rbf_edge_dw_bf16_plain)


def rbf_edge_features(X_aug, X_m_aug, E_idx, W, low=False, plain=False):
    """``[B,L,18,3]`` coords + ``[B,L,18]`` masks + ``[B,L,K]`` neighbours +
    reference-order ``[5184, H]`` weight -> ``[B,L,K,H]`` fp32. Kernel for
    CUDA tensors, plain version for CPU tensors (``plain``: always the plain
    versions); differentiable in ``W``. ``low``: the bf16 trunk's function
    (bf16 bins and weight, fp32 sums)."""
    return rbf_edge_features_qk(X_aug, X_m_aug, X_aug, X_m_aug, E_idx, W, low,
                                plain)


def rbf_edge_features_qk(X_aug_q, X_m_q, X_aug_k, X_m_k, E_idx, W, low=False,
                         plain=False):
    """Query/key form: query rows ``[B,Lq,18,3]``, ``[B,Lq,18]``, key rows
    ``[B,Lk,18,3]``, ``[B,Lk,18]``, ``E_idx [B,Lq,K]`` key indices ->
    ``[B,Lq,K,H]``; ``low`` and ``plain`` as in ``rbf_edge_features``."""
    if low:
        return RbfProjection.apply(_PLAIN_BF16 if plain else _KERNELS_BF16,
                                   X_aug_q, X_m_q, X_aug_k, X_m_k, E_idx, W)
    if plain:
        return rbf_edge_features_plain(X_aug_q, X_m_q, E_idx, W, X_aug_k, X_m_k)
    return RbfProjection.apply(_KERNELS, X_aug_q, X_m_q, X_aug_k, X_m_k, E_idx, W)
