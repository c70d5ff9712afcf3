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
same function as the class-specialised projection of ``ops/rbf_classed.py``
at fp32: every pair outside the atom-pair groups an edge feeds has an
absent atom. So both run the same tensor-core walks over each edge's
groups (``csrc/rbf_tile.cuh``, launched by ``ops/rbf_common.py``'s
``group_forward`` and ``group_dw``), the fp32 ones the same instantiation;
at bf16 the dense kernels take the exact bins rounded to bf16 where the
classed ones take the damped bins. ``W`` stays in the reference row order
``(a*18 + b)*16 + r`` at this module's functions and is permuted into the
walks' pair-major group tables per call, with no fold scale; the weight
gradient comes back in the reference order. The forward takes every width
in ``FORWARD_WIDTHS`` (the old scalar kernel took any H up to 256; the walk
takes multiples of 32), the weight gradient those in ``DW_WIDTHS``; any
other raises ``ValueError``.

Each function takes query rows and, optionally, key rows (the graph-parallel
forward's shard against the all-gathered structure); ``E_idx`` indexes the
key rows. The projection is a ``torch.autograd.Function`` with a gradient for
``W`` only: coordinates and masks are structural, as in the JAX package
(``rbf_edge.py:246-252``).
"""
from __future__ import annotations

import torch

from .rbf_common import NUM_RBF, ROWS, group_dw, group_forward

# The widths each kernel is built for (``csrc/rbf_edge.cu``'s
# ``RBF_EDGE_WIDTHS``, ``csrc/rbf_edge_dw.cu``'s instantiations).
FORWARD_WIDTHS = (32, 64, 96, 128, 160, 192, 224, 256)
DW_WIDTHS = (32, 64, 128)


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


def rbf_edge_cuda(X_aug, X_m_aug, E_idx, W, X_aug_k=None, X_m_k=None):
    """Launch ``csrc/rbf_edge.cu`` on fp32 CUDA tensors (the contract of
    ``rbf_edge_features_plain``)."""
    return group_forward("rbf_edge", "rbf_edge_forward", "rbf_edge",
                         FORWARD_WIDTHS, torch.float32, X_aug, X_m_aug, E_idx,
                         W, X_aug_k, X_m_k)


def rbf_edge_bf16_cuda(X_aug, X_m_aug, E_idx, W, X_aug_k=None, X_m_k=None):
    """Launch the bf16 entry of ``csrc/rbf_edge.cu`` (the contract of
    ``rbf_edge_bf16_plain``): the fp32 ``W`` is permuted into the four
    pair-major group tables and rounded to bf16 here."""
    return group_forward("rbf_edge", "rbf_edge_forward_bf16", "rbf_edge_bf16",
                         FORWARD_WIDTHS, torch.bfloat16, X_aug, X_m_aug, E_idx,
                         W, X_aug_k, X_m_k)


def rbf_edge_dw_cuda(X_aug, X_m_aug, E_idx, g, X_aug_k=None, X_m_k=None):
    """Launch ``csrc/rbf_edge_dw.cu`` on fp32 CUDA tensors (the contract of
    ``rbf_edge_dw_plain``)."""
    return group_dw("rbf_edge_dw", "rbf_edge_dw", "rbf_edge_dw", DW_WIDTHS,
                    X_aug, X_m_aug, E_idx, g, X_aug_k, X_m_k)


def rbf_edge_dw_bf16_cuda(X_aug, X_m_aug, E_idx, g, X_aug_k=None, X_m_k=None):
    """Launch the bf16 entry of ``csrc/rbf_edge_dw.cu`` (the contract of
    ``rbf_edge_dw_bf16_plain``; fp32 ``g`` and result)."""
    return group_dw("rbf_edge_dw", "rbf_edge_dw_bf16", "rbf_edge_dw_bf16",
                    DW_WIDTHS, X_aug, X_m_aug, E_idx, g, X_aug_k, X_m_k)


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
