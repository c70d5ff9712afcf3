"""Class-specialised all-pair-atom RBF edge features fused with their
projection: CUDA kernels ``csrc/rbf_classed.cu`` (forward) and
``csrc/rbf_classed_dw.cu`` (weight gradient); their plain PyTorch versions
are the dense ``all_pair_rbf(...) @ W`` and its gradient.

Replaces ``na_mpnn_tpu/ops/rbf_classed.py::rbf_edge_features_classed``
(forward, ``_classed_fwd``), its query/key entry
``rbf_edge_features_classed_qk`` (the graph-parallel forward: a shard's
query rows against the all-gathered structure's key rows; one kernel, which
takes the key rows as their own operand) and ``_classed_dw``.

Both kernels are the tensor-core walks over each edge's atom-pair groups
that the dense projection (``ops/rbf_edge.py``) runs too
(``csrc/rbf_tile.cuh``, launched by ``ops/rbf_common.py``'s
``group_forward`` and ``group_dw``, where the atom blocks, the pair-major
group tables and the edge lists are described): bf16 ``mma.sync``, 3xTF32
at fp32, every output row written once and the weight gradient reduced
over fixed edge ranges in a fixed order, so both are deterministic. The
wrapper permutes the weight into the group tables once per call, and the
weight gradient comes back in the reference order ``[5184, H]``. The
projection is ``ops/rbf_edge.py``'s ``RbfProjection`` Function (a gradient
for ``W`` only: coordinates and masks are structural, as in the JAX
package, ``rbf_classed.py:592-596``).

The bf16 trunk (``low=True``) takes the TPU kernels' bf16 branch, a
different function: each bin comes from the two-sided damped geometric
recursion (``bins_damped``, the JAX ``_bins_recursive``: 3 exps and a
division per atom pair, capped distances) and is rounded to bf16; the
projection multiplies by ``bf16(W * fold scale)`` and sums in fp32 into an
fp32 ``[E, H]``, and the weight gradient sums ``bf16(bin) * bf16(g)`` in
fp32. The per-bin fold scales (``bin_fold_scales``) multiply the weight
outside the autograd Function, as the JAX ``_run`` does
(``rbf_classed.py:583-590``), so the gradient of ``W`` flows through the
scaling by autograd. The same ``.cu`` sources export the bf16 entries
(``rbf_classed_forward_bf16``, ``rbf_classed_dw_bf16``); the exact pair
distances stand in for the TPU's bf16x2 coordinate selection.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.features import RBF_D_MAX, RBF_D_MIN
from ..models.modules import take_rows
from .rbf_common import A, NUM_RBF, ROWS, group_dw, group_forward
from .rbf_edge import RbfProjection, rbf_edge_dw_plain, rbf_edge_features_plain

WIDTHS = (32, 64, 128)   # the widths both kernels are built for


# The class split changes the work, not the function: the plain versions
# are the dense ones (``ops/rbf_edge.py``).
rbf_edge_features_classed_plain = rbf_edge_features_plain
rbf_classed_dw_plain = rbf_edge_dw_plain

# Distances are capped here before the bf16 bins (the JAX DIST_CAP): every
# bin is 0 beyond it, and the recursion's generator stays finite.
DIST_CAP = 50.0


def bin_fold_scales(num_rbf=NUM_RBF):
    """Per-bin constants ``e^{c r (R-1-r)}`` that the damped bins leave out
    and the weight rows carry (the JAX ``bin_fold_scales``)."""
    sigma = (RBF_D_MAX - RBF_D_MIN) / num_rbf
    step = (RBF_D_MAX - RBF_D_MIN) / (num_rbf - 1)
    c = step * step / (sigma * sigma)
    r = np.arange(num_rbf, dtype=np.float64)
    return np.exp(c * r * (num_rbf - 1 - r)).astype(np.float32)


def fold_scaled(W):
    """``W * fold scale`` of each reference-order row ``(a*18 + b)*16 + r``
    (fp32, differentiable)."""
    scales = torch.as_tensor(bin_fold_scales(), device=W.device)
    return W * scales.repeat(A * A)[:, None].to(W.dtype)


def bins_damped(D, num_rbf=NUM_RBF):
    """The JAX ``_bins_recursive`` on fp32 distances ``D [...]`` ->
    ``[..., R]``: f_r(D) = e^{c r (R-1-r)} max(u_r, d_{R-1-r}) with the walk
    u_r = f_lo (gK)^r up from bin 0 and d_m = f_hi (e^{(R-1)c}/g)^m down from
    bin R-1, in the JAX package's order of fp32 operations (subnormal seeds
    flushed to 0)."""
    sigma = (RBF_D_MAX - RBF_D_MIN) / num_rbf
    step = (RBF_D_MAX - RBF_D_MIN) / (num_rbf - 1)
    inv_s2 = 1.0 / (sigma * sigma)
    c = step * step * inv_s2
    R = num_rbf
    t0 = D - RBF_D_MIN
    t1 = D - RBF_D_MAX
    tiny = float(np.float32(1.2e-38))
    f_lo = torch.exp(-(t0 * t0) * inv_s2)
    f_lo = torch.where(f_lo < tiny, 0.0, f_lo)
    f_hi = torch.exp(-(t1 * t1) * inv_s2)
    f_hi = torch.where(f_hi < tiny, 0.0, f_hi)
    g = torch.exp((2.0 * step * inv_s2) * t0)
    gK = g * float(np.float32(np.exp(-(R - 1) * c)))
    g1K = torch.full_like(g, float(np.float32(np.exp((R - 1) * c)))) / g
    up, down = [f_lo], [f_hi]
    for _ in range(1, R):
        up.append(up[-1] * gK)
        down.append(down[-1] * g1K)
    return torch.stack([torch.maximum(up[r], down[R - 1 - r]) for r in range(R)],
                       dim=-1)


def rbf_bins_bf16(X_aug, X_m_aug, E_idx, X_aug_k=None, X_m_k=None):
    """The bf16 bins of every edge ``[E, 5184]`` (bf16, reference order):
    exact fp32 pair distances, capped, through ``bins_damped``, 0 where
    either atom is absent."""
    if X_aug_k is None:
        X_aug_k, X_m_k = X_aug, X_m_aug
    B, L, _, _ = X_aug.shape
    K = E_idx.shape[2]
    X_g = take_rows(X_aug_k.reshape(B, -1, A * 3), E_idx).reshape(B, L, K, A, 3)
    d = X_aug[:, :, None, :, None, :] - X_g[:, :, :, None, :, :]
    D = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                   + d[..., 2] * d[..., 2] + 1e-6)
    bins = bins_damped(torch.clamp(D, max=DIST_CAP))        # [B,L,K,A,A,R]
    m = (X_m_aug[:, :, None, :, None, None]
         * take_rows(X_m_k, E_idx)[:, :, :, None, :, None])
    return (bins * m).to(torch.bfloat16).reshape(B * L * K, ROWS)


def rbf_classed_bf16_plain(X_aug, X_m_aug, E_idx, W, X_aug_k=None, X_m_k=None):
    """Plain version of the bf16 forward: ``bf16 bins @ bf16(W)`` summed in
    fp32 -> ``[B,Lq,K,H]`` fp32; ``W`` is the fold-scaled fp32 weight."""
    B, L, K = E_idx.shape
    bins = rbf_bins_bf16(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k)
    return (bins.float() @ W.to(torch.bfloat16).float()).view(B, L, K, -1)


def rbf_classed_dw_bf16_plain(X_aug, X_m_aug, E_idx, g, X_aug_k=None,
                              X_m_k=None):
    """Plain version of the bf16 weight gradient: ``bf16 bins^T @ bf16(g)``
    summed in fp32 -> ``[5184, H]`` fp32 (the gradient of the scaled
    weight)."""
    bins = rbf_bins_bf16(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k)
    g = g.reshape(-1, g.shape[-1]).to(torch.bfloat16)
    return bins.float().T @ g.float()


def rbf_edge_features_classed_cuda(X_aug, X_m_aug, E_idx, W, X_aug_k=None,
                                   X_m_k=None):
    """Launch ``csrc/rbf_classed.cu`` on fp32 CUDA tensors (same contract)."""
    return group_forward("rbf_classed", "rbf_classed_forward", "rbf_classed",
                         WIDTHS, torch.float32, X_aug, X_m_aug, E_idx, W,
                         X_aug_k, X_m_k)


def rbf_classed_bf16_cuda(X_aug, X_m_aug, E_idx, W, X_aug_k=None, X_m_k=None):
    """Launch the bf16 entry of ``csrc/rbf_classed.cu`` (the contract of
    ``rbf_classed_bf16_plain``): the fold-scaled fp32 ``W`` is permuted into
    the four pair-major group tables and rounded to bf16 here."""
    return group_forward("rbf_classed", "rbf_classed_forward_bf16",
                         "rbf_classed_bf16", WIDTHS, torch.bfloat16, X_aug,
                         X_m_aug, E_idx, W, X_aug_k, X_m_k)


def rbf_classed_dw_cuda(X_aug, X_m_aug, E_idx, g, X_aug_k=None, X_m_k=None):
    """Launch ``csrc/rbf_classed_dw.cu`` on fp32 CUDA tensors (same contract
    as ``rbf_classed_dw_plain``)."""
    return group_dw("rbf_classed_dw", "rbf_classed_dw", "rbf_classed_dw", WIDTHS,
                    X_aug, X_m_aug, E_idx, g, X_aug_k, X_m_k)


def rbf_classed_dw_bf16_cuda(X_aug, X_m_aug, E_idx, g, X_aug_k=None,
                             X_m_k=None):
    """Launch the bf16 entry of ``csrc/rbf_classed_dw.cu`` (the contract of
    ``rbf_classed_dw_bf16_plain``; fp32 ``g`` and result)."""
    return group_dw("rbf_classed_dw", "rbf_classed_dw_bf16", "rbf_classed_dw_bf16",
                    WIDTHS, X_aug, X_m_aug, E_idx, g, X_aug_k, X_m_k)


_KERNELS = (rbf_edge_features_classed_cuda, rbf_classed_dw_cuda,
            rbf_edge_features_plain, rbf_edge_dw_plain)
_KERNELS_BF16 = (rbf_classed_bf16_cuda, rbf_classed_dw_bf16_cuda,
                 rbf_classed_bf16_plain, rbf_classed_dw_bf16_plain)
# kernels="torch": the plain bf16 versions on every device
_PLAIN_BF16 = (rbf_classed_bf16_plain, rbf_classed_dw_bf16_plain,
               rbf_classed_bf16_plain, rbf_classed_dw_bf16_plain)


def rbf_edge_features_classed(X_aug, X_m_aug, E_idx, W, low=False, plain=False):
    """``[B,L,18,3]`` coords + ``[B,L,18]`` masks + ``[B,L,K]`` neighbours +
    reference-order ``[5184, H]`` weight -> ``[B,L,K,H]`` fp32. Kernel for
    CUDA tensors, plain version for CPU tensors (``plain``: always the plain
    versions); differentiable in ``W``. ``low``: the bf16 trunk's function
    (damped bins, bf16 operands, the fold scales applied to ``W`` here)."""
    return rbf_edge_features_classed_qk(X_aug, X_m_aug, X_aug, X_m_aug, E_idx,
                                        W, low, plain)


def rbf_edge_features_classed_qk(X_aug_q, X_m_q, X_aug_k, X_m_k, E_idx, W,
                                 low=False, plain=False):
    """Query/key form: query rows ``[B,Lq,18,3]`` and ``[B,Lq,18]``, key rows
    ``[B,Lk,18,3]`` and ``[B,Lk,18]``, ``E_idx [B,Lq,K]`` key indices ->
    ``[B,Lq,K,H]``. The same kernels as ``rbf_edge_features_classed``, with
    its ``low`` and ``plain``."""
    if low:
        return RbfProjection.apply(_PLAIN_BF16 if plain else _KERNELS_BF16,
                                   X_aug_q, X_m_q, X_aug_k, X_m_k, E_idx,
                                   fold_scaled(W))
    if plain:
        return rbf_edge_features_classed_plain(X_aug_q, X_m_q, E_idx, W,
                                               X_aug_k, X_m_k)
    return RbfProjection.apply(_KERNELS, X_aug_q, X_m_q, X_aug_k, X_m_k, E_idx, W)
