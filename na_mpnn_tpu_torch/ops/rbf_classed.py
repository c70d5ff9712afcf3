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
(query block, neighbour block) group (``group_rows``).

Both kernels classify each edge, not each tile: ``edge_groups`` puts an
edge in every (query side, neighbour side) group its two residues allow
(index glue, no host sync), and each kernel runs tensor-core products
(bf16 ``mma.sync``; 3xTF32 at fp32) against the four group tables in one
pair-major row order (``_pair_row_map``), every pair's 16 bins computed
from one distance or damped walk. The forward (``csrc/rbf_classed.cu``)
takes the edges of exactly one group in that group's list and the edges of
several groups in a fifth: its classify kernel gives each edge its list
(plain version ``edge_list_codes``), and one stable sort lays the lists
out (``edge_tile_order``); a tile of the fifth runs each of its groups in
turn into the same sums, so every output row is written once, the same on
every launch, and the wrapper permutes the weight into the pair-major
tables once per call. The weight gradient is ``csrc/rbf_classed_dw.cu``
(replaces ``_classed_dw``), which writes the reference-order ``[5184, H]``
gradient directly: one product per group table over that group's list
(``edge_group_lists``), reduced over fixed edge ranges in a fixed order.
The plain versions are the dense ones of ``ops/rbf_edge.py``, and the
projection is its ``RbfProjection`` Function (a gradient for ``W`` only:
coordinates and masks are structural, as in the JAX package,
``rbf_classed.py:592-596``).

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

import ctypes
import functools

import numpy as np
import torch

from . import LAUNCHES, check_aligned, check_operand, raise_on_error
from ..models.features import RBF_D_MAX, RBF_D_MIN
from ..models.modules import take_rows
from .rbf_edge import (A, NUM_RBF, ROWS, RbfProjection, edge_operands,
                       rbf_edge_dw_plain, rbf_edge_features_plain)

P_SEL = (0, 1, 2, 3, 16)                                  # N, CA, C, O, vCb
N_SEL = (4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 17)    # NA backbone + vN
GROUP_SELS = [(P_SEL, P_SEL), (P_SEL, N_SEL), (N_SEL, P_SEL), (N_SEL, N_SEL)]
PERM = list(P_SEL) + list(N_SEL)


def group_rows(num_rbf=NUM_RBF):
    """Row indices (into the reference ``[A*A*R, H]`` weight) of each
    group's table, bin-major: ``r*(Aq*An) + qpos*An + npos``."""
    rows = []
    for selq, seln in GROUP_SELS:
        Aq, An = len(selq), len(seln)
        r, q, n = np.meshgrid(np.arange(num_rbf), np.arange(Aq), np.arange(An),
                              indexing="ij")
        a = np.asarray(selq)[q]
        b = np.asarray(seln)[n]
        rows.append(((a * A + b) * num_rbf + r).reshape(-1))
    return rows


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


@functools.cache
def _pair_row_map(device):
    """The kernels' row order -> reference row: the four tables one after
    another, each pair-major (``pair*16 + r``, ``pair = qpos*An + npos``),
    so 16 consecutive rows are one atom pair's 16 bins."""
    rows = []
    for selq, seln in GROUP_SELS:
        a = np.asarray(selq)[:, None]
        b = np.asarray(seln)[None, :]
        pair = (a * A + b).reshape(-1)                    # qpos-major, then npos
        rows.append((pair[:, None] * NUM_RBF + np.arange(NUM_RBF)).reshape(-1))
    return torch.as_tensor(np.concatenate(rows), dtype=torch.int64, device=device)


def residue_sides(M):
    """Side of each residue row from its PERM-ordered atom masks ``[R, 18]``:
    0 protein (or no atom), 1 nucleic, 2 both (the kernels' ``side_code``)."""
    has_p = (M[:, :len(P_SEL)] > 0).any(dim=1)
    has_n = (M[:, len(P_SEL):] > 0).any(dim=1)
    return has_n.long() + (has_n & has_p).long()


def edge_groups(Mq, Mk, nbr, K):
    """``[4, E]`` bool: edge ``e`` (query row ``e // K``, key row
    ``nbr[e]``) feeds group ``g = 2*a + b`` when ``a`` is a side of its query
    residue and ``b`` one of its neighbour's (a residue with atoms in both
    blocks has both sides)."""
    sq = residue_sides(Mq)[torch.arange(nbr.shape[0], device=nbr.device) // K]
    sn = residue_sides(Mk)[nbr]
    in_q = [(sq == a) | (sq == 2) for a in (0, 1)]
    in_n = [(sn == b) | (sn == 2) for b in (0, 1)]
    return torch.stack([in_q[g >> 1] & in_n[g & 1] for g in range(4)])


def edge_group_lists(member):
    """``[4, E]`` membership -> ``(lists [4, 2E], counts [4])``: group g's
    edges in ascending order in ``lists[g, :counts[g]]`` (int64). Index
    glue without a host sync: non-members go past ``E``, each to a slot of
    its own."""
    E = member.shape[1]
    idx = torch.arange(E, device=member.device)
    counts = member.sum(dim=1)
    # one scan over the four rows in turn (a scan along each short row of a
    # [4, E] tensor is several times slower on the card)
    before = torch.cumsum(counts, 0) - counts
    pos = torch.cumsum(member.reshape(-1), 0).view(4, E) - 1 - before[:, None]
    pos = torch.where(member, pos, E + idx)
    lists = torch.empty((4, 2 * E), dtype=torch.int64, device=member.device)
    lists.scatter_(1, pos, idx.expand(4, E))
    return lists, counts


def edge_list_codes(Mq, Mk, nbr, K):
    """Plain version of the forward's ``classify_kernel``: the list of each
    edge ``[E]`` (uint8), 0-3 the one group it feeds (``edge_groups``), 4
    when it feeds several (a residue with atoms in both blocks at either
    end)."""
    member = edge_groups(Mq, Mk, nbr, K)
    first = member.to(torch.uint8).argmax(dim=0).to(torch.uint8)
    return torch.where(member.sum(dim=0) > 1, 4, first).to(torch.uint8)


def edge_list_codes_cuda(Mq, Mk, nbr, K):
    """Launch the forward's ``classify_kernel`` (the contract of
    ``edge_list_codes``) on the laid-out CUDA operands of ``edge_operands``."""
    from ._build import library, ptr, stream_ptr

    code = torch.empty(nbr.shape, dtype=torch.uint8, device=nbr.device)
    fn = library("rbf_classed").rbf_classed_classify
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    raise_on_error(fn(ptr(Mq), ptr(Mk), ptr(nbr), nbr.numel(), K, ptr(code),
                      stream_ptr(nbr.device)), "rbf_classed classify")
    return code


def edge_tile_order(code):
    """The forward kernel's lists from the edge codes: ``(order [E],
    counts [5])``, the edges sorted stably by code, so list ``l`` is
    ``order[sum(counts[:l]) : sum(counts[:l + 1])]`` in ascending edge
    order. No host sync (``torch.bincount`` on the card reads the largest
    code back to the host, so the counts are a comparison and a sum)."""
    lists = torch.arange(5, device=code.device, dtype=code.dtype)
    return (torch.argsort(code, stable=True),
            (code[None, :] == lists[:, None]).sum(dim=1))


def _dw_launch(symbol, X_aug, X_m_aug, E_idx, g, X_aug_k, X_m_k, name):
    from ._build import library, ptr, stream_ptr

    B, L, K = E_idx.shape
    H = g.shape[-1]
    E = B * L * K
    Xq, Mq, Xk, Mk, nbr = edge_operands(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k,
                                        PERM)
    g = g.reshape(E, H)
    check_operand(g, "g", torch.float32, (E, H))
    check_aligned(g, "g")
    dev = X_aug.device
    lists, counts = edge_group_lists(edge_groups(Mq, Mk, nbr, K))
    lib = library("rbf_classed_dw")
    lib.rbf_classed_dw_splits.restype = ctypes.c_int
    splits = lib.rbf_classed_dw_splits()
    part = torch.empty((splits, ROWS, H), dtype=torch.float32, device=dev)
    dW = torch.empty((ROWS, H), dtype=torch.float32, device=dev)
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    err = fn(ptr(Xq), ptr(Mq), ptr(Xk), ptr(Mk), ptr(nbr), ptr(g), ptr(lists),
             ptr(counts), lists.shape[1], ptr(_pair_row_map(dev)), K, H,
             ptr(part), ptr(dW), stream_ptr(dev))
    raise_on_error(err, name)
    LAUNCHES[name] += 1
    return dW


def rbf_classed_dw_cuda(X_aug, X_m_aug, E_idx, g, X_aug_k=None, X_m_k=None):
    """Launch ``csrc/rbf_classed_dw.cu`` on fp32 CUDA tensors (same contract
    as ``rbf_classed_dw_plain``)."""
    return _dw_launch("rbf_classed_dw", X_aug, X_m_aug, E_idx, g, X_aug_k,
                      X_m_k, "rbf_classed_dw")


def rbf_classed_dw_bf16_cuda(X_aug, X_m_aug, E_idx, g, X_aug_k=None,
                             X_m_k=None):
    """Launch the bf16 entry of ``csrc/rbf_classed_dw.cu`` (the contract of
    ``rbf_classed_dw_bf16_plain``; fp32 ``g`` and result)."""
    return _dw_launch("rbf_classed_dw_bf16", X_aug, X_m_aug, E_idx, g, X_aug_k,
                      X_m_k, "rbf_classed_dw_bf16")


def _forward_launch(symbol, X_aug, X_m_aug, E_idx, W, X_aug_k, X_m_k, name,
                    table_dtype):
    from ._build import library, ptr, stream_ptr

    B, L, K = E_idx.shape
    H = W.shape[1]
    if H not in (32, 64, 128):
        raise ValueError(f"rbf_classed kernel: H={H} (32, 64 or 128) not supported")
    Xq, Mq, Xk, Mk, nbr = edge_operands(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k,
                                        PERM)
    check_operand(W, "W", torch.float32, (ROWS, H))
    dev = X_aug.device
    table = W.index_select(0, _pair_row_map(dev)).to(table_dtype)
    E = B * L * K
    order, counts = edge_tile_order(edge_list_codes_cuda(Mq, Mk, nbr, K))
    out = torch.empty((E, H), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = getattr(library("rbf_classed"), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(ptr(Xq), ptr(Mq), ptr(Xk), ptr(Mk), ptr(nbr), K, H, ptr(table),
             ptr(order), ptr(counts), sms, ptr(out), stream_ptr(dev))
    raise_on_error(err, name)
    LAUNCHES[name] += 1
    return out.view(B, L, K, H)


def rbf_edge_features_classed_cuda(X_aug, X_m_aug, E_idx, W, X_aug_k=None,
                                   X_m_k=None):
    """Launch ``csrc/rbf_classed.cu`` on fp32 CUDA tensors (same contract)."""
    return _forward_launch("rbf_classed_forward", X_aug, X_m_aug, E_idx, W,
                           X_aug_k, X_m_k, "rbf_classed", torch.float32)


def rbf_classed_bf16_cuda(X_aug, X_m_aug, E_idx, W, X_aug_k=None, X_m_k=None):
    """Launch the bf16 entry of ``csrc/rbf_classed.cu`` (the contract of
    ``rbf_classed_bf16_plain``): the fold-scaled fp32 ``W`` is permuted into
    the four pair-major group tables and rounded to bf16 here."""
    return _forward_launch("rbf_classed_forward_bf16", X_aug, X_m_aug, E_idx, W,
                           X_aug_k, X_m_k, "rbf_classed_bf16", torch.bfloat16)


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
