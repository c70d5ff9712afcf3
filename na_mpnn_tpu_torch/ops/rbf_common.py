"""What the four RBF projection wrappers share: the classed forward and its
weight gradient (``ops/rbf_classed.py``, rows 3 and 4) and the dense ones
(``ops/rbf_edge.py``, rows 5 and 6). All four launch the tensor-core walks
of ``csrc/rbf_tile.cuh`` over each edge's atom-pair groups and differ only
in the kind of bin and in the weight they pass.

The 18 augmented atom slots split into the protein block P (N, CA, C, O,
virtual Cb) and the nucleic block N (12 backbone atoms + virtual base-N);
the host permutes them (``PERM``) so each block is contiguous, and the
reference-order ``[18*18*16, H]`` weight splits into one table per (query
block, neighbour block) group, the four one after another, each pair-major
(``_pair_row_map``: 16 consecutive rows are one atom pair's 16 bins).

Each edge is classified alone (``edge_groups``): it feeds every (query
side, neighbour side) group its two residues allow, and every pair of the
other groups has an absent atom, so skipping them skips exact zeros. The
forward takes the edges of exactly one group in that group's list and the
edges of several groups in a fifth (the classify kernel, plain version
``edge_list_codes``; one stable sort lays the lists out,
``edge_tile_order``); the weight gradient takes each group's edges in
ascending order (``edge_group_lists``). All of it is index glue without a
host sync.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import check_aligned, check_operand, launch, raise_on_error

A = 18                   # augmented atom slots
NUM_RBF = 16
ROWS = A * A * NUM_RBF   # 5184

P_SEL = (0, 1, 2, 3, 16)                                  # N, CA, C, O, vCb
N_SEL = (4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 17)    # NA backbone + vN
GROUP_SELS = [(P_SEL, P_SEL), (P_SEL, N_SEL), (N_SEL, P_SEL), (N_SEL, N_SEL)]
PERM = list(P_SEL) + list(N_SEL)

# The weight-gradient walk's fixed edge ranges per group (``kSplit`` of
# ``csrc/rbf_tile.cuh``): the partials of its scratch.
DW_SPLITS = 32


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


@functools.cache
def _perm_index(device):
    """``PERM`` as an index tensor on ``device``, made once: a copy from
    host memory would wait for the device's queue to drain."""
    return torch.as_tensor(PERM, device=device)


def edge_operands(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k):
    """Check the RBF kernels' operands and lay them out: query rows as
    ``[x-plane | y-plane | z-plane]`` ``[B*Lq, 54]`` with their masks
    ``[B*Lq, 18]``, the same of the key rows ``[B*Lk, ...]``, and the flat
    key row of every edge ``[E]``; atom slots in ``PERM`` order. Without key
    rows (None) the keys are the queries, and keys that are the query
    tensors are laid out once."""
    from ..models.modules import flat_rows

    if X_aug_k is None:
        X_aug_k, X_m_k = X_aug, X_m_aug
    B, Lq, A_, _ = X_aug.shape
    K = E_idx.shape[2]
    if A_ != A:
        raise ValueError(f"rbf kernel: needs the {A}-atom frame, got {A_}")
    check_operand(E_idx, "E_idx", torch.int64, (B, Lq, K))
    idx = _perm_index(X_aug.device)

    def rows(X, M, name):
        L = X.shape[1]
        check_operand(X, f"X_aug{name}", torch.float32, (B, L, A, 3))
        check_operand(M, f"X_m{name}", torch.float32, (B, L, A))
        X, M = X[:, :, idx, :], M[:, :, idx]
        return (X.permute(0, 1, 3, 2).reshape(B * L, 3 * A).contiguous(),
                M.reshape(B * L, A).contiguous())

    Xq, Mq = rows(X_aug, X_m_aug, "")
    Xk, Mk = ((Xq, Mq) if X_aug_k is X_aug and X_m_k is X_m_aug
              else rows(X_aug_k, X_m_k, "_k"))
    nbr = flat_rows(E_idx, X_aug_k.shape[1]).reshape(-1).contiguous()
    return Xq, Mq, Xk, Mk, nbr


def residue_sides(M):
    """Side of each residue row from its PERM-ordered atom masks ``[R, 18]``:
    0 protein (or no atom), 1 nucleic, 2 both (as the kernels'
    ``member_bits`` reads them)."""
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
    """Launch the forward's ``classify_kernel`` (``csrc/rbf_classed.cu``,
    for the classed and the dense forward; the contract of
    ``edge_list_codes``) on the laid-out CUDA operands of
    ``edge_operands``."""
    from ._build import library, ptr, stream_ptr

    code = torch.empty(nbr.shape, dtype=torch.uint8, device=nbr.device)
    fn = library("rbf_classed").rbf_classed_classify
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    raise_on_error(fn(ptr(Mq), ptr(Mk), ptr(nbr), nbr.numel(), K, ptr(code),
                      stream_ptr(nbr.device)), "rbf classify")
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


def _check_width(name, H, widths):
    if H not in widths:
        raise ValueError(f"{name} kernel: H={H} not supported (widths "
                         f"{', '.join(map(str, widths))})")


def group_forward(source, symbol, name, widths, table_dtype, X_aug, X_m_aug,
                  E_idx, W, X_aug_k, X_m_k):
    """Launch the forward walk of ``csrc/<source>.cu`` (entry ``symbol``,
    counted as ``name``): the edges listed by their groups, ``W`` (fp32,
    reference order ``[5184, H]``, H in ``widths``) permuted into the four
    pair-major group tables and cast to ``table_dtype`` -> ``[B,Lq,K,H]``
    fp32."""
    from ._build import library, ptr, stream_ptr

    with launch(name):
        B, L, K = E_idx.shape
        H = W.shape[1]
        _check_width(name, H, widths)
        Xq, Mq, Xk, Mk, nbr = edge_operands(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k)
        check_operand(W, "W", torch.float32, (ROWS, H))
        dev = X_aug.device
        table = W.index_select(0, _pair_row_map(dev)).to(table_dtype)
        order, counts = edge_tile_order(edge_list_codes_cuda(Mq, Mk, nbr, K))
        out = torch.empty((B * L * K, H), dtype=torch.float32, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        fn = getattr(library(source), symbol)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                                  ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = fn(ptr(Xq), ptr(Mq), ptr(Xk), ptr(Mk), ptr(nbr), K, H, ptr(table),
                 ptr(order), ptr(counts), sms, ptr(out), stream_ptr(dev))
        raise_on_error(err, name)
        return out.view(B, L, K, H)


def group_dw(source, symbol, name, widths, X_aug, X_m_aug, E_idx, g, X_aug_k,
             X_m_k):
    """Launch the weight-gradient walk of ``csrc/<source>.cu`` (entry
    ``symbol``, counted as ``name``): the cotangent ``g`` ``[B,Lq,K,H]``
    fp32 over each group's edge list -> ``[5184, H]`` fp32 in the reference
    row order."""
    from ._build import library, ptr, stream_ptr

    with launch(name):
        B, L, K = E_idx.shape
        H = g.shape[-1]
        _check_width(name, H, widths)
        E = B * L * K
        Xq, Mq, Xk, Mk, nbr = edge_operands(X_aug, X_m_aug, E_idx, X_aug_k, X_m_k)
        g = g.reshape(E, H)
        check_operand(g, "g", torch.float32, (E, H))
        check_aligned(g, "g")
        dev = X_aug.device
        lists, counts = edge_group_lists(edge_groups(Mq, Mk, nbr, K))
        part = torch.empty((DW_SPLITS, ROWS, H), dtype=torch.float32, device=dev)
        dW = torch.empty((ROWS, H), dtype=torch.float32, device=dev)
        fn = getattr(library(source), symbol)
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        err = fn(ptr(Xq), ptr(Mq), ptr(Xk), ptr(Mk), ptr(nbr), ptr(g), ptr(lists),
                 ptr(counts), lists.shape[1], ptr(_pair_row_map(dev)), K, H,
                 ptr(part), ptr(dW), stream_ptr(dev))
        raise_on_error(err, name)
        return dW
