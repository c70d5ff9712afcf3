"""Message MLP with the neighbour-table gather inside: CUDA kernel
``csrc/message_table.cu`` (forward, three modes) and its plain PyTorch
version.

Replaces ``na_mpnn_tpu/ops/message_kernels.py::message_mlp_table`` in its
forward. Edge tensors are flat: ``h_V2 [N,H]`` (B structures of L nodes),
``h_E2 [N*K,H]``, ``eidx2 [N*K]`` (int64, neighbour index local to its
structure), per-edge masks ``[N*K]``. The node table holds ``Lk`` rows per
structure, ``[B*Lk, C]``: ``Lk = L`` on one device; on the graph-parallel
route the nodes are a shard's L rows and the table is all-gathered over the
structure's Lk rows. The kernel reads table rows by their global index
``(n // L) * Lk + eidx``, so it takes any L (the TPU kernel needs
``L % 32 == 0``).

Modes:

* ``enc_node``: ``x = h_V@wa + h_E@wb + table[j] + b1``; returns
  ``sum_k(mask_att * m) / 30`` ``[N,H]``;
* ``enc_edge``: the same ``x``; returns per-edge ``m`` ``[N*K,H]``;
* ``dec``: ``table = [A | B]`` ``[N,2H]``; ``x = h_V@wa + m1d*(h_E@wb) +
  mbw*A[j] + m1d*B[j] + b1``; returns ``sum_k(m) / 30`` with no mask.

with ``m = W3 . gelu(W2 . gelu(x) + b2) + b3``.

Backward: ``csrc/message_table_bwd.cu`` (replaces ``_message_table_bwd_call``)
resumes from the pre-GELU ``x`` that the forward saves (``save_x=True``), and
``message_table_bwd_plain`` is its plain version. ``message_table`` wraps both
in a ``torch.autograd.Function`` when a gradient is wanted: ``eidx2``,
``mask_att2`` and ``mbw2`` are structural and get none; the weights enter as
row blocks of ``W1`` (views), so autograd carries ``dwa``/``dwb`` into ``W1``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_operand, raise_on_error
from ..models.modules import MESSAGE_SCALE, gelu

MODES = {"enc_node": 0, "enc_edge": 1, "dec": 2}
MAX_K = 64


def message_table_plain(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                        wa, wb, b1, w2, b2, w3, b3, *, K, L, Lk=None,
                        save_x=False):
    """Plain version of the kernel (same arguments, same outputs). With
    ``save_x`` it returns ``(out, x)``, ``x`` the pre-GELU ``[N*K,H]``."""
    N, H = h_V2.shape
    Lk = L if Lk is None else Lk
    node = torch.arange(N, device=h_V2.device).repeat_interleave(K)
    g = table2[(node // L) * Lk + eidx2]
    x = (h_V2 @ wa).repeat_interleave(K, dim=0) + b1
    e = h_E2 @ wb
    if mode == "dec":
        m1d, mbw = mask_att2[:, None], mbw2[:, None]
        x = x + m1d * e + mbw * g[:, :H] + m1d * g[:, H:]
    else:
        x = x + e + g
    m = gelu(gelu(x) @ w2 + b2) @ w3 + b3
    if mode == "enc_node":
        m = m * mask_att2[:, None]
    if mode != "enc_edge":
        m = m.view(N, K, H).sum(dim=1) / MESSAGE_SCALE
    return (m, x) if save_x else m


def _check_mode(mode, N, K, L, H):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: choose from {sorted(MODES)}")
    if not 1 <= K <= MAX_K or H not in (32, 64, 128):
        raise ValueError(f"message kernel: K={K} (1..{MAX_K}), "
                         f"H={H} (32, 64 or 128) not supported")
    if N % L:
        raise ValueError(f"message kernel: N={N} nodes are not whole "
                         f"structures of L={L}")


def message_table_cuda(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                       wa, wb, b1, w2, b2, w3, b3, *, K, L, Lk=None,
                       save_x=False):
    """Launch ``csrc/message_table.cu`` on fp32 CUDA tensors."""
    from ._build import library, ptr, stream_ptr

    N, H = h_V2.shape
    Lk = L if Lk is None else Lk
    _check_mode(mode, N, K, L, H)
    f32 = torch.float32
    C = 2 * H if mode == "dec" else H
    check_operand(h_V2, "h_V2", f32, (N, H))
    check_operand(h_E2, "h_E2", f32, (N * K, H))
    check_operand(table2, "table2", f32, (N // L * Lk, C))
    check_operand(eidx2, "eidx2", torch.int64, (N * K,))
    check_operand(mask_att2, "mask_att2", f32, (N * K,))
    check_operand(mbw2, "mbw2", f32, (N * K,))
    for name, w in (("wa", wa), ("wb", wb), ("w2", w2), ("w3", w3)):
        check_operand(w, name, f32, (H, H))
    for name, b in (("b1", b1), ("b2", b2), ("b3", b3)):
        check_operand(b, name, f32, (H,))
    out = torch.empty((N * K if mode == "enc_edge" else N, H), dtype=f32,
                      device=h_V2.device)
    x = (torch.empty((N * K, H), dtype=f32, device=h_V2.device)
         if save_x else None)
    fn = library("message_table").message_table_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    tensors = (h_V2, h_E2, table2, eidx2, mask_att2, mbw2, wa, wb, b1, w2,
               b2, w3, b3, out)
    err = fn(MODES[mode], *[ptr(t) for t in tensors],
             ptr(x) if save_x else None, N, K, L, Lk, H,
             stream_ptr(h_V2.device))
    raise_on_error(err, "message_table")
    LAUNCHES[f"message_table_{mode}"] += 1
    return (out, x) if save_x else out


def gelu_grad(x):
    """Exact derivative of the erf GELU: ``Phi(x) + x * phi(x)``."""
    cdf = 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
    return cdf + x * torch.exp(-0.5 * x * x) * 0.3989422804014327


def message_table_bwd_plain(mode, h_V2, h_E2, x, eidx2, mask_att2, mbw2,
                            wa, wb, b1, w2, b2, w3, b3, g, *, K, L, Lk=None):
    """Plain version of the backward kernel: from the saved pre-GELU ``x``
    and the cotangent ``g`` of the output (``[N,H]``, or ``[N*K,H]`` in
    enc_edge) -> ``(g_hV, g_ein, g_table, dwa, dwb, db1, dw2, db2, dw3,
    db3)``, the outputs of ``_message_table_bwd_call`` (biases ``[H]``;
    ``g_table`` ``[B*Lk, C]``, as the table)."""
    N, H = h_V2.shape
    Lk = L if Lk is None else Lk
    u1 = gelu(x)
    y = u1 @ w2 + b2
    if mode == "enc_edge":
        g_m = g
    else:
        g_m = g.repeat_interleave(K, dim=0)
        if mode == "enc_node":
            g_m = g_m * mask_att2[:, None]
        g_m = g_m / MESSAGE_SCALE
    dw3 = gelu(y).T @ g_m
    g_y = (g_m @ w3.T) * gelu_grad(y)
    dw2 = u1.T @ g_y
    g_x = (g_y @ w2.T) * gelu_grad(x)
    if mode == "dec":
        g_e = mask_att2[:, None] * g_x
        tab = torch.cat([mbw2[:, None] * g_x, g_e], dim=1)
    else:
        g_e = tab = g_x
    node = torch.arange(N, device=x.device).repeat_interleave(K)
    g_table = torch.zeros((N // L * Lk, tab.shape[1]), dtype=x.dtype,
                          device=x.device)
    g_table.index_add_(0, (node // L) * Lk + eidx2, tab)
    s = g_x.view(N, K, H).sum(dim=1)
    return (s @ wa.T, g_e @ wb.T, g_table, h_V2.T @ s, h_E2.T @ g_e,
            g_x.sum(0), dw2, g_y.sum(0), dw3, g_m.sum(0))


def message_table_bwd_cuda(mode, h_V2, h_E2, x, eidx2, mask_att2, mbw2,
                           wa, wb, b1, w2, b2, w3, b3, g, *, K, L, Lk=None):
    """Launch ``csrc/message_table_bwd.cu`` on fp32 CUDA tensors (same
    contract as ``message_table_bwd_plain``)."""
    from ._build import library, ptr, stream_ptr

    N, H = h_V2.shape
    Lk = L if Lk is None else Lk
    _check_mode(mode, N, K, L, H)
    f32 = torch.float32
    C = 2 * H if mode == "dec" else H
    check_operand(h_V2, "h_V2", f32, (N, H))
    check_operand(h_E2, "h_E2", f32, (N * K, H))
    check_operand(x, "x", f32, (N * K, H))
    check_operand(eidx2, "eidx2", torch.int64, (N * K,))
    check_operand(mask_att2, "mask_att2", f32, (N * K,))
    check_operand(mbw2, "mbw2", f32, (N * K,))
    for name, w in (("wa", wa), ("wb", wb), ("w2", w2), ("w3", w3)):
        check_operand(w, name, f32, (H, H))
    check_operand(b2, "b2", f32, (H,))
    check_operand(g, "g", f32, (N * K if mode == "enc_edge" else N, H))
    dev = h_V2.device
    g_hV = torch.empty((N, H), dtype=f32, device=dev)
    g_ein = torch.empty((N * K, H), dtype=f32, device=dev)
    g_table = torch.zeros((N // L * Lk, C), dtype=f32, device=dev)
    nslot = 4 * H * H + 3 * H
    nparts = torch.cuda.get_device_properties(dev).multi_processor_count
    part = torch.empty((nparts, nslot), dtype=f32, device=dev)
    wT = torch.empty((4, H, H), dtype=f32, device=dev)
    wgrad = torch.empty((nslot,), dtype=f32, device=dev)
    fn = library("message_table_bwd").message_table_backward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 18
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    tensors = (h_V2, h_E2, x, eidx2, mask_att2, mbw2, wa, wb, w2, b2, w3, g,
               g_hV, g_ein, g_table, part, wT, wgrad)
    err = fn(MODES[mode], *[ptr(t) for t in tensors], N, K, L, Lk, H, nparts,
             stream_ptr(dev))
    raise_on_error(err, "message_table_bwd")
    LAUNCHES[f"message_table_bwd_{mode}"] += 1
    HH = H * H
    dwa, dwb, dw2, dw3 = (wgrad[i * HH:(i + 1) * HH].view(H, H) for i in range(4))
    db1, db2, db3 = (wgrad[4 * HH + i * H:4 * HH + (i + 1) * H] for i in range(3))
    return g_hV, g_ein, g_table, dwa, dwb, db1, dw2, db2, dw3, db3


class _MessageTable(torch.autograd.Function):
    """The message table with its backward kernel (plain versions on the
    CPU). Saves the pre-GELU ``x`` for the backward."""

    @staticmethod
    def forward(ctx, mode, K, L, Lk, h_V2, h_E2, table2, eidx2, mask_att2,
                mbw2, wa, wb, b1, w2, b2, w3, b3):
        fn = message_table_cuda if h_V2.is_cuda else message_table_plain
        out, x = fn(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                    wa, wb, b1, w2, b2, w3, b3, K=K, L=L, Lk=Lk, save_x=True)
        ctx.mode, ctx.K, ctx.L, ctx.Lk = mode, K, L, Lk
        ctx.save_for_backward(h_V2, h_E2, x, eidx2, mask_att2, mbw2,
                              wa, wb, b1, w2, b2, w3, b3)
        return out

    @staticmethod
    def backward(ctx, g):
        fn = message_table_bwd_cuda if g.is_cuda else message_table_bwd_plain
        (g_hV, g_ein, g_table, dwa, dwb, db1, dw2, db2, dw3,
         db3) = fn(ctx.mode, *ctx.saved_tensors, g.contiguous(), K=ctx.K,
                   L=ctx.L, Lk=ctx.Lk)
        return (None, None, None, None, g_hV, g_ein, g_table, None, None,
                None, dwa, dwb, db1, dw2, db2, dw3, db3)


def message_table(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                  wa, wb, b1, w2, b2, w3, b3, *, K, L, Lk=None):
    """Kernel for CUDA tensors, plain version for CPU tensors; through the
    autograd Function (which saves ``x``) only when a gradient is wanted."""
    Lk = L if Lk is None else Lk
    args = (h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
            wa, wb, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _MessageTable.apply(mode, K, L, Lk, *args)
    fn = message_table_cuda if h_V2.is_cuda else message_table_plain
    return fn(mode, *args, K=K, L=L, Lk=Lk)


def _weights(p, H, w1, w2, w3):
    w = p[w1]["w"]
    return (w[:H], w[H:2 * H], p[w1]["b"], p[w2]["w"], p[w2]["b"],
            p[w3]["w"], p[w3]["b"])


def message_agg_table_flat(p, h_V2, h_E2, table2, eidx2, mask_att2, *, K, L,
                           Lk=None, plain=False):
    """Encoder node update (``W1..W3``): ``table2 = h_V2 @ W1c`` ``[B*Lk,H]``
    -> dh ``[N,H]``."""
    fn = message_table_plain if plain else message_table
    ones = torch.ones_like(mask_att2)
    return fn("enc_node", h_V2, h_E2, table2, eidx2, mask_att2, ones,
              *_weights(p, h_V2.shape[1], "W1", "W2", "W3"), K=K, L=L, Lk=Lk)


def message_edge_table_flat(p, h_V2, h_E2, table2, eidx2, *, K, L, Lk=None,
                            plain=False):
    """Encoder edge update (``W11..W13``): ``table2 = h_V2 @ W11c`` -> per-edge
    message ``[N*K,H]``."""
    fn = message_table_plain if plain else message_table
    ones = torch.ones(h_E2.shape[0], dtype=h_E2.dtype, device=h_E2.device)
    return fn("enc_edge", h_V2, h_E2, table2, eidx2, ones, ones,
              *_weights(p, h_V2.shape[1], "W11", "W12", "W13"), K=K, L=L,
              Lk=Lk)


def message_dec_table_flat(p, h_V2, h_E2, table2, eidx2, m1d2, mbw2, *, K, L,
                           Lk=None, plain=False):
    """Parallel-decoder node update on the 2H table ``[A | B]``
    (``A = h_S@ws + h_V@wv - h_Venc@wv``, ``B = h_Venc@wv``) -> dh ``[N,H]``.
    ``mbw*A[j] + m1d*B[j]`` is the three-term causal context exactly,
    because ``mask_fw = mask_1d - mask_bw``."""
    fn = message_table_plain if plain else message_table
    return fn("dec", h_V2, h_E2, table2, eidx2, m1d2, mbw2,
              *_weights(p, h_V2.shape[1], "W1", "W2", "W3"), K=K, L=L, Lk=Lk)
