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

with ``m = W3 . gelu(W2 . gelu(x) + b2) + b3``. The forward runs its four
products on the tensor cores (bf16 ``mma.sync``; 3xTF32 at fp32) over
tiles of ``table_tile_nodes(K)`` whole nodes, and every output is the same
on every launch.

Backward: ``csrc/message_table_bwd.cu`` (replaces ``_message_table_bwd_call``)
resumes from the pre-GELU ``x`` that the forward saves (``save_x=True``), and
``message_table_bwd_plain`` is its plain version. Its products run on the
tensor cores (bf16 ``mma.sync``; 3xTF32 at fp32) and every output is the
same on every launch: no atomics, the weight and bias gradients reduce in a
fixed order, and the table gradient sums each row's edge contributions in
ascending edge order through ``table_order`` (index glue: the model
sorts once per stack and passes it to every layer as ``order``; a call
without it sorts for itself).
``message_table`` wraps both in a ``torch.autograd.Function`` when a
gradient is wanted: ``eidx2``, ``mask_att2`` and ``mbw2`` are structural and
get none; the weights enter as row blocks of ``W1`` (views), so autograd
carries ``dwa``/``dwb`` into ``W1``.

The bf16 trunk: every operand bf16 (weights, masks and tables included)
selects the TPU kernels' ``compute_dtype=bfloat16`` branch, with the JAX
package's rounding points and no others. Each product takes bf16 operands
and sums in fp32 (``dotp``); the activations between products are fp32
rounded to bf16 where they feed a product; the outputs and the saved ``x``
are bf16, and the backward resumes from that rounded ``x``; the table
gradient sums bf16-rounded edge contributions in fp32 and is rounded once;
bias sums run in fp32 on unrounded values; every gradient comes back bf16
(the weights' type). The kernels export ``*_bf16`` entries of the same
sources; their launches count under ``<name>_bf16``.

The same message MLP on a pre-gathered neighbour operand ``G [N*K,H]``
(replaces ``message_mlp``: ``_message_fwd_call`` and ``_message_bwd_call``)
is ``csrc/message_mlp.cu`` and ``csrc/message_mlp_bwd.cu`` with their plain
versions ``message_mlp_plain`` and ``message_mlp_bwd_plain``, behind the
autograd Function ``_MessageMLP``; ``message_agg_batched`` and
``message_edge_batched`` are its layer-level entries. The JAX training
decoder runs it at ``L % 32 != 0`` (``table_gather_ok``), and so does the
port's (``models/mpnn.py::dec_layer``, the gathered route). bf16 operands
select its bf16 variant (``*_bf16`` entries, launches counted as
``message_mlp_bf16`` / ``message_mlp_bwd_bf16``), with the rounding points
of the JAX ``_fwd_kernel`` / ``_bwd_kernel`` at ``compute_dtype=bfloat16``.
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from . import LAUNCHES, check_aligned, check_operand, raise_on_error
from ..models.modules import MESSAGE_SCALE, dotp, gelu, widen

MODES = {"enc_node": 0, "enc_edge": 1, "dec": 2}
MAX_K = 64


def message_table_acc(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                      wa, wb, b1, w2, b2, w3, b3, *, K, L, Lk=None):
    """The message table's function up to its stores: (``out``, ``x``) in
    the accumulation type (fp32 for bf16 operands, else the operands'
    type), before the outputs are rounded to the operands' type."""
    N, H = h_V2.shape
    Lk = L if Lk is None else Lk
    low = h_V2.dtype == torch.bfloat16
    node = torch.arange(N, device=h_V2.device).repeat_interleave(K)
    g = widen(table2[(node // L) * Lk + eidx2])
    x = dotp(h_V2, wa, low).repeat_interleave(K, dim=0) + widen(b1)
    e = dotp(h_E2, wb, low)
    if mode == "dec":
        m1d, mbw = widen(mask_att2)[:, None], widen(mbw2)[:, None]
        x = x + m1d * e + mbw * g[:, :H] + m1d * g[:, H:]
    else:
        x = x + e + g
    m = dotp(gelu(dotp(gelu(x), w2, low) + widen(b2)), w3, low) + widen(b3)
    if mode == "enc_node":
        m = m * widen(mask_att2)[:, None]
    if mode != "enc_edge":
        m = m.view(N, K, H).sum(dim=1) / MESSAGE_SCALE
    return m, x


def message_table_plain(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                        wa, wb, b1, w2, b2, w3, b3, *, K, L, Lk=None,
                        save_x=False):
    """Plain version of the kernel (same arguments, same outputs). With
    ``save_x`` it returns ``(out, x)``, ``x`` the pre-GELU ``[N*K,H]``.
    Outputs in the operands' type (bf16 operands: the bf16 variant)."""
    m, x = message_table_acc(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                             wa, wb, b1, w2, b2, w3, b3, K=K, L=L, Lk=Lk)
    dt = h_V2.dtype
    return (m.to(dt), x.to(dt)) if save_x else m.to(dt)


# Edge rows per tile of the forward kernel, and its most nodes per tile
# (csrc/message_table.cu: kTileRows, kMaxTileNodes).
TILE_ROWS, MAX_TILE_NODES = 64, 16


def table_tile_nodes(K):
    """Nodes per tile of the forward kernel for K neighbours: as many whole
    nodes as fit in its 64 edge rows, at most 16 (one 16-row block of the
    node term ``h_V@Wa``). A tile holds whole nodes, so the K-sum of the
    summing modes never leaves it."""
    return min(TILE_ROWS // K, MAX_TILE_NODES)


def aligned_weights(*ws):
    """The weights as the forward kernel reads them, as 16-byte vectors:
    the same tensors when each starts 16-byte aligned, else one aligned
    copy of all of them (views at any offset of the flat parameter vector).
    Each is ``[H, H]`` with H in (32, 64, 128), so every slice of the copy
    starts a multiple of 2 KB after its aligned start."""
    if all(w.data_ptr() % 16 == 0 for w in ws):
        return ws
    return torch.stack(ws).unbind(0)


def _check_mode(mode, N, K, L, H):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: choose from {sorted(MODES)}")
    if not 1 <= K <= MAX_K or H not in (32, 64, 128):
        raise ValueError(f"message kernel: K={K} (1..{MAX_K}), "
                         f"H={H} (32, 64 or 128) not supported")
    if N % L:
        raise ValueError(f"message kernel: N={N} nodes are not whole "
                         f"structures of L={L}")


def _dtype_of(t):
    """The kernels' operand type of a launch: fp32, or bf16 for the bf16
    variant (suffix of the symbol and of the launch count)."""
    if t.dtype == torch.float32:
        return t.dtype, ""
    if t.dtype == torch.bfloat16:
        return t.dtype, "_bf16"
    raise ValueError(f"message kernel: expected float32 or bfloat16, got {t.dtype}")


def message_table_cuda(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                       wa, wb, b1, w2, b2, w3, b3, *, K, L, Lk=None,
                       save_x=False):
    """Launch ``csrc/message_table.cu`` on CUDA tensors, all fp32 or all
    bf16 (then the bf16 variant, bf16 outputs): a persistent grid of one
    block per SM over tiles of ``table_tile_nodes(K)`` nodes. ``h_E2`` and
    ``table2`` are read as 16-byte vectors and must start aligned; weights
    that do not are copied here."""
    from ._build import library, ptr, stream_ptr

    N, H = h_V2.shape
    Lk = L if Lk is None else Lk
    _check_mode(mode, N, K, L, H)
    dt, sfx = _dtype_of(h_V2)
    C = 2 * H if mode == "dec" else H
    check_operand(h_V2, "h_V2", dt, (N, H))
    check_operand(h_E2, "h_E2", dt, (N * K, H))
    check_operand(table2, "table2", dt, (N // L * Lk, C))
    check_operand(eidx2, "eidx2", torch.int64, (N * K,))
    check_operand(mask_att2, "mask_att2", dt, (N * K,))
    check_operand(mbw2, "mbw2", dt, (N * K,))
    for name, w in (("wa", wa), ("wb", wb), ("w2", w2), ("w3", w3)):
        check_operand(w, name, dt, (H, H))
    for name, b in (("b1", b1), ("b2", b2), ("b3", b3)):
        check_operand(b, name, dt, (H,))
    for name, t in (("h_E2", h_E2), ("table2", table2)):
        check_aligned(t, name)
    wa, wb, w2, w3 = aligned_weights(wa, wb, w2, w3)
    dev = h_V2.device
    out = torch.empty((N * K if mode == "enc_edge" else N, H), dtype=dt,
                      device=dev)
    x = torch.empty((N * K, H), dtype=dt, device=dev) if save_x else None
    nblocks = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = getattr(library("message_table"), "message_table_forward" + sfx)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    tensors = (h_V2, h_E2, table2, eidx2, mask_att2, mbw2, wa, wb, b1, w2,
               b2, w3, b3, out)
    err = fn(MODES[mode], *[ptr(t) for t in tensors],
             ptr(x) if save_x else None, N, K, L, Lk, H, table_tile_nodes(K),
             nblocks, stream_ptr(dev))
    raise_on_error(err, "message_table" + sfx)
    LAUNCHES[f"message_table_{mode}{sfx}"] += 1
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
    ``g_table`` ``[B*Lk, C]``, as the table), in the operands' type."""
    N, H = h_V2.shape
    Lk = L if Lk is None else Lk
    low = h_V2.dtype == torch.bfloat16
    x = widen(x)
    u1 = gelu(x)
    y = dotp(u1, w2, low) + widen(b2)
    g = widen(g)
    if mode == "enc_edge":
        g_m = g
    else:
        g_m = g.repeat_interleave(K, dim=0)
        if mode == "enc_node":
            g_m = g_m * widen(mask_att2)[:, None]
        g_m = g_m / MESSAGE_SCALE
    dw3 = dotp(gelu(y).T, g_m, low)
    g_y = dotp(g_m, w3.T, low) * gelu_grad(y)
    dw2 = dotp(u1.T, g_y, low)
    g_x = dotp(g_y, w2.T, low) * gelu_grad(x)
    if mode == "dec":
        g_e = widen(mask_att2)[:, None] * g_x
        tab = torch.cat([widen(mbw2)[:, None] * g_x, g_e], dim=1)
    else:
        g_e = tab = g_x
    if low:    # each edge's contribution rounded, then summed in fp32
        tab = tab.to(torch.bfloat16).float()
    node = torch.arange(N, device=x.device).repeat_interleave(K)
    g_table = torch.zeros((N // L * Lk, tab.shape[1]), dtype=x.dtype,
                          device=x.device)
    g_table.index_add_(0, (node // L) * Lk + eidx2, tab)
    s = g_x.view(N, K, H).sum(dim=1)
    grads = (dotp(s, wa.T, low), dotp(g_e, wb.T, low), g_table,
             dotp(h_V2.T, s, low), dotp(h_E2.T, g_e, low), g_x.sum(0), dw2,
             g_y.sum(0), dw3, g_m.sum(0))
    return tuple(t.to(h_V2.dtype) for t in grads)


def table_rows(eidx2, K, L, Lk):
    """The table row of every edge, ``(n // L) * Lk + eidx`` (``n = e // K``
    the edge's node)."""
    node = torch.arange(eidx2.shape[0], device=eidx2.device) // K
    return (node // L) * Lk + eidx2


def table_order(eidx2, K, L, Lk, n_rows):
    """The edges sorted stably by table row -> ``(order [E], offsets
    [n_rows + 1])``: row ``t``'s edges are ``order[offsets[t]:offsets[t+1]]``
    in ascending edge order. Index glue for the backward kernel's table
    gradient, which sums each row's contributions in this order (no
    atomics, so the sum is the same on every launch)."""
    key = table_rows(eidx2, K, L, Lk)
    order = torch.argsort(key, stable=True)
    bounds = torch.arange(n_rows + 1, device=key.device, dtype=key.dtype)
    return order, torch.searchsorted(key[order], bounds)


def message_table_bwd_cuda(mode, h_V2, h_E2, x, eidx2, mask_att2, mbw2,
                           wa, wb, b1, w2, b2, w3, b3, g, *, K, L, Lk=None,
                           order=None):
    """Launch ``csrc/message_table_bwd.cu`` on CUDA tensors, all fp32 or all
    bf16 (same contract as ``message_table_bwd_plain``). ``order`` is
    ``table_order(eidx2, K, L, Lk, B*Lk)``, sorted here when not given
    (the layers of one stack share one). The bf16 variant
    sums the table and weight gradients in fp32 and rounds them here, once,
    as the JAX VJP does (``message_kernels.py:581-585``). Scratch of the
    operands' type: gelu(x), g_m (not in enc_edge, where it is ``g``),
    gelu(y), g_y ``[N*K,H]``, the table contributions ``[N*K,C]`` and
    ``sum_k g_x`` ``[N,H]``; fp32 bias and weight partials."""
    from ._build import library, ptr, stream_ptr

    N, H = h_V2.shape
    Lk = L if Lk is None else Lk
    _check_mode(mode, N, K, L, H)
    dt, sfx = _dtype_of(h_V2)
    f32 = torch.float32
    C = 2 * H if mode == "dec" else H
    E = N * K
    check_operand(h_V2, "h_V2", dt, (N, H))
    check_operand(h_E2, "h_E2", dt, (E, H))
    check_operand(x, "x", dt, (E, H))
    check_operand(eidx2, "eidx2", torch.int64, (E,))
    check_operand(mask_att2, "mask_att2", dt, (E,))
    check_operand(mbw2, "mbw2", dt, (E,))
    for name, w in (("wa", wa), ("wb", wb), ("w2", w2), ("w3", w3)):
        check_operand(w, name, dt, (H, H))
    check_operand(b2, "b2", dt, (H,))
    check_operand(g, "g", dt, (E if mode == "enc_edge" else N, H))
    for name, t in (("h_V2", h_V2), ("h_E2", h_E2), ("x", x), ("g", g)):
        check_aligned(t, name)
    dev = h_V2.device
    nblocks = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, nblocks // 3)   # three weight-gradient products per SM
    lib = library("message_table_bwd")
    lib.message_table_backward_tiles.restype = ctypes.c_int
    tiles = lib.message_table_backward_tiles(N, K)
    n_rows = N // L * Lk
    order, offsets = (table_order(eidx2, K, L, Lk, n_rows) if order is None
                      else order)
    check_operand(order, "order", torch.int64, (E,))
    check_operand(offsets, "offsets", torch.int64, (n_rows + 1,))
    g_hV = torch.empty((N, H), dtype=dt, device=dev)
    g_ein = torch.empty((E, H), dtype=dt, device=dev)
    g_table = torch.empty((n_rows, C), dtype=f32, device=dev)
    u1s = torch.empty((E, H), dtype=dt, device=dev)
    gms = None if mode == "enc_edge" else torch.empty((E, H), dtype=dt, device=dev)
    u2s = torch.empty((E, H), dtype=dt, device=dev)
    gys = torch.empty((E, H), dtype=dt, device=dev)
    tcs = torch.empty((E, C), dtype=dt, device=dev)
    ss = torch.empty((N, H), dtype=dt, device=dev)
    bpart = torch.empty((tiles, 3 * H), dtype=f32, device=dev)
    wpart = torch.empty((splits, 4, H, H), dtype=f32, device=dev)
    wgrad = torch.empty((4 * H * H + 3 * H,), dtype=f32, device=dev)
    fn = getattr(lib, "message_table_backward" + sfx)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 26
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    tensors = (h_V2, h_E2, x, eidx2, mask_att2, mbw2, wa, wb, w2, b2, w3, g,
               g_hV, g_ein, u1s, gms, u2s, gys, tcs, ss, bpart, wpart, order,
               offsets, g_table, wgrad)
    err = fn(MODES[mode], *[None if t is None else ptr(t) for t in tensors],
             N, K, L, Lk, H, nblocks,
             splits, stream_ptr(dev))
    raise_on_error(err, "message_table_bwd" + sfx)
    LAUNCHES[f"message_table_bwd_{mode}{sfx}"] += 1
    g_table, wgrad = g_table.to(dt), wgrad.to(dt)
    HH = H * H
    dwa, dwb, dw2, dw3 = (wgrad[i * HH:(i + 1) * HH].view(H, H) for i in range(4))
    db1, db2, db3 = (wgrad[4 * HH + i * H:4 * HH + (i + 1) * H] for i in range(3))
    return g_hV, g_ein, g_table, dwa, dwb, db1, dw2, db2, dw3, db3


class _MessageTable(torch.autograd.Function):
    """The message table with its backward kernel (plain versions on the
    CPU). Saves the pre-GELU ``x`` for the backward; ``order`` (the table
    order, or None) goes to the backward kernel as it is."""

    @staticmethod
    def forward(ctx, mode, K, L, Lk, order, h_V2, h_E2, table2, eidx2,
                mask_att2, mbw2, wa, wb, b1, w2, b2, w3, b3):
        fn = message_table_cuda if h_V2.is_cuda else message_table_plain
        out, x = fn(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                    wa, wb, b1, w2, b2, w3, b3, K=K, L=L, Lk=Lk, save_x=True)
        ctx.mode, ctx.K, ctx.L, ctx.Lk, ctx.order = mode, K, L, Lk, order
        ctx.save_for_backward(h_V2, h_E2, x, eidx2, mask_att2, mbw2,
                              wa, wb, b1, w2, b2, w3, b3)
        return out

    @staticmethod
    def backward(ctx, g):
        args = (ctx.mode, *ctx.saved_tensors, g.contiguous())
        if g.is_cuda:
            grads = message_table_bwd_cuda(*args, K=ctx.K, L=ctx.L, Lk=ctx.Lk,
                                           order=ctx.order)
        else:
            grads = message_table_bwd_plain(*args, K=ctx.K, L=ctx.L, Lk=ctx.Lk)
        g_hV, g_ein, g_table, dwa, dwb, db1, dw2, db2, dw3, db3 = grads
        return (None, None, None, None, None, g_hV, g_ein, g_table, None,
                None, None, dwa, dwb, db1, dw2, db2, dw3, db3)


def message_table(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                  wa, wb, b1, w2, b2, w3, b3, *, K, L, Lk=None, order=None):
    """Kernel for CUDA tensors, plain version for CPU tensors; through the
    autograd Function (which saves ``x``) only when a gradient is wanted.
    ``order``: the table order for the backward kernel, or None (it sorts)."""
    Lk = L if Lk is None else Lk
    args = (h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
            wa, wb, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _MessageTable.apply(mode, K, L, Lk, order, *args)
    fn = message_table_cuda if h_V2.is_cuda else message_table_plain
    return fn(mode, *args, K=K, L=L, Lk=Lk)


def _weights(p, H, w1, w2, w3):
    w = p[w1]["w"]
    return (w[:H], w[H:2 * H], p[w1]["b"], p[w2]["w"], p[w2]["b"],
            p[w3]["w"], p[w3]["b"])


def _table_fn(plain, order):
    return message_table_plain if plain else partial(message_table, order=order)


def message_agg_table_flat(p, h_V2, h_E2, table2, eidx2, mask_att2, *, K, L,
                           Lk=None, plain=False, order=None):
    """Encoder node update (``W1..W3``): ``table2 = h_V2 @ W1c`` ``[B*Lk,H]``
    -> dh ``[N,H]``. ``order`` as in ``message_table``, in the three
    entries here."""
    ones = torch.ones_like(mask_att2)
    return _table_fn(plain, order)(
        "enc_node", h_V2, h_E2, table2, eidx2, mask_att2, ones,
        *_weights(p, h_V2.shape[1], "W1", "W2", "W3"), K=K, L=L, Lk=Lk)


def message_edge_table_flat(p, h_V2, h_E2, table2, eidx2, *, K, L, Lk=None,
                            plain=False, order=None):
    """Encoder edge update (``W11..W13``): ``table2 = h_V2 @ W11c`` -> per-edge
    message ``[N*K,H]``."""
    ones = torch.ones(h_E2.shape[0], dtype=h_E2.dtype, device=h_E2.device)
    return _table_fn(plain, order)(
        "enc_edge", h_V2, h_E2, table2, eidx2, ones, ones,
        *_weights(p, h_V2.shape[1], "W11", "W12", "W13"), K=K, L=L, Lk=Lk)


def message_dec_table_flat(p, h_V2, h_E2, table2, eidx2, m1d2, mbw2, *, K, L,
                           Lk=None, plain=False, order=None):
    """Parallel-decoder node update on the 2H table ``[A | B]``
    (``A = h_S@ws + h_V@wv - h_Venc@wv``, ``B = h_Venc@wv``) -> dh ``[N,H]``.
    ``mbw*A[j] + m1d*B[j]`` is the three-term causal context exactly,
    because ``mask_fw = mask_1d - mask_bw``."""
    return _table_fn(plain, order)(
        "dec", h_V2, h_E2, table2, eidx2, m1d2, mbw2,
        *_weights(p, h_V2.shape[1], "W1", "W2", "W3"), K=K, L=L, Lk=Lk)


# ---------------------------------------------------------------------------
# The message MLP on a pre-gathered neighbour operand
# ---------------------------------------------------------------------------

# The JAX package's node tile (na_mpnn_tpu/ops/message_kernels.py:64): its
# table kernel maps a structure's table into VMEM and needs L % 32 == 0.
NODE_TILE = 32


def table_gather_ok(L) -> bool:
    """The JAX package's predicate for its table kernel (``L % 32 == 0``).
    The port's table kernels take any L; the decoder keeps the predicate
    only to pick its training route where the JAX package picks it
    (``models/mpnn.py::dec_layer``)."""
    return L % NODE_TILE == 0


def _mlp_x(h_V, e_in, G, wa, wb, b1, K, contract_e):
    """Pre-GELU ``x = rep_K(h_V@wa) + G + b1 + (e_in@wb or e_in)``, summed in
    the kernels' order; at bf16 the JAX ``_compute_x``: ``dotp`` products
    and the sum in fp32 on the widened inputs."""
    low = h_V.dtype == torch.bfloat16
    x = dotp(h_V, wa, low).repeat_interleave(K, dim=0) + widen(G) + widen(b1)
    return x + (dotp(e_in, wb, low) if contract_e else widen(e_in))


def message_mlp_plain(h_V, e_in, G, mask_att, wa, wb, b1, w2, b2, w3, b3, *,
                      K, contract_e, aggregate):
    """Plain version of ``csrc/message_mlp.cu``: ``h_V [N,H]``, ``e_in`` and
    ``G [N*K,H]``, ``mask_att [N*K]`` -> ``sum_k(mask_att * m) / 30``
    ``[N,H]`` (``aggregate``) or the per-edge ``m [N*K,H]``, with
    ``m = W3 . gelu(W2 . gelu(x) + b2) + b3``. bf16 operands: the bf16
    variant (fp32 activations, bf16 product operands, the K-sum in fp32,
    the output rounded once)."""
    N, H = h_V.shape
    low = h_V.dtype == torch.bfloat16
    x = _mlp_x(h_V, e_in, G, wa, wb, b1, K, contract_e)
    m = dotp(gelu(dotp(gelu(x), w2, low) + widen(b2)), w3, low) + widen(b3)
    if aggregate:
        m = (m * widen(mask_att)[:, None]).view(N, K, H).sum(dim=1) / MESSAGE_SCALE
    return m.to(h_V.dtype)


def _check_mlp(N, K, H, h_V, e_in, G, mask_att, weights, biases):
    """Check the operands of a launch; returns (the operand type, the
    symbol and launch-count suffix)."""
    if not 1 <= K <= MAX_K or H not in (32, 64, 128):
        raise ValueError(f"message_mlp kernel: K={K} (1..{MAX_K}), "
                         f"H={H} (32, 64 or 128) not supported")
    dt, sfx = _dtype_of(h_V)
    check_operand(h_V, "h_V", dt, (N, H))
    check_operand(e_in, "e_in", dt, (N * K, H))
    check_operand(G, "G", dt, (N * K, H))
    check_operand(mask_att, "mask_att", dt, (N * K,))
    for name, w in zip(("wa", "wb", "w2", "w3"), weights):
        check_operand(w, name, dt, (H, H))
    for name, b in zip(("b1", "b2", "b3"), biases):
        check_operand(b, name, dt, (H,))
    return dt, sfx


def message_mlp_cuda(h_V, e_in, G, mask_att, wa, wb, b1, w2, b2, w3, b3, *,
                     K, contract_e, aggregate):
    """Launch ``csrc/message_mlp.cu`` on CUDA tensors, all fp32 or all bf16
    (then the bf16 variant, a bf16 output; the contract of
    ``message_mlp_plain``)."""
    from ._build import library, ptr, stream_ptr

    N, H = h_V.shape
    dt, sfx = _check_mlp(N, K, H, h_V, e_in, G, mask_att, (wa, wb, w2, w3),
                         (b1, b2, b3))
    out = torch.empty((N if aggregate else N * K, H), dtype=dt,
                      device=h_V.device)
    fn = getattr(library("message_mlp"), "message_mlp_forward" + sfx)
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tensors = (h_V, e_in, G, mask_att, wa, wb, b1, w2, b2, w3, b3, out)
    err = fn(*[ptr(t) for t in tensors], N, K, H, int(contract_e),
             int(aggregate), stream_ptr(h_V.device))
    raise_on_error(err, "message_mlp" + sfx)
    LAUNCHES["message_mlp" + sfx] += 1
    return out


def message_mlp_bwd_plain(h_V, e_in, G, mask_att, wa, wb, b1, w2, b2, w3, b3,
                          g, *, K, contract_e, aggregate):
    """Plain version of ``csrc/message_mlp_bwd.cu``: recomputes the
    activations from the inputs and takes the cotangent ``g`` of the output
    -> ``(g_hV, g_ein, g_G, dwa, dwb, db1, dw2, db2, dw3, db3)`` (biases
    ``[H]``; ``dwb`` zero without ``contract_e``, as the JAX VJP returns), in
    the operands' type. bf16 operands: the bf16 variant (the JAX
    ``_bwd_kernel`` at bf16): ``g_m`` fp32 (with ``aggregate``, ``g`` times
    the bf16 ``mask_att / 30``), every product operand rounded to bf16,
    ``gelu'`` on the unrounded fp32 ``x`` and ``y``, the bias sums and
    ``sum_k g_x`` in fp32, every gradient rounded once."""
    N, H = h_V.shape
    low = h_V.dtype == torch.bfloat16
    x = _mlp_x(h_V, e_in, G, wa, wb, b1, K, contract_e)
    u1 = gelu(x)
    y = dotp(u1, w2, low) + widen(b2)
    if aggregate:
        g_m = widen(g).repeat_interleave(K, dim=0) * widen(
            mask_att[:, None] / MESSAGE_SCALE)
    else:
        g_m = widen(g)
    dw3 = dotp(gelu(y).T, g_m, low)
    g_y = dotp(g_m, w3.T, low) * gelu_grad(y)
    dw2 = dotp(u1.T, g_y, low)
    g_x = dotp(g_y, w2.T, low) * gelu_grad(x)
    if contract_e:
        g_ein, dwb = dotp(g_x, wb.T, low), dotp(e_in.T, g_x, low)
    else:
        g_ein, dwb = g_x, torch.zeros_like(widen(wb))
    s = g_x.view(N, K, H).sum(dim=1)
    grads = (dotp(s, wa.T, low), g_ein, g_x, dotp(h_V.T, s, low), dwb,
             g_x.sum(0), dw2, g_y.sum(0), dw3, g_m.sum(0))
    return tuple(t.to(h_V.dtype) for t in grads)


def message_mlp_bwd_cuda(h_V, e_in, G, mask_att, wa, wb, b1, w2, b2, w3, b3,
                         g, *, K, contract_e, aggregate):
    """Launch ``csrc/message_mlp_bwd.cu`` on CUDA tensors, all fp32 or all
    bf16 (the contract of ``message_mlp_bwd_plain``). The bf16 variant sums
    the weight and bias gradients in fp32 and rounds them here, once, as
    the JAX VJP does (``message_kernels.py:272-276``)."""
    from ._build import library, ptr, stream_ptr

    N, H = h_V.shape
    dt, sfx = _check_mlp(N, K, H, h_V, e_in, G, mask_att, (wa, wb, w2, w3),
                         (b1, b2, b3))
    f32 = torch.float32
    check_operand(g, "g", dt, (N if aggregate else N * K, H))
    dev = h_V.device
    g_hV = torch.empty((N, H), dtype=dt, device=dev)
    g_ein = torch.empty((N * K, H), dtype=dt, device=dev)
    g_G = torch.empty((N * K, H), dtype=dt, device=dev)
    nslot = 4 * H * H + 3 * H
    nparts = torch.cuda.get_device_properties(dev).multi_processor_count
    part = torch.empty((nparts, nslot), dtype=f32, device=dev)
    wT = torch.empty((4, H, H), dtype=f32, device=dev)
    wgrad = torch.empty((nslot,), dtype=f32, device=dev)
    fn = getattr(library("message_mlp_bwd"), "message_mlp_backward" + sfx)
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tensors = (h_V, e_in, G, mask_att, wa, wb, b1, w2, b2, w3, g, g_hV, g_ein,
               g_G, part, wT, wgrad)
    err = fn(*[ptr(t) for t in tensors], N, K, H, int(contract_e),
             int(aggregate), nparts, stream_ptr(dev))
    raise_on_error(err, "message_mlp_bwd" + sfx)
    LAUNCHES["message_mlp_bwd" + sfx] += 1
    wgrad = wgrad.to(dt)
    HH = H * H
    dwa, dwb, dw2, dw3 = (wgrad[i * HH:(i + 1) * HH].view(H, H) for i in range(4))
    db1, db2, db3 = (wgrad[4 * HH + i * H:4 * HH + (i + 1) * H] for i in range(3))
    return g_hV, g_ein, g_G, dwa, dwb, db1, dw2, db2, dw3, db3


class _MessageMLP(torch.autograd.Function):
    """The pre-gathered message MLP with its backward kernel (plain versions
    on the CPU). Saves only the inputs: the backward recomputes the
    activations, as the TPU kernel does. ``mask_att`` is structural and gets
    no gradient."""

    @staticmethod
    def forward(ctx, K, contract_e, aggregate, h_V, e_in, G, mask_att, wa, wb,
                b1, w2, b2, w3, b3):
        fn = message_mlp_cuda if h_V.is_cuda else message_mlp_plain
        ctx.K, ctx.contract_e, ctx.aggregate = K, contract_e, aggregate
        ctx.save_for_backward(h_V, e_in, G, mask_att, wa, wb, b1, w2, b2, w3, b3)
        return fn(h_V, e_in, G, mask_att, wa, wb, b1, w2, b2, w3, b3, K=K,
                  contract_e=contract_e, aggregate=aggregate)

    @staticmethod
    def backward(ctx, g):
        fn = message_mlp_bwd_cuda if g.is_cuda else message_mlp_bwd_plain
        (g_hV, g_ein, g_G, dwa, dwb, db1, dw2, db2, dw3,
         db3) = fn(*ctx.saved_tensors, g.contiguous(), K=ctx.K,
                   contract_e=ctx.contract_e, aggregate=ctx.aggregate)
        return (None, None, None, g_hV, g_ein, g_G, None, dwa, dwb, db1, dw2,
                db2, dw3, db3)


def message_mlp(h_V, e_in, G, mask_att, wa, wb, b1, w2, b2, w3, b3, *, K,
                contract_e, aggregate):
    """Kernel for CUDA tensors, plain version for CPU tensors; through the
    autograd Function only when a gradient is wanted."""
    args = (h_V, e_in, G, mask_att, wa, wb, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _MessageMLP.apply(K, contract_e, aggregate, *args)
    fn = message_mlp_cuda if h_V.is_cuda else message_mlp_plain
    return fn(*args, K=K, contract_e=contract_e, aggregate=aggregate)


def message_agg_batched(p, h_V, e_in, G, mask_att, *, contract_e, w1="W1",
                        w2="W2", w3="W3", plain=False):
    """Node-message aggregation on gathered operands: ``h_V [B,L,H]``,
    ``e_in``/``G [B,L,K,H]``, ``mask_att [B,L,K]`` -> ``dh [B,L,H]`` (pre-
    dropout, pre-LayerNorm). Without ``contract_e`` the edge operand is added
    as it is and ``W1``'s edge block is not used (a zero ``wb``, as in the
    JAX package)."""
    B, L, K, H = e_in.shape
    N = B * L
    wa, wb, b1, w2_, b2, w3_, b3 = _weights(p, H, w1, w2, w3)
    if not contract_e:
        wb = torch.zeros((H, H), dtype=wa.dtype, device=wa.device)
    fn = message_mlp_plain if plain else message_mlp
    dh = fn(h_V.reshape(N, H), e_in.reshape(N * K, H), G.reshape(N * K, H),
            mask_att.reshape(N * K).to(h_V.dtype), wa, wb, b1, w2_, b2, w3_, b3,
            K=K, contract_e=contract_e, aggregate=True)
    return dh.view(B, L, H)


def message_edge_batched(p, h_V, h_E, G, *, w1="W11", w2="W12", w3="W13",
                         plain=False):
    """Per-edge message on gathered operands (the encoder edge update's
    form): ``h_V [B,L,H]``, ``h_E``/``G [B,L,K,H]`` -> ``m [B,L,K,H]``."""
    B, L, K, H = h_E.shape
    N = B * L
    ones = torch.ones((N * K,), dtype=h_V.dtype, device=h_V.device)
    fn = message_mlp_plain if plain else message_mlp
    m = fn(h_V.reshape(N, H), h_E.reshape(N * K, H), G.reshape(N * K, H), ones,
           *_weights(p, H, w1, w2, w3), K=K, contract_e=True, aggregate=False)
    return m.view(B, L, K, H)
