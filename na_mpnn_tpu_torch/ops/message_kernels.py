"""Message MLP with the neighbour-table gather inside: CUDA kernel
``csrc/message_table.cu`` (forward, three modes) and its plain PyTorch
version.

Replaces ``na_mpnn_tpu/ops/message_kernels.py::message_mlp_table`` in its
forward. Edge tensors are flat: ``h_V2 [N,H]``, ``h_E2 [N*K,H]``, ``eidx2
[N*K]`` (int64, neighbour index local to its structure of L nodes), per-edge
masks ``[N*K]``. The kernel reads table rows by their global index
``(n // L) * L + eidx``, so it takes any L (the TPU kernel needs
``L % 32 == 0``).

Modes:

* ``enc_node``: ``x = h_V@wa + h_E@wb + table[j] + b1``; returns
  ``sum_k(mask_att * m) / 30`` ``[N,H]``;
* ``enc_edge``: the same ``x``; returns per-edge ``m`` ``[N*K,H]``;
* ``dec``: ``table = [A | B]`` ``[N,2H]``; ``x = h_V@wa + m1d*(h_E@wb) +
  mbw*A[j] + m1d*B[j] + b1``; returns ``sum_k(m) / 30`` with no mask.

with ``m = W3 . gelu(W2 . gelu(x) + b2) + b3``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_operand, raise_on_error
from ..models.modules import MESSAGE_SCALE, gelu

MODES = {"enc_node": 0, "enc_edge": 1, "dec": 2}
MAX_K = 64


def message_table_plain(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                        wa, wb, b1, w2, b2, w3, b3, *, K, L):
    """Plain version of the kernel (same arguments, same outputs)."""
    N, H = h_V2.shape
    node = torch.arange(N, device=h_V2.device).repeat_interleave(K)
    g = table2[(node // L) * L + eidx2]
    x = (h_V2 @ wa).repeat_interleave(K, dim=0) + b1
    e = h_E2 @ wb
    if mode == "dec":
        m1d, mbw = mask_att2[:, None], mbw2[:, None]
        x = x + m1d * e + mbw * g[:, :H] + m1d * g[:, H:]
    else:
        x = x + e + g
    m = gelu(gelu(x) @ w2 + b2) @ w3 + b3
    if mode == "enc_edge":
        return m
    if mode == "enc_node":
        m = m * mask_att2[:, None]
    return m.view(N, K, H).sum(dim=1) / MESSAGE_SCALE


def message_table_cuda(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                       wa, wb, b1, w2, b2, w3, b3, *, K, L):
    """Launch ``csrc/message_table.cu`` on fp32 CUDA tensors."""
    from ._build import library, ptr, stream_ptr

    N, H = h_V2.shape
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: choose from {sorted(MODES)}")
    if not 1 <= K <= MAX_K or H not in (32, 64, 128):
        raise ValueError(f"message kernel: K={K} (1..{MAX_K}), "
                         f"H={H} (32, 64 or 128) not supported")
    f32 = torch.float32
    C = 2 * H if mode == "dec" else H
    check_operand(h_V2, "h_V2", f32, (N, H))
    check_operand(h_E2, "h_E2", f32, (N * K, H))
    check_operand(table2, "table2", f32, (N, C))
    check_operand(eidx2, "eidx2", torch.int64, (N * K,))
    check_operand(mask_att2, "mask_att2", f32, (N * K,))
    check_operand(mbw2, "mbw2", f32, (N * K,))
    for name, w in (("wa", wa), ("wb", wb), ("w2", w2), ("w3", w3)):
        check_operand(w, name, f32, (H, H))
    for name, b in (("b1", b1), ("b2", b2), ("b3", b3)):
        check_operand(b, name, f32, (H,))
    out = torch.empty((N * K if mode == "enc_edge" else N, H), dtype=f32,
                      device=h_V2.device)
    fn = library("message_table").message_table_forward
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    tensors = (h_V2, h_E2, table2, eidx2, mask_att2, mbw2, wa, wb, b1, w2,
               b2, w3, b3, out)
    err = fn(MODES[mode], *[ptr(t) for t in tensors], N, K, L, H,
             stream_ptr(h_V2.device))
    raise_on_error(err, "message_table")
    LAUNCHES[f"message_table_{mode}"] += 1
    return out


def message_table(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                  wa, wb, b1, w2, b2, w3, b3, *, K, L):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    fn = message_table_cuda if h_V2.is_cuda else message_table_plain
    return fn(mode, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
              wa, wb, b1, w2, b2, w3, b3, K=K, L=L)


def _weights(p, H, w1, w2, w3):
    w = p[w1]["w"]
    return (w[:H], w[H:2 * H], p[w1]["b"], p[w2]["w"], p[w2]["b"],
            p[w3]["w"], p[w3]["b"])


def message_agg_table_flat(p, h_V2, h_E2, table2, eidx2, mask_att2, *, K, L,
                           plain=False):
    """Encoder node update (``W1..W3``): ``table2 = h_V2 @ W1c`` ``[N,H]`` ->
    dh ``[N,H]``."""
    fn = message_table_plain if plain else message_table
    ones = torch.ones_like(mask_att2)
    return fn("enc_node", h_V2, h_E2, table2, eidx2, mask_att2, ones,
              *_weights(p, h_V2.shape[1], "W1", "W2", "W3"), K=K, L=L)


def message_edge_table_flat(p, h_V2, h_E2, table2, eidx2, *, K, L,
                            plain=False):
    """Encoder edge update (``W11..W13``): ``table2 = h_V2 @ W11c`` -> per-edge
    message ``[N*K,H]``."""
    fn = message_table_plain if plain else message_table
    ones = torch.ones(h_E2.shape[0], dtype=h_E2.dtype, device=h_E2.device)
    return fn("enc_edge", h_V2, h_E2, table2, eidx2, ones, ones,
              *_weights(p, h_V2.shape[1], "W11", "W12", "W13"), K=K, L=L)


def message_dec_table_flat(p, h_V2, h_E2, table2, eidx2, m1d2, mbw2, *, K, L,
                           plain=False):
    """Parallel-decoder node update on the 2H table ``[A | B]``
    (``A = h_S@ws + h_V@wv - h_Venc@wv``, ``B = h_Venc@wv``) -> dh ``[N,H]``.
    ``mbw*A[j] + m1d*B[j]`` is the three-term causal context exactly,
    because ``mask_fw = mask_1d - mask_bw``."""
    fn = message_table_plain if plain else message_table
    return fn("dec", h_V2, h_E2, table2, eidx2, m1d2, mbw2,
              *_weights(p, h_V2.shape[1], "W1", "W2", "W3"), K=K, L=L)
