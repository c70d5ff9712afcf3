"""Fused inference layer updates: CUDA kernels ``csrc/fused_layers.cu`` and
their plain PyTorch versions.

Replaces ``na_mpnn_tpu/ops/fused_layers.py::fused_node_update`` (the node
update of an encoder layer, and with ``has_static`` of a parallel-decoder
layer) and ``::fused_edge_update`` (the encoder's edge update). The TPU
kernels take a neighbour operand ``G [N*K,H]`` that XLA gathers before each
call; these take the message table's operands instead (``ops/
message_kernels.py``): ``h_V2 [N,H]``, ``h_E2 [N*K,H]``, a node table
``[B*Lk, C]`` read by global row ``(n // L) * Lk + eidx``, ``eidx2 [N*K]``
(int64) and per-edge masks ``[N*K]``. So they take any L and the
graph-parallel route's all-gathered table.

* ``fused_node_update("enc", ...)``: ``table2 = h_V@W1c`` (``C = H``);
  ``dh = sum_k(mask_att * m) / 30``;
* ``fused_node_update("dec", ...)``: ``table2 = [h_S@ws + h_V@wv -
  h_Venc@wv | h_Venc@wv]`` (``C = 2H``), ``mask_att2`` carries ``m1d`` and
  ``mbw2`` the backward-edge mask, no message mask;

then ``h = LN1(h_V + dh)``, ``h = LN2(h + FFN(h))``, ``out = mask2 * h``
``[N,H]``. ``fused_edge_update``: ``table2 = h_V@W11c``, ``out = LN3(h_E +
m)`` ``[N*K,H]`` with the ``W11..W13`` message ``m``. Layer parameters come
as the layer's dict (``W1..W3``, ``norm1``, ``dense``, ``norm2``; ``W11..W13``,
``norm3``). No gradient flows through the kernels: the model takes them
only for layers without dropout under no gradient (``models/mpnn.py``).

bf16 operands (the bf16 trunk's ``Trainer.eval_step``) select the TPU
kernels' bf16 branch: every product on bf16 operands summed in fp32, the
message sum, both LayerNorms (statistics included) and the feed-forward
activations in fp32, bf16 outputs (``fused_layers.py:47-59``, ``:170``,
``:212``); the kernels' ``*_bf16`` entries, counted under ``<name>_bf16``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_operand, raise_on_error
from .message_kernels import _check_mode, _dtype_of, _weights, message_table_acc
from ..models.modules import layer_norm, pff_acc, widen

NODE_MODES = {"enc": ("enc_node", 0), "dec": ("dec", 2)}


def _node_mode(mode):
    if mode not in NODE_MODES:
        raise ValueError(f"mode {mode!r}: choose from {sorted(NODE_MODES)}")
    return NODE_MODES[mode]


def fused_node_update_plain(mode, p, h_V2, h_E2, table2, eidx2, mask_att2,
                            mbw2, mask2, *, K, L, Lk=None):
    """Plain version of the node-update kernel (same arguments, same
    output)."""
    msg_mode, _ = _node_mode(mode)
    mbw2 = mask_att2 if mbw2 is None else mbw2
    low = h_V2.dtype == torch.bfloat16
    dh, _ = message_table_acc(msg_mode, h_V2, h_E2, table2, eidx2, mask_att2,
                              mbw2, *_weights(p, h_V2.shape[1], "W1", "W2", "W3"),
                              K=K, L=L, Lk=Lk)
    h = layer_norm(p["norm1"], widen(h_V2) + dh)
    h = layer_norm(p["norm2"], h + pff_acc(p["dense"], h, low))
    return (widen(mask2)[:, None] * h).to(h_V2.dtype)


def fused_edge_update_plain(p, h_V2, h_E2, table2, eidx2, *, K, L, Lk=None):
    """Plain version of the edge-update kernel (same arguments, same
    output)."""
    ones = torch.ones(h_E2.shape[0], dtype=h_E2.dtype, device=h_E2.device)
    m, _ = message_table_acc("enc_edge", h_V2, h_E2, table2, eidx2, ones, ones,
                             *_weights(p, h_V2.shape[1], "W11", "W12", "W13"),
                             K=K, L=L, Lk=Lk)
    return layer_norm(p["norm3"], widen(h_E2) + m).to(h_E2.dtype)


def node_tile(N, n_sm):
    """Nodes per block of the node-update kernel: 4 where that still gives
    each of the card's ``n_sm`` SMs a block, else 2."""
    return 4 if -(-N // 4) >= n_sm else 2


def _check_message_operands(h_V2, h_E2, table2, eidx2, N, K, L, Lk, C, H):
    dt, sfx = _dtype_of(h_V2)
    check_operand(h_V2, "h_V2", dt, (N, H))
    check_operand(h_E2, "h_E2", dt, (N * K, H))
    check_operand(table2, "table2", dt, (N // L * Lk, C))
    check_operand(eidx2, "eidx2", torch.int64, (N * K,))
    return dt, sfx


def _check_weights(p, H, names, norms, dt):
    w = p[names[0]]["w"]
    check_operand(w, f"{names[0]}.w", dt, (w.shape[0], H))
    check_operand(p[names[0]]["b"], f"{names[0]}.b", dt, (H,))
    for name in names[1:]:
        check_operand(p[name]["w"], f"{name}.w", dt, (H, H))
        check_operand(p[name]["b"], f"{name}.b", dt, (H,))
    for name in norms:
        for k in ("scale", "bias"):
            check_operand(p[name][k], f"{name}.{k}", dt, (H,))


def fused_node_update_cuda(mode, p, h_V2, h_E2, table2, eidx2, mask_att2,
                           mbw2, mask2, *, K, L, Lk=None):
    """Launch the node-update kernel on CUDA tensors, all fp32 or all bf16
    (parameters included)."""
    from ._build import library, ptr, stream_ptr

    msg_mode, code = _node_mode(mode)
    N, H = h_V2.shape
    Lk = L if Lk is None else Lk
    _check_mode(msg_mode, N, K, L, H)
    dev = h_V2.device
    tile = node_tile(N, torch.cuda.get_device_properties(dev).multi_processor_count)
    mbw2 = mask_att2 if mbw2 is None else mbw2
    dt, sfx = _check_message_operands(h_V2, h_E2, table2, eidx2, N, K, L, Lk,
                                      2 * H if mode == "dec" else H, H)
    check_operand(mask_att2, "mask_att2", dt, (N * K,))
    check_operand(mbw2, "mbw2", dt, (N * K,))
    check_operand(mask2, "mask2", dt, (N,))
    _check_weights(p, H, ("W1", "W2", "W3"), ("norm1", "norm2"), dt)
    d = p["dense"]
    check_operand(d["W_in"]["w"], "dense.W_in.w", dt, (H, 4 * H))
    check_operand(d["W_in"]["b"], "dense.W_in.b", dt, (4 * H,))
    check_operand(d["W_out"]["w"], "dense.W_out.w", dt, (4 * H, H))
    check_operand(d["W_out"]["b"], "dense.W_out.b", dt, (H,))
    wa, wb, b1, w2, b2, w3, b3 = _weights(p, H, "W1", "W2", "W3")
    out = torch.empty((N, H), dtype=dt, device=dev)
    fn = getattr(library("fused_layers"), "fused_node_update" + sfx)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 23
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    tensors = (h_V2, h_E2, table2, eidx2, mask_att2, mbw2, mask2, wa, wb, b1,
               w2, b2, w3, b3, p["norm1"]["scale"], p["norm1"]["bias"],
               d["W_in"]["w"], d["W_in"]["b"], d["W_out"]["w"], d["W_out"]["b"],
               p["norm2"]["scale"], p["norm2"]["bias"], out)
    err = fn(code, *[ptr(t) for t in tensors], N, K, L, Lk, H, tile,
             stream_ptr(dev))
    raise_on_error(err, "fused_node_update" + sfx)
    LAUNCHES[f"fused_node_update_{mode}{sfx}"] += 1
    return out


def fused_edge_update_cuda(p, h_V2, h_E2, table2, eidx2, *, K, L, Lk=None):
    """Launch the edge-update kernel on CUDA tensors, all fp32 or all
    bf16."""
    from ._build import library, ptr, stream_ptr

    N, H = h_V2.shape
    Lk = L if Lk is None else Lk
    _check_mode("enc_edge", N, K, L, H)
    dt, sfx = _check_message_operands(h_V2, h_E2, table2, eidx2, N, K, L, Lk,
                                      H, H)
    _check_weights(p, H, ("W11", "W12", "W13"), ("norm3",), dt)
    wa, wb, b1, w2, b2, w3, b3 = _weights(p, H, "W11", "W12", "W13")
    out = torch.empty((N * K, H), dtype=dt, device=h_V2.device)
    fn = getattr(library("fused_layers"), "fused_edge_update" + sfx)
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tensors = (h_V2, h_E2, table2, eidx2, wa, wb, b1, w2, b2, w3, b3,
               p["norm3"]["scale"], p["norm3"]["bias"], out)
    err = fn(*[ptr(t) for t in tensors], N, K, L, Lk, H, stream_ptr(h_V2.device))
    raise_on_error(err, "fused_edge_update" + sfx)
    LAUNCHES["fused_edge_update" + sfx] += 1
    return out


def fused_node_update(mode, p, h_V2, h_E2, table2, eidx2, mask_att2, mbw2,
                      mask2, *, K, L, Lk=None):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    fn = fused_node_update_cuda if h_V2.is_cuda else fused_node_update_plain
    return fn(mode, p, h_V2, h_E2, table2, eidx2, mask_att2, mbw2, mask2,
              K=K, L=L, Lk=Lk)


def fused_edge_update(p, h_V2, h_E2, table2, eidx2, *, K, L, Lk=None):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    fn = fused_edge_update_cuda if h_V2.is_cuda else fused_edge_update_plain
    return fn(p, h_V2, h_E2, table2, eidx2, K=K, L=L, Lk=Lk)
