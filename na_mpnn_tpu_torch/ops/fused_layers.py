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

Both kernels run the message-table forward's tile walk
(``csrc/message_tile.cuh``: a persistent grid over 64-row tiles of
``table_tile_nodes(K)`` whole nodes, the products on the tensor cores, bf16
``mma.sync`` or 3xTF32 at fp32) with epilogues of their own; ``h_E2`` and
``table2`` must start 16-byte aligned. The edge update normalises from the
products' fragments. The node update is two launches in one call, split as
its plain version is: the message sum (``fused_node_message_plain``) into
an fp32 ``dh [N,H]`` scratch, then the tail (``fused_node_tail_plain``:
LN1, the feed-forward block on the tensor cores, LN2, the mask) over tiles
of ``tail_tile_rows`` nodes; it counts as one launch. Every output is the
same on every launch.

bf16 operands (the bf16 trunk's ``Trainer.eval_step``) select the TPU
kernels' bf16 branch: every product on bf16 operands summed in fp32, the
message sum (``dh``), both LayerNorms (statistics included) and the
feed-forward activations in fp32, bf16 outputs (``fused_layers.py:47-59``,
``:170``, ``:212``); the kernels' ``*_bf16`` entries, counted under
``<name>_bf16``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import check_aligned, check_operand, launch, raise_on_error
from .message_kernels import (_check_mode, _dtype_of, _weights, aligned_weights,
                              message_table_acc, table_tile_nodes)
from ..models.modules import layer_norm, pff_acc, widen

NODE_MODES = {"enc": ("enc_node", 0), "dec": ("dec", 2)}


def _node_mode(mode):
    if mode not in NODE_MODES:
        raise ValueError(f"mode {mode!r}: choose from {sorted(NODE_MODES)}")
    return NODE_MODES[mode]


def fused_node_message_plain(mode, p, h_V2, h_E2, table2, eidx2, mask_att2,
                             mbw2, *, K, L, Lk=None):
    """Plain version of the node update's message part (the kernel's first
    launch): ``dh [N,H]`` in the accumulation type (fp32 for bf16
    operands), unrounded, as the JAX kernel carries it into LN1."""
    msg_mode, _ = _node_mode(mode)
    mbw2 = mask_att2 if mbw2 is None else mbw2
    dh, _ = message_table_acc(msg_mode, h_V2, h_E2, table2, eidx2, mask_att2,
                              mbw2, *_weights(p, h_V2.shape[1], "W1", "W2", "W3"),
                              K=K, L=L, Lk=Lk)
    return dh


def fused_node_tail_plain(p, h_V2, dh, mask2):
    """Plain version of the node update's tail (the kernel's second
    launch): ``LN1(h_V + dh)``, the feed-forward block, ``LN2`` of the
    residual, times the node mask; ``[N,H]`` in ``h_V2``'s type."""
    low = h_V2.dtype == torch.bfloat16
    h = layer_norm(p["norm1"], widen(h_V2) + dh)
    h = layer_norm(p["norm2"], h + pff_acc(p["dense"], h, low))
    return (widen(mask2)[:, None] * h).to(h_V2.dtype)


def fused_node_update_plain(mode, p, h_V2, h_E2, table2, eidx2, mask_att2,
                            mbw2, mask2, *, K, L, Lk=None):
    """Plain version of the node-update kernel (same arguments, same
    output): the tail applied to the message part's dh."""
    dh = fused_node_message_plain(mode, p, h_V2, h_E2, table2, eidx2,
                                  mask_att2, mbw2, K=K, L=L, Lk=Lk)
    return fused_node_tail_plain(p, h_V2, dh, mask2)


def fused_edge_update_plain(p, h_V2, h_E2, table2, eidx2, *, K, L, Lk=None):
    """Plain version of the edge-update kernel (same arguments, same
    output)."""
    ones = torch.ones(h_E2.shape[0], dtype=h_E2.dtype, device=h_E2.device)
    m, _ = message_table_acc("enc_edge", h_V2, h_E2, table2, eidx2, ones, ones,
                             *_weights(p, h_V2.shape[1], "W11", "W12", "W13"),
                             K=K, L=L, Lk=Lk)
    return layer_norm(p["norm3"], widen(h_E2) + m).to(h_E2.dtype)


# Nodes per tile of the node update's tail (csrc/fused_layers.cu:
# node_tail_kernel<H, RB>, 16 * RB rows for RB in 4, 2, 1).
TAIL_ROWS = (64, 32, 16)


def tail_tile_rows(N, H, n_sm):
    """Nodes per tile of the node update's tail for N nodes on ``n_sm``
    SMs: of ``TAIL_ROWS`` those of at least ``2048 // H`` rows (each of the
    kernel's 16 warps owns 8 columns or more), the one whose persistent
    grid takes the fewest rounds, each round costed as ``rows + 16`` (a
    tile's fixed cost, the weights it streams, counted as 16 rows); a tie
    goes to the larger tile, which streams the weights fewer times."""
    best, best_cost = None, None
    for rows in TAIL_ROWS:
        if rows * H < 2048:
            continue
        cost = -(-N // (rows * n_sm)) * (rows + 16)
        if best_cost is None or cost < best_cost:
            best, best_cost = rows, cost
    return best


@functools.cache
def _entry(name, argtypes):
    """A kernel entry of ``csrc/fused_layers.cu`` with its ctypes
    signature (set once)."""
    from ._build import library
    fn = getattr(library("fused_layers"), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check_message_operands(h_V2, h_E2, table2, eidx2, N, K, L, Lk, C, H):
    dt, sfx = _dtype_of(h_V2)
    check_operand(h_V2, "h_V2", dt, (N, H))
    check_operand(h_E2, "h_E2", dt, (N * K, H))
    check_operand(table2, "table2", dt, (N // L * Lk, C))
    check_operand(eidx2, "eidx2", torch.int64, (N * K,))
    check_aligned(h_E2, "h_E2")
    check_aligned(table2, "table2")
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


_NODE_ARGS = ((ctypes.c_int,) + (ctypes.c_void_p,) * 24 + (ctypes.c_int,) * 8
              + (ctypes.c_void_p,))
_EDGE_ARGS = (ctypes.c_void_p,) * 14 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def fused_node_update_launch(mode, p, h_V2, h_E2, table2, eidx2, mask_att2,
                             mbw2, mask2, *, K, L, Lk=None):
    """The node-update kernel's two launches on CUDA tensors, all fp32 or
    all bf16 (parameters included) -> ``(out, dh)``, ``dh`` the fp32
    scratch between them (the message sum); counted once under
    ``fused_node_update_<mode>[_bf16]``. ``h_E2`` and ``table2`` must start
    16-byte aligned; weights that do not are copied here."""
    from ._build import ptr, stream_ptr

    with launch(f"fused_node_update_{mode}{_dtype_of(h_V2)[1]}"):
        msg_mode, code = _node_mode(mode)
        N, H = h_V2.shape
        Lk = L if Lk is None else Lk
        _check_mode(msg_mode, N, K, L, H)
        dev = h_V2.device
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
        wa, wb, w2, w3 = aligned_weights(wa, wb, w2, w3)
        w_in, = aligned_weights(d["W_in"]["w"])
        w_out, = aligned_weights(d["W_out"]["w"])
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        dh = torch.empty((N, H), dtype=torch.float32, device=dev)
        out = torch.empty((N, H), dtype=dt, device=dev)
        tensors = (h_V2, h_E2, table2, eidx2, mask_att2, mbw2, mask2, wa, wb, b1,
                   w2, b2, w3, b3, p["norm1"]["scale"], p["norm1"]["bias"],
                   w_in, d["W_in"]["b"], w_out, d["W_out"]["b"], p["norm2"]["scale"], p["norm2"]["bias"], dh, out)
        fn = _entry("fused_node_update" + sfx, _NODE_ARGS)
        err = fn(code, *[ptr(t) for t in tensors], N, K, L, Lk, H,
                 table_tile_nodes(K), n_sm, tail_tile_rows(N, H, n_sm), stream_ptr(dev))
        raise_on_error(err, "fused_node_update" + sfx)
        return out, dh


def fused_node_update_cuda(mode, p, h_V2, h_E2, table2, eidx2, mask_att2,
                           mbw2, mask2, *, K, L, Lk=None):
    """Launch the node-update kernel on CUDA tensors (both of its launches,
    ``fused_node_update_launch``) -> ``[N,H]``."""
    out, _ = fused_node_update_launch(mode, p, h_V2, h_E2, table2, eidx2,
                                      mask_att2, mbw2, mask2, K=K, L=L, Lk=Lk)
    return out


def fused_edge_update_cuda(p, h_V2, h_E2, table2, eidx2, *, K, L, Lk=None):
    """Launch the edge-update kernel on CUDA tensors, all fp32 or all bf16."""
    from ._build import ptr, stream_ptr

    with launch("fused_edge_update" + _dtype_of(h_V2)[1]):
        N, H = h_V2.shape
        Lk = L if Lk is None else Lk
        _check_mode("enc_edge", N, K, L, H)
        dt, sfx = _check_message_operands(h_V2, h_E2, table2, eidx2, N, K, L, Lk,
                                          H, H)
        _check_weights(p, H, ("W11", "W12", "W13"), ("norm3",), dt)
        wa, wb, b1, w2, b2, w3, b3 = _weights(p, H, "W11", "W12", "W13")
        wa, wb, w2, w3 = aligned_weights(wa, wb, w2, w3)
        dev = h_V2.device
        out = torch.empty((N * K, H), dtype=dt, device=dev)
        tensors = (h_V2, h_E2, table2, eidx2, wa, wb, b1, w2, b2, w3, b3,
                   p["norm3"]["scale"], p["norm3"]["bias"], out)
        fn = _entry("fused_edge_update" + sfx, _EDGE_ARGS)
        err = fn(*[ptr(t) for t in tensors], N, K, L, Lk, H, table_tile_nodes(K),
                 torch.cuda.get_device_properties(dev).multi_processor_count,
                 stream_ptr(dev))
        raise_on_error(err, "fused_edge_update" + sfx)
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
