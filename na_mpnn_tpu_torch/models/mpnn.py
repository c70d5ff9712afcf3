"""NA-MPNN: the training forward, encoder, teacher-forced scoring,
unconditional probs and autoregressive sampling (one structure, many
structures in one batch, and symmetry-tied positions).

Port of the JAX package's ``models/mpnn.py``. ``enc_layer`` and
``dec_layer`` are the layers of every route: one device here, and the
graph-parallel forward (``parallel/graph_parallel.py``), which hands them an
all-gather of the node tables and its own dropout source. A layer takes one
of three routes:

* a layer that applies no dropout and through which no gradient is wanted
  (every inference entry point, ``Trainer.eval_step``, a no-grad
  ``forward`` or ``forward_graph_parallel``) runs the fused kernels
  (``ops/fused_layers.py``): the whole node update in one launch, and in the
  encoder the edge update in a second, whatever L is;
* a decoder layer with dropout or a gradient on one device at
  ``L % 32 != 0`` (a batch collated with ``use_buckets=False``) takes the
  gathered route, as the JAX training decoder does at such L: the causal
  context gathered in PyTorch, then the pre-gathered message MLP with its
  autograd Function (``ops/message_kernels.py::message_agg_batched``);
* otherwise (every encoder layer with dropout or a gradient, the decoder at
  ``L % 32 == 0``, and every layer of the graph-parallel route) the message
  MLP runs on the message-table kernel with its autograd Function, at any L.

Off the fused route the layer norms, the feed-forward block and dropout are
plain PyTorch around the message kernel. With ``remat`` other than
``"none"`` (JAX ``mpnn.py:166-205``, ``:405-420``) those tails are
recomputed in the backward (``_tail``): autograd keeps the message
kernels' outputs and their saved ``x``, as JAX's ``"msg_kernel_out"``
policy does, and the dropout masks are drawn before the recomputed region
from the layers' own generator, so the loss and the gradient are bitwise
those of ``remat="none"``.

The node-level products (``h_V @ wc``, ``h_S @ ws``, ``h_V @ wv``) that make
the tables the kernels gather from are plain PyTorch on every route.

``compute_dtype="bfloat16"`` (the JAX training default) runs the trunk in
bf16 as the JAX package does (``mpnn.py:131-142``, ``:280-290``,
``:456-457``): parameters stay fp32 and are cast on the way in (the
encoder's and decoder's layers; ``W_v``, ``W_e``, ``W_s`` and ``W_out`` stay
fp32), ``h_V``, ``h_E``, ``h_S`` and the masks enter the layers as bf16,
LayerNorm statistics are fp32, and ``h_V`` returns to fp32 before
``W_out``; the kernels take their bf16 variants on every route. (The
graph-parallel forward keeps its layers in fp32 at G > 1, as JAX does;
``parallel/graph_parallel.py``.) A
``torch.Generator`` turns on training randomness (dropout, coordinate
noise), ``None`` makes them deterministic; the inference entry points run
under ``torch.no_grad``. The autoregressive samplers are plain PyTorch, as
they are plain XLA in the JAX package; on a card ``sample`` and
``sample_multi`` replay their decode step as one CUDA graph, as the JAX
package runs its loop as one ``lax.scan``.

Sampling draws the decode order as ``argsort((chain_mask + 1e-4) * |randn|)``
and tokens as ``argmax(log(p + 1e-30) + Gumbel)`` (what
``jax.random.categorical`` computes), with noise from a ``torch.Generator``;
``sample`` and ``sample_multi`` also take the Gumbel noise ``[L,B,
num_letters]`` (indexed by decode step) and ``batch["decoding_order"]`` from
the caller, ``sample_tied`` the noise ``[G,B,num_letters]`` of its G decode
groups.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants, trace
from ..ops import fused_layers as fl
from ..ops import message_kernels as mk
from .config import ModelConfig, check_supported
from .features import features_apply, init_features
from .modules import (MESSAGE_SCALE, _message_tail, _split_w1,
                      cast_tree, cat_neighbors_nodes, dec_layer_apply, dropout,
                      gather_nodes, init_dec_layer, init_enc_layer,
                      init_linear, layer_norm, linear,
                      pff_apply, take_rows, widen)

# Token ints zeroed out during sampling (UNK, DX, RX, MAS, PAD).
_OMIT_ALWAYS = [
    constants.RESTYPE_TO_INT["UNK"], constants.RESTYPE_TO_INT["DX"],
    constants.RESTYPE_TO_INT["RX"], constants.RESTYPE_TO_INT["MAS"],
    constants.RESTYPE_TO_INT["PAD"],
]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg: ModelConfig, device="cuda",
                dtype=torch.float32):
    """Random parameters (xavier-uniform weights, zero biases, unit-normal
    token embedding) drawn with numpy from ``seed``, in the JAX layout."""
    from ..params import from_jax_params

    rng = np.random.default_rng(seed)
    H = cfg.hidden_dim
    tree = {
        "features": init_features(rng, cfg),
        "W_v": init_linear(rng, cfg.node_features, H),
        "W_e": init_linear(rng, cfg.edge_features, H),
        "W_s": {"emb": rng.standard_normal((cfg.vocab, H)).astype(np.float32)},
        "W_out": init_linear(rng, H, cfg.num_letters),
        "encoder": [init_enc_layer(rng, H, 2 * H)
                    for _ in range(cfg.num_encoder_layers)],
        "decoder": [init_dec_layer(rng, H, 3 * H)
                    for _ in range(cfg.num_decoder_layers)],
    }
    return from_jax_params(tree, device=device, dtype=dtype)


class _EmbedTokens(torch.autograd.Function):
    """``emb[S]``, whose gradient is the one-hot product
    ``one_hot(S, vocab)^T @ g`` summed in fp32 (float64 for float64): the
    gradient of JAX's ``emb[S]`` (``mpnn.py:66``), the same on every launch.
    PyTorch's own backward of the gather adds the rows with atomics on the
    card, in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, emb, S):
        ctx.save_for_backward(S)
        ctx.vocab, ctx.dtype = emb.shape[0], emb.dtype
        return emb[S]

    @staticmethod
    def backward(ctx, g):
        (S,) = ctx.saved_tensors
        acc = torch.promote_types(g.dtype, torch.float32)
        one_hot = F.one_hot(S.reshape(-1), ctx.vocab).to(acc)
        return (one_hot.T @ g.reshape(-1, g.shape[-1]).to(acc)).to(ctx.dtype), None


def gather_order(E_idx):
    """The edges of ``E_idx [B,L,K]`` grouped by the node they read, for
    ``_GatherNodes``'s backward: (``order [B*L*K]``, the flat edges sorted
    stably by that node, as ``mk.table_order`` sorts them for the
    message-table backward; ``lengths [B*L]``, each node's in-degree)."""
    B, L, K = E_idx.shape
    order, offsets = mk.table_order(E_idx.reshape(-1), K, L, L, B * L)
    return order, offsets[1:] - offsets[:-1]


class _GatherNodes(torch.autograd.Function):
    """``gather_nodes(x, E_idx)``, whose gradient sums each node's incoming
    rows in a fixed order: the cotangent's rows in ``gather_order``,
    widened to fp32 (float64 for float64), then one segment sum a node
    (``torch.segment_reduce``, a pass over each segment with no atomics),
    a third of the columns at a time (the widened copy stays small). It
    equals the gradient of JAX's gather and is the same on every launch;
    PyTorch's own backward of the gather adds the rows with atomics on the
    card, in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, x, E_idx, order, lengths):
        ctx.save_for_backward(order, lengths)
        ctx.shape = x.shape
        return gather_nodes(x, E_idx)

    @staticmethod
    def backward(ctx, g):
        order, lengths = ctx.saved_tensors
        B, L, C = ctx.shape
        acc = torch.promote_types(g.dtype, torch.float32)
        g2 = g.reshape(-1, C)
        out = torch.empty((B * L, C), dtype=acc, device=g.device)
        cols = [C * i // 3 for i in range(4)]
        for a, b in zip(cols, cols[1:]):
            out[:, a:b] = torch.segment_reduce(
                g2[:, a:b][order].to(acc), "sum", lengths=lengths, axis=0,
                unsafe=True)
        return out.to(g.dtype).view(B, L, C), None, None, None


def embed_tokens(p, S):
    """The token embedding ``W_s.emb[S]``; through ``_EmbedTokens`` when a
    gradient is wanted."""
    emb, S = p["W_s"]["emb"], S.long()
    if torch.is_grad_enabled() and emb.requires_grad:
        return _EmbedTokens.apply(emb, S)
    return emb[S]


# ---------------------------------------------------------------------------
# Decode-order machinery
# ---------------------------------------------------------------------------

def sample_decoding_order(chain_mask, generator: torch.Generator):
    """Random decode order: stable ascending argsort of
    ``(chain_mask + 1e-4) * |randn|`` (fixed positions decode first)."""
    randn = torch.randn(chain_mask.shape, generator=generator,
                        dtype=chain_mask.dtype, device=chain_mask.device)
    return torch.argsort((chain_mask + 0.0001) * randn.abs(), dim=-1,
                         stable=True)


def decode_rank(decoding_order):
    """``rank[i]`` = step at which position i decodes."""
    return torch.argsort(decoding_order, dim=-1)


def autoregressive_edge_masks(decoding_order, E_idx, mask):
    """(``mask_bw``, ``mask_fw``) ``[B,L,K,1]``: edge j -> i carries sequence
    context iff j decodes strictly before i."""
    rank = decode_rank(decoding_order)
    attend = (take_rows(rank, E_idx) < rank[:, :, None]).to(mask.dtype)[..., None]
    mask_1d = mask[:, :, None, None]
    return mask_1d * attend, mask_1d * (1.0 - attend)


# ---------------------------------------------------------------------------
# Encoder and parallel decoder
# ---------------------------------------------------------------------------

def _plain(cfg: ModelConfig, X) -> bool:
    """True when the plain versions run instead of the kernel wrappers."""
    if cfg.kernels == "cuda" and not X.is_cuda:
        raise ValueError("kernels='cuda' needs the batch on a CUDA device")
    return cfg.kernels == "torch"


def _identity(x):
    return x


def _no_dropout(x, slot):
    return x


def generator_dropout(rate, generator):
    """The one-device dropout source of the layers: ``drop(x, slot)`` draws
    its mask from ``generator``; None (no dropout) when ``generator`` is
    None or ``rate`` is 0. ``drop.rate`` is the rate (``_tail`` reads
    it)."""
    if generator is None or rate <= 0.0:
        return None

    def drop(x, slot):
        return dropout(x, rate, generator)
    drop.rate = rate
    return drop


# ---------------------------------------------------------------------------
# Per-layer rematerialisation (``remat != "none"``)
# ---------------------------------------------------------------------------

def _node_tail(p, h_V, dh, mask, drop):
    """A layer's node tail: LN1 of the residual with the (dropped, slot 0)
    message, the FFN with its (dropped, slot 1) output, LN2, the node
    mask."""
    h_V = layer_norm(p["norm1"], h_V + drop(dh, 0))
    h_V = layer_norm(p["norm2"], h_V + drop(pff_apply(p["dense"], h_V), 1))
    return mask[..., None] * h_V


def _edge_tail(p, h_E2, m, drop):
    """The encoder's edge tail: LN3 of the residual with the (dropped, slot
    2) edge message ``m [B,L,K*H]``."""
    return layer_norm(p["norm3"], h_E2 + drop(m, 2).view(h_E2.shape))


def _tail(tail, remat, drop, like, *args):
    """``tail(*args, drop)``; with ``remat`` under ``torch.utils.checkpoint``:
    autograd keeps the tail's inputs (the message kernel's output among
    them; the kernel's Function keeps its saved ``x`` as ever) and
    recomputes the LayerNorms, the FFN and the dropout in the backward.
    ``like`` maps each dropout slot of the tail to a tensor of the shape and
    type it drops; the keep masks are drawn here, before the checkpointed
    region and in slot order, through ``drop`` itself (``drop(ones) != 0``:
    the draws the tail makes without remat, in the same order, so the loss
    and the gradient are bitwise those of ``remat="none"``), and the
    recomputation reads them and draws nothing: ``preserve_rng_state``
    would restore only the default generators, not the explicit
    ``torch.Generator``s the layers draw from."""
    if drop is None:
        drop = _no_dropout
    if not remat:
        return tail(*args, drop)
    from torch.utils.checkpoint import checkpoint

    fixed = drop
    if drop is not _no_dropout:
        kept = {slot: drop(torch.ones_like(x), slot) != 0 for slot, x in like.items()}
        keep = 1.0 - drop.rate

        def fixed(x, slot):   # the expression of modules.dropout, row_dropout
            return torch.where(kept[slot], x / keep, 0.0)
    return checkpoint(tail, *args, fixed, use_reentrant=False,
                      preserve_rng_state=False)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _wants_grad(p, *tensors) -> bool:
    """True when a gradient is wanted through a layer: grad mode is on and an
    input or a parameter requires one."""
    if not torch.is_grad_enabled():
        return False
    return (any(t.requires_grad for t in tensors)
            or any(leaf.requires_grad for leaf in _leaves(p)))


def fused_route(drop, p, *tensors) -> bool:
    """True when a layer runs the fused kernels: it applies no dropout
    (``drop`` is None) and no gradient is wanted through it. Never depends
    on L."""
    return drop is None and not _wants_grad(p, *tensors)


def table_order(eidx2, K, L, Lk, plain, layers, *tensors):
    """The message-table backward's edge order (``mk.table_order``), sorted
    once for the ``layers`` of a stack that share ``eidx2`` and passed to
    each of them; None where no backward kernel runs (the plain versions,
    CPU tensors, or no gradient wanted through the stack's first layer)."""
    if (plain or not layers or not tensors[0].is_cuda
            or not _wants_grad(layers[0], *tensors)):
        return None
    return mk.table_order(eidx2, K, L, Lk, eidx2.shape[0] // (K * L) * Lk)


def enc_layer(p, h_V, h_E2, eidx2, mask_att2, mask, drop=None,
              gather=_identity, plain=False, order=None, remat=False):
    """One encoder layer on flat edges: the node update (``W1..W3``, LN1,
    FFN, LN2, mask), then the edge update (``W11..W13``, LN3). ``h_V
    [B,L,H]``, ``h_E2 [B*L*K,H]``; ``drop(x, slot)``, where given, applies
    dropout to the node message (slot 0), the FFN output (1) and the edge
    message (2, as ``[B,L,K*H]``); ``gather`` turns a node table ``[B,L,C]``
    into the rows that ``eidx2`` indexes (identity on one device, the
    graph-axis all-gather on the graph-parallel route); ``order`` is the
    stack's ``table_order`` for the message-table backward. On the fused
    route (``fused_route``) two launches, else two message-table launches
    with the tail in PyTorch; with ``remat`` each tail (LN1, FFN, LN2; LN3)
    is recomputed in the backward (``_tail``). Returns (``h_V``,
    ``h_E2``)."""
    B, L, H = h_V.shape
    N = B * L
    K = h_E2.shape[0] // N
    h_V2 = h_V.reshape(N, H)
    table = gather((h_V2 @ p["W1"]["w"][2 * H:]).view(B, L, H))
    Lk = table.shape[1]
    if fused_route(drop, p, h_V, h_E2):
        node = fl.fused_node_update_plain if plain else fl.fused_node_update
        edge = fl.fused_edge_update_plain if plain else fl.fused_edge_update
        h_V2 = node("enc", p, h_V2, h_E2, table.reshape(B * Lk, H), eidx2,
                    mask_att2, None, mask.reshape(N), K=K, L=L, Lk=Lk)
        table = gather((h_V2 @ p["W11"]["w"][2 * H:]).view(B, L, H))
        h_E2 = edge(p, h_V2, h_E2, table.reshape(B * Lk, H), eidx2, K=K, L=L,
                    Lk=Lk)
        return h_V2.view(B, L, H), h_E2
    dh = mk.message_agg_table_flat(p, h_V2, h_E2, table.reshape(B * Lk, H),
                                   eidx2, mask_att2, K=K, L=L, Lk=Lk,
                                   plain=plain, order=order).view(B, L, H)
    h_V = _tail(_node_tail, remat, drop, {0: dh, 1: h_V}, p, h_V, dh, mask)
    h_V2 = h_V.reshape(N, H)
    table = gather((h_V2 @ p["W11"]["w"][2 * H:]).view(B, L, H))
    m = mk.message_edge_table_flat(p, h_V2, h_E2, table.reshape(B * Lk, H),
                                   eidx2, K=K, L=L, Lk=Lk, plain=plain,
                                   order=order).view(B, L, K * H)
    return h_V, _tail(_edge_tail, remat, drop, {2: m}, p, h_E2, m)


def dec_layer(p, h_V, h_V_enc, h_S, h_E2, eidx2, m1d2, mbw2, mask, drop=None,
              gather=_identity, plain=False, order=None, remat=False):
    """One parallel-decoder layer: a 2H node table ``[h_S@ws + h_V@wv -
    h_Venc@wv | h_Venc@wv]`` replaces the ``[B,L,K,3H]`` causal context
    (``mbw*A[j] + m1d*B[j]`` is the three-term context exactly, because
    ``mask_fw = mask_1d - mask_bw``); then LN1, FFN, LN2, mask: one fused
    launch on the fused route, else the message-table kernel (dec mode) and
    the tail in PyTorch. On one device (``gather`` the identity) a layer with
    dropout or a gradient at ``L % 32 != 0`` takes the gathered route
    instead: the ``[B,L,K,H]`` causal context and edge term gathered in
    PyTorch into the pre-gathered message MLP (``mk.message_agg_batched``),
    as the JAX training decoder does at such L; there ``order`` is the
    stack's ``gather_order`` (the context gather's backward through
    ``_GatherNodes``) or None (a plain gather). ``drop``, ``gather``,
    ``order`` and ``remat`` otherwise as in ``enc_layer`` (slots 0 and
    1)."""
    B, L, H = h_V.shape
    N = B * L
    K = h_E2.shape[0] // N
    (_, wb, ws, wv), _ = _split_w1(p, H)
    fused = fused_route(drop, p, h_V, h_V_enc, h_S, h_E2)
    if not fused and gather is _identity and not mk.table_gather_ok(L):
        # The gathered route (JAX ``edge_context`` + ``message_agg_batched``,
        # mpnn.py:303-316, 383-387): the three neighbour terms through one
        # gather, ``mask_fw = mask_1d - mask_bw`` exactly (0/1 masks); at
        # bf16 the context and the edge term are bf16 tensors, as JAX's.
        E_idx = eidx2.reshape(B, L, K)
        mbw, m1d = mbw2.reshape(B, L, K, 1), m1d2.reshape(B, L, K, 1)
        nodes = torch.cat([h_S @ ws, h_V @ wv, h_V_enc @ wv], dim=-1)
        g = (gather_nodes(nodes, E_idx) if order is None
             else _GatherNodes.apply(nodes, E_idx, *order))
        ctx = mbw * (g[..., :H] + g[..., H:2 * H]) + (m1d - mbw) * g[..., 2 * H:]
        e_term = m1d * (h_E2.view(B, L, K, H) @ wb)
        dh = mk.message_agg_batched(p, h_V, ctx, e_term,
                                    torch.ones_like(m1d2), contract_e=False,
                                    plain=plain)
    else:
        venc = h_V_enc @ wv
        table = gather(torch.cat([h_S @ ws + h_V @ wv - venc, venc], dim=-1))
        Lk = table.shape[1]
        if fused:
            node = fl.fused_node_update_plain if plain else fl.fused_node_update
            return node("dec", p, h_V.reshape(N, H), h_E2,
                        table.reshape(B * Lk, 2 * H), eidx2, m1d2, mbw2,
                        mask.reshape(N), K=K, L=L, Lk=Lk).view(B, L, H)
        dh = mk.message_dec_table_flat(p, h_V.reshape(N, H), h_E2,
                                       table.reshape(B * Lk, 2 * H), eidx2,
                                       m1d2, mbw2, K=K, L=L, Lk=Lk, plain=plain,
                                       order=order)
    dh = dh.view(B, L, H)
    return _tail(_node_tail, remat, drop, {0: dh, 1: h_V}, p, h_V, dh, mask)


def encode(params, cfg: ModelConfig, batch, generator=None):
    """Features + encoder stack -> (``h_V [B,L,H]``, ``h_E [B,L,K,H]``,
    ``E_idx [B,L,K]``). Edge tensors stay flat ``[N*K,H]`` through the
    stack; each layer makes two launches (fused or message-table, see
    ``enc_layer``). With a ``generator`` the layers apply dropout (on the
    node message, the FFN output and the edge message, as
    ``_enc_layer_train_fused``) and the features coordinate noise. With
    ``cfg.remat`` other than ``"none"`` a layer off the fused route
    recomputes its tails in the backward (``enc_layer``)."""
    with trace.span("model.encode", rows=batch["X"].shape[0]):
        check_supported(cfg)
        plain = _plain(cfg, batch["X"])
        mask = batch["mask"].to(batch["X"].dtype)
        V, E, E_idx, mask_attend = features_apply(params["features"], cfg, batch,
                                                  plain, generator)
        h_V = linear(params["W_v"], V)
        h_E = linear(params["W_e"], E)
        layers, h_V, h_E, mask, mask_attend = to_trunk(
            _trunk_dtype(cfg), params["encoder"], h_V, h_E, mask, mask_attend)
        B, L, K = E_idx.shape
        H = h_V.shape[-1]
        h_E2 = h_E.reshape(B * L * K, H)
        eidx2 = E_idx.reshape(-1)
        mask_att2 = mask_attend.reshape(-1)
        drop = generator_dropout(cfg.dropout, generator)
        order = table_order(eidx2, K, L, L, plain, layers, h_V, h_E2)
        for p in layers:
            h_V, h_E2 = enc_layer(p, h_V, h_E2, eidx2, mask_att2, mask, drop,
                                  plain=plain, order=order, remat=_remat(cfg))
        return h_V, h_E2.view(B, L, K, H), E_idx


def _remat(cfg: ModelConfig) -> bool:
    """Per-layer rematerialisation: any ``remat`` but ``"none"``, as the
    JAX package tests it."""
    return cfg.remat != "none"


def _trunk_dtype(cfg: ModelConfig):
    """bf16 for the bf16 trunk, else None (the layers run in the input
    type)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def to_trunk(cdt, layers, *tensors):
    """The bf16 trunk's casts, shared by every forward: with ``cdt`` the
    layer parameters and the activations and masks that enter the layers
    go to it (the layers keep their LayerNorm statistics in fp32, and
    ``_logits`` runs ``W_out`` in fp32); with None nothing changes. Returns
    ``(layers, *tensors)``."""
    if cdt is None:
        return (layers, *tensors)
    return (cast_tree(layers, cdt), *(t.to(cdt) for t in tensors))


def _logits(params, h_V):
    """``W_out`` on the decoder's output, in fp32 for a bf16 trunk."""
    if h_V.dtype == torch.bfloat16:
        h_V = h_V.float()
    return linear(params["W_out"], h_V)


def _decoder_parallel(params, cfg, h_V, h_E, E_idx, mask, h_S, mask_bw,
                      generator=None):
    """Teacher-forced decoder stack (``dec_layer``). With a ``generator``,
    dropout on the node message and the FFN output (``run_layer_kernel``)."""
    plain = _plain(cfg, h_V)
    B, L, K = E_idx.shape
    layers, h_V, h_E, h_S, mask, mask_bw = to_trunk(
        _trunk_dtype(cfg), params["decoder"], h_V, h_E, h_S, mask, mask_bw)
    h_E2 = h_E.reshape(B * L * K, -1)
    eidx2 = E_idx.reshape(-1)
    m1d2 = mask[:, :, None].expand(B, L, K).reshape(-1)
    mbw2 = mask_bw.reshape(-1)
    drop = generator_dropout(cfg.dropout, generator)
    # at L % 32 != 0 a layer with a gradient takes the gathered route, whose
    # context gather sums its gradient in the order of gather_order
    if mk.table_gather_ok(L):
        order = table_order(eidx2, K, L, L, plain, layers, h_V, h_E2, h_S)
    elif layers and _wants_grad(layers[0], h_V, h_E2, h_S):
        order = gather_order(E_idx)
    else:
        order = None
    h_V_enc = h_V
    for p in layers:
        h_V = dec_layer(p, h_V, h_V_enc, h_S, h_E2, eidx2, m1d2, mbw2, mask,
                        drop, plain=plain, order=order, remat=_remat(cfg))
    return h_V


def forward(params, cfg: ModelConfig, batch, generator=None):
    """Training forward -> (``log_probs``, ``probs``), both
    ``[B,L,num_letters]`` (JAX ``mpnn.forward``). ``generator`` draws the
    coordinate noise, the dropout masks and the decode order; with None the
    pass is deterministic (evaluation) and the decode order comes from seed
    0. ``batch["decoding_order"]``, where given, is the decode order."""
    mask = batch["mask"].to(batch["X"].dtype)
    h_V, h_E, E_idx = encode(params, cfg, batch, generator)
    h_S = embed_tokens(params, batch["S"])
    chain_M = mask
    if cfg.decode_protein_first:
        chain_M = chain_M * (1.0 - batch["protein_mask"].to(mask.dtype))
    if "decoding_order" in batch:
        decoding_order = batch["decoding_order"]
    else:
        order_gen = generator
        if order_gen is None:
            order_gen = torch.Generator(device=mask.device).manual_seed(0)
        decoding_order = sample_decoding_order(chain_M, order_gen)
    mask_bw, _ = autoregressive_edge_masks(decoding_order, E_idx, mask)
    h_V = _decoder_parallel(params, cfg, h_V, h_E, E_idx, mask, h_S, mask_bw,
                            generator)
    logits = _logits(params, h_V)
    return torch.log_softmax(logits, dim=-1), torch.softmax(logits, dim=-1)


@torch.no_grad()
def score(params, cfg: ModelConfig, batch, decoding_order=None,
          generator: Optional[torch.Generator] = None):
    """Teacher-forced scoring of ``batch["S"]`` under a given or random
    decode order -> {"S", "log_probs", "decoding_order"}."""
    mask = batch["mask"].to(batch["X"].dtype)
    chain_mask = mask * batch["chain_mask"].to(mask.dtype)
    h_V, h_E, E_idx = encode(params, cfg, batch)
    if decoding_order is None:
        decoding_order = sample_decoding_order(chain_mask, generator)
    mask_bw, _ = autoregressive_edge_masks(decoding_order, E_idx, mask)
    h_S = embed_tokens(params, batch["S"])
    h_V = _decoder_parallel(params, cfg, h_V, h_E, E_idx, mask, h_S, mask_bw)
    logits = _logits(params, h_V)
    return {"S": batch["S"], "log_probs": torch.log_softmax(logits, dim=-1),
            "decoding_order": decoding_order}


@torch.no_grad()
def unconditional_probs(params, cfg: ModelConfig, batch):
    """Decoder with zero sequence context everywhere: the parallel decoder
    with ``h_S = 0`` and no backward edge (``mask_bw = 0``), so each layer
    sees ``mask_1d * cat(h_E, 0, h_Venc_j)``."""
    mask = batch["mask"].to(batch["X"].dtype)
    h_V, h_E, E_idx = encode(params, cfg, batch)
    zeros_bw = torch.zeros(E_idx.shape + (1,), dtype=h_V.dtype, device=h_V.device)
    h_V = _decoder_parallel(params, cfg, h_V, h_E, E_idx, mask,
                            torch.zeros_like(h_V), zeros_bw)
    logits = _logits(params, h_V)
    return {"log_probs": torch.log_softmax(logits, dim=-1)}


# ---------------------------------------------------------------------------
# Autoregressive sampling
# ---------------------------------------------------------------------------

def _pair_bias_step(pair_bias_ctx, t, S):
    """Neighbour pair bias at decode positions ``t [B]`` from the adjacency
    diagonal: ``u[t]*P[a, S[t+1]] + l[t-1]*P[S[t-1], a]``."""
    P, u_diag = pair_bias_ctx["pair_bias_AA"], pair_bias_ctx["u_diag"]
    B, L = S.shape
    if u_diag.dim() == 1:
        u_diag = u_diag.expand(B, -1)
    b_idx = torch.arange(B, device=S.device)
    t_next = torch.clamp(t + 1, max=L - 1)
    t_prev = torch.clamp(t - 1, min=0)
    S_next = S[b_idx, t_next]
    S_prev = S[b_idx, t_prev]
    u_t = u_diag[b_idx, torch.clamp(t, max=L - 2)] * (t < L - 1)
    l_t = u_diag[b_idx, torch.clamp(t - 1, min=0)] * (t > 0)
    fwd = u_t[:, None] * P[:, S_next].T
    bwd = l_t[:, None] * P[S_prev, :]
    return fwd + bwd


@torch.no_grad()
def sample(params, cfg: ModelConfig, batch, generator: Optional[torch.Generator],
           num_samples: int = 1, temperature=0.1, bias=None,
           pair_bias_ctx=None, gumbel=None):
    """Autoregressive sampling -> {"S", "sampling_probs", "log_probs",
    "decoding_order"}, all ``[num_samples, L, ...]``. The structure is
    encoded once and tiled to the decode batch; each replica draws its own
    decode order unless ``batch["decoding_order"]`` is given. ``bias`` is
    ``[L,nl]`` or ``[num_samples,L,nl]``; ``gumbel`` (optional) is the noise
    ``[L, num_samples, nl]`` of each decode step."""
    L = batch["S"].shape[-1]
    B = num_samples
    h_V0, h_E, E_idx = encode(params, cfg, batch)
    h_V0, h_E = widen(h_V0), widen(h_E)    # the fp32 sampler of a bf16 trunk
    h_V0 = h_V0[0].expand(B, *h_V0.shape[1:])
    h_E = h_E[0].expand(B, *h_E.shape[1:])
    E_idx = E_idx[0].expand(B, *E_idx.shape[1:])
    mask = batch["mask"][0].to(h_V0.dtype).expand(B, L)
    chain_mask = mask * batch["chain_mask"][0].to(h_V0.dtype).expand(B, L)
    S_true = batch["S"][0].long().expand(B, L)
    if "decoding_order" in batch:
        decoding_order = batch["decoding_order"].expand(B, L)
    else:
        decoding_order = sample_decoding_order(chain_mask, generator)
    if bias is not None:
        bias = bias.expand(B, L, cfg.num_letters)
    return _sample_scan(params, cfg, h_V0, h_E, E_idx, mask, chain_mask,
                        S_true, decoding_order, temperature, bias,
                        pair_bias_ctx, generator, gumbel)


def _gumbel(generator, shape, dtype, device):
    """Standard Gumbel noise ``-log(-log(u))`` from ``generator``."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


@torch.no_grad()
def sample_multi(params, cfg: ModelConfig, batch, generator: Optional[torch.Generator],
                 samples_per_structure: int = 1, temperature=0.1, bias=None,
                 pair_bias_ctx=None, gumbel=None):
    """Sampling of N different (padded) structures in one decode batch: all
    are encoded in one pass, each row is repeated ``samples_per_structure``
    (S) times and the N*S rows decode together. Rows ``i*S..(i+1)*S-1``
    belong to structure i. ``bias`` is ``[N,L,nl]`` or ``[L,nl]``;
    ``pair_bias_ctx["u_diag"]`` is ``[N,L-1]`` or ``[L-1]``;
    ``batch["decoding_order"]``, where given, is the decode order of every
    row ``[N*S,L]``; ``gumbel`` as in ``sample`` (``[L,N*S,nl]``). Returns
    the dict of ``sample`` with leading dimension N*S."""
    N, L = batch["S"].shape
    nl = cfg.num_letters

    def rep(x):
        return x.repeat_interleave(samples_per_structure, dim=0)

    h_V0, h_E, E_idx = encode(params, cfg, batch)
    h_V0, h_E, E_idx = rep(widen(h_V0)), rep(widen(h_E)), rep(E_idx)
    mask = rep(batch["mask"].to(h_V0.dtype))
    chain_mask = mask * rep(batch["chain_mask"].to(h_V0.dtype))
    S_true = rep(batch["S"].long())
    if bias is not None:
        bias = rep(bias.expand(N, L, nl))
    if pair_bias_ctx is not None:
        u = pair_bias_ctx["u_diag"].expand(N, L - 1)
        pair_bias_ctx = {**pair_bias_ctx, "u_diag": rep(u)}
    if "decoding_order" in batch:
        decoding_order = batch["decoding_order"].expand(mask.shape)
    else:
        decoding_order = sample_decoding_order(chain_mask, generator)
    return _sample_scan(params, cfg, h_V0, h_E, E_idx, mask, chain_mask,
                        S_true, decoding_order, temperature, bias,
                        pair_bias_ctx, generator, gumbel)


# Decode steps a card runs eagerly before it captures the step: they set up
# cuBLAS's handle and workspace on the capture stream, which a capture must
# find in place.
_EAGER_STEPS = 2
_SIDE_STREAMS = {}


def _side_stream(device):
    """The card's one side stream for every call's eager steps and capture
    (as ``torch.cuda.graph`` keeps one capture stream): cuBLAS keeps a
    workspace for each stream it has run on until the process ends, so a
    new stream a call would come to hold one for each of PyTorch's 32 pool
    streams (about 1 GB on an H100)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


def _decode_loop(decode_step, L, device, generator):
    """Call ``decode_step`` L times inside ``sample.decode``, each call in a
    ``sample.step`` of its own. On a CUDA device the first ``_EAGER_STEPS``
    calls run eagerly on a side stream, one more call is captured there into
    a ``torch.cuda.CUDAGraph``, and the graph is replayed for the remaining
    ``L - _EAGER_STEPS`` steps: one graph launch a step in place of the
    step's hundred-odd kernel launches. ``generator`` is registered with the
    graph, so a replay draws from it what an eager step would and a seed
    gives the eager loop's tokens. The graph lives for this call only; its
    private memory pool goes with it (PyTorch's allocator keeps the pool's
    segments reserved until it next needs room on the card). Elsewhere, and
    where ``L <= _EAGER_STEPS``, every step runs eagerly. The span counts
    the ``steps`` and those ``replayed``."""
    graphed = device.type == "cuda" and L > _EAGER_STEPS
    replayed = L - _EAGER_STEPS if graphed else 0
    with trace.span("sample.decode", steps=L, replayed=replayed):
        if not graphed:
            for _ in range(L):
                with trace.span("sample.step"):
                    decode_step()
            return
        main = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(_EAGER_STEPS):
                with trace.span("sample.step"):
                    decode_step()
            graph = torch.cuda.CUDAGraph()
            if generator is not None:
                graph.register_generator_state(generator)
            graph.capture_begin()
            try:
                decode_step()
            finally:
                graph.capture_end()
            for _ in range(replayed):
                with trace.span("sample.step"):
                    graph.replay()
        main.wait_stream(side)


def _sample_scan(params, cfg: ModelConfig, h_V0, h_E, E_idx, mask, chain_mask,
                 S_true, decoding_order, temperature, bias, pair_bias_ctx,
                 generator, gumbel):
    """Decode loop over a prepared batch (every operand ``[B, ...]``): one
    position per step and row, in decode order. The per-layer static edge
    terms (edge features, encoder-node context, b1) are computed once; per
    step only the decoded-sequence embeddings and the mid-stack node states
    of the neighbours are gathered. The step reads its index from the
    device (``step_t``) and writes only buffers made before the loop, so on
    a card ``_decode_loop`` replays it as one CUDA graph."""
    B, L = mask.shape
    nl = cfg.num_letters
    H = cfg.hidden_dim
    n_dec = cfg.num_decoder_layers
    dtype, device = h_V0.dtype, h_V0.device
    mask_bw, mask_fw = autoregressive_edge_masks(decoding_order, E_idx, mask)
    if bias is None:
        bias = torch.zeros((B, L, nl), dtype=dtype, device=device)
    bias = bias.to(dtype)
    omit = torch.zeros(nl, dtype=dtype, device=device)
    omit[_OMIT_ALWAYS] = 1.0
    mask_1d = mask[:, :, None, None]

    w_splits = [_split_w1(p, H) for p in params["decoder"]]
    statics = []
    for l, ((_, wb, _, wv), b1) in enumerate(w_splits):
        venc = gather_nodes(h_V0 @ wv, E_idx)
        coeff = mask_1d if l == 0 else mask_fw
        statics.append(mask_1d * (h_E @ wb) + coeff * venc + b1)
    statics = torch.stack(statics, dim=2)          # [B,L,n_dec,K,H]

    h_S = torch.zeros((B, L, H), dtype=dtype, device=device)
    h_V_mid = torch.zeros((B, L, (n_dec - 1) * H), dtype=dtype, device=device)
    S_cur = torch.full((B, L), nl - 1, dtype=torch.int64, device=device)
    S_out = torch.zeros((B, L), dtype=torch.int64, device=device)
    probs_out = torch.zeros((B, L, nl), dtype=dtype, device=device)
    log_probs_out = torch.zeros((B, L, nl), dtype=dtype, device=device)
    b_idx = torch.arange(B, device=device)
    step_t = torch.zeros(1, dtype=torch.int64, device=device)

    def decode_step():
        """Decode position ``decoding_order[:, step_t]`` of every row and
        advance ``step_t``: device work only, on buffers made before the
        loop, so one call can be captured and replayed."""
        t = decoding_order.index_select(1, step_t)[:, 0]    # [B]
        E_t = E_idx[b_idx, t]                                # [B,K]
        bw = mask_bw[b_idx, t]                               # [B,K,1]
        s_nb = bw * take_rows(h_S, E_t)                      # [B,K,H]
        mid_nb = bw * take_rows(h_V_mid, E_t)
        static_t = statics[b_idx, t]                         # [B,n_dec,K,H]
        h_V_t = h_V0[b_idx, t]                               # [B,H]
        mask_t = mask[b_idx, t]
        mid_out = []
        for l, p in enumerate(params["decoder"]):
            (wa, _, ws, wv), _ = w_splits[l]
            x = (h_V_t @ wa)[:, None, :] + s_nb @ ws + static_t[:, l]
            if l >= 1:
                x = x + mid_nb[..., (l - 1) * H:l * H] @ wv
            dh = _message_tail(p, x).sum(dim=1) / MESSAGE_SCALE
            h_V_t = layer_norm(p["norm1"], h_V_t + dh)
            h_V_t = layer_norm(p["norm2"], h_V_t + pff_apply(p["dense"], h_V_t))
            h_V_t = mask_t[:, None] * h_V_t
            if l + 1 <= n_dec - 1:
                mid_out.append(h_V_t)

        logits = linear(params["W_out"], h_V_t)               # [B,nl]
        log_probs = torch.log_softmax(logits, dim=-1)
        total_bias = bias[b_idx, t]
        if pair_bias_ctx is not None:
            total_bias = total_bias + _pair_bias_step(pair_bias_ctx, t, S_cur)
        probs = torch.softmax((logits + total_bias) / temperature, dim=-1)
        probs = probs * (1.0 - omit)
        probs_sample = probs / probs.sum(dim=-1, keepdim=True)
        g = (gumbel.index_select(0, step_t)[0].to(dtype) if gumbel is not None
             else _gumbel(generator, (B, nl), dtype, device))
        S_t = torch.argmax(torch.log(probs_sample + 1e-30) + g, dim=-1)
        cm_t = chain_mask[b_idx, t]
        S_t = torch.where(cm_t > 0, S_t, S_true[b_idx, t])

        h_S[b_idx, t] = embed_tokens(params, S_t).to(dtype)
        if mid_out:
            h_V_mid[b_idx, t] = torch.cat(mid_out, dim=-1)
        S_cur[b_idx, t] = S_t
        S_out[b_idx, t] = S_t
        probs_out[b_idx, t] = cm_t[:, None] * probs_sample
        log_probs_out[b_idx, t] = cm_t[:, None] * log_probs
        step_t.add_(1)

    _decode_loop(decode_step, L, device, generator)

    return {"S": S_out, "sampling_probs": probs_out,
            "log_probs": log_probs_out, "decoding_order": decoding_order}


# ---------------------------------------------------------------------------
# Tied-position (symmetry) sampling
# ---------------------------------------------------------------------------

def build_decode_groups(decoding_order, symmetry_residues, symmetry_weights, L):
    """Group a decode order by symmetry-tied position sets (host side): walk
    the order; the first time a member of a tied set appears, the whole set
    decodes as one group. Returns (groups ``[G,M]`` int32 padded with -1,
    weights ``[G,M]`` float32, the flat order ``[L]``)."""
    order = [int(t) for t in np.asarray(decoding_order).reshape(-1)]
    sym_sets = [list(s) for s in symmetry_residues if len(s) > 0]
    sym_w = [list(w) for w in symmetry_weights if len(w) > 0]
    new_groups = []
    seen = set()
    for t in order:
        if t in seen:
            continue
        hit = next((i for i, s in enumerate(sym_sets) if t in s), None)
        if hit is not None:
            g = sym_sets[hit]
            w = sym_w[hit] if hit < len(sym_w) else [1.0] * len(g)
        else:
            g, w = [t], [1.0]
        seen.update(g)
        new_groups.append((g, w))
    M = max(len(g) for g, _ in new_groups)
    groups = np.full((len(new_groups), M), -1, np.int32)
    weights = np.zeros((len(new_groups), M), np.float32)
    for i, (g, w) in enumerate(new_groups):
        groups[i, :len(g)] = g
        weights[i, :len(g)] = w
    flat = np.concatenate([np.asarray(g, np.int32) for g, _ in new_groups])
    if flat.shape[0] != L:
        raise ValueError("decode groups must cover every position exactly once")
    return groups, weights, flat


@torch.no_grad()
def sample_tied(params, cfg: ModelConfig, batch, generator: Optional[torch.Generator],
                groups, group_weights, flat_order, num_samples: int = 1,
                temperature=0.1, bias=None, pair_bias_ctx=None, gumbel=None):
    """Symmetry-tied sampling: the positions of a group decode together,
    their weighted logits are summed, the last position's bias is added and
    one token is drawn for the whole group (it carries across the group's
    positions; a fixed position keeps its native token and passes that on).
    ``groups [G,M]`` (padded with -1), ``group_weights [G,M]`` and
    ``flat_order [L]`` come from ``build_decode_groups``; every decode row
    shares the order. ``gumbel`` (optional) is the noise ``[G,num_samples,
    nl]`` of each group's draw. Returns the dict of ``sample``. The decoder
    runs position by position on the ``[B,1,K,3H]`` context
    (``dec_layer_apply``), as the JAX package's scan does."""
    L = batch["S"].shape[-1]
    B = num_samples
    nl = cfg.num_letters
    n_dec = cfg.num_decoder_layers
    groups = np.asarray(groups)
    h_V0, h_E, E_idx = encode(params, cfg, batch)
    h_V0, h_E = widen(h_V0), widen(h_E)
    dtype, device = h_V0.dtype, h_V0.device
    h_V0 = h_V0[0].expand(B, *h_V0.shape[1:])
    h_E = h_E[0].expand(B, *h_E.shape[1:])
    E_idx = E_idx[0].expand(B, *E_idx.shape[1:])
    mask = batch["mask"][0].to(dtype).expand(B, L)
    chain_mask = mask * batch["chain_mask"][0].to(dtype).expand(B, L)
    S_true = batch["S"][0].long().expand(B, L)
    decoding_order = torch.as_tensor(np.asarray(flat_order), dtype=torch.int64,
                                     device=device).expand(B, L)
    mask_bw, mask_fw = autoregressive_edge_masks(decoding_order, E_idx, mask)
    h_EX_encoder = cat_neighbors_nodes(torch.zeros_like(h_V0), h_E, E_idx)
    h_EXV_encoder_fw = mask_fw * cat_neighbors_nodes(h_V0, h_EX_encoder, E_idx)
    bias = (torch.zeros((B, L, nl), dtype=dtype, device=device) if bias is None
            else bias.expand(B, L, nl).to(dtype))
    omit = torch.zeros(nl, dtype=dtype, device=device)
    omit[_OMIT_ALWAYS] = 1.0
    weights = np.asarray(group_weights, np.float64)

    h_V_stack = [h_V0] + [torch.zeros((B, L, h_V0.shape[-1]), dtype=dtype,
                                      device=device) for _ in range(n_dec)]
    h_S = torch.zeros((B, L, h_V0.shape[-1]), dtype=dtype, device=device)
    S = torch.full((B, L), nl - 1, dtype=torch.int64, device=device)
    all_probs = torch.zeros((B, L, nl), dtype=dtype, device=device)
    all_log_probs = torch.zeros((B, L, nl), dtype=dtype, device=device)

    def decode_position(t):
        """The decoder stack at position t of every row -> logits [B,nl]."""
        E_idx_t = E_idx[:, t][:, None]                              # [B,1,K]
        h_ES_t = cat_neighbors_nodes(h_S, h_E[:, t][:, None], E_idx_t)
        h_EXV_t = h_EXV_encoder_fw[:, t][:, None]
        mask_bw_t = mask_bw[:, t][:, None]
        for l, p in enumerate(params["decoder"]):
            h_ESV_t = (mask_bw_t * cat_neighbors_nodes(h_V_stack[l], h_ES_t, E_idx_t)
                       + h_EXV_t)
            out = dec_layer_apply(p, h_V_stack[l][:, t][:, None], h_ESV_t,
                                  mask_V=mask[:, t][:, None])
            h_V_stack[l + 1][:, t] = out[:, 0]
        return linear(params["W_out"], h_V_stack[n_dec][:, t])

    t_all = torch.arange(L, device=device)

    def decode_group(g):
        """Decode group ``g`` of every row and draw its token."""
        members = [(m, int(t)) for m, t in enumerate(groups[g]) if t >= 0]
        total_logits = torch.zeros((B, nl), dtype=dtype, device=device)
        for m, t in members:
            logits = decode_position(t)
            all_log_probs[:, t] = chain_mask[:, t, None] * torch.log_softmax(logits, dim=-1)
            total_logits = total_logits + float(weights[g, m]) * logits
        t_last = members[-1][1]
        total_bias = bias[:, t_last]
        if pair_bias_ctx is not None:
            total_bias = total_bias + _pair_bias_step(
                pair_bias_ctx, t_all[t_last].expand(B), S)
        probs = torch.softmax((total_logits + total_bias) / temperature, dim=-1)
        probs = probs * (1.0 - omit)
        probs_sample = probs / probs.sum(dim=-1, keepdim=True)
        noise = (gumbel[g].to(dtype) if gumbel is not None
                 else _gumbel(generator, (B, nl), dtype, device))
        S_t = torch.argmax(torch.log(probs_sample + 1e-30) + noise, dim=-1)
        for _, t in members:
            cm_t = chain_mask[:, t]
            all_probs[:, t] = cm_t[:, None] * probs_sample
            S_t = torch.where(cm_t > 0, S_t, S_true[:, t])
            h_S[:, t] = embed_tokens(params, S_t).to(dtype)
            S[:, t] = S_t

    with trace.span("sample.decode", steps=groups.shape[0], replayed=0):
        for g in range(groups.shape[0]):
            with trace.span("sample.step"):
                decode_group(g)
    return {"S": S, "sampling_probs": all_probs, "log_probs": all_log_probs,
            "decoding_order": decoding_order}
