"""Edge-partitioned (graph-parallel) forward over the mesh ``graph`` axis,
with its gradients (port of the JAX package's ``parallel/graph_parallel.py``,
the forward and training half).

Each rank holds its data rows and, along its graph row, a contiguous block
of Ls = L/G residues of every structure. Every O(L*K*H) edge tensor (RBF
features, ``h_E``, the per-edge messages) lives and is computed on the rank
that owns its query row. Only O(L*H) node arrays cross ranks: the
coordinates, masks and scalars once for the kNN and the RBF features, then
one all-gather of a node table per message round. The layers are the
one-device layers (``models/mpnn.py::enc_layer`` / ``dec_layer``) on the
same kernels; they get the gathered table (``Lk = L`` key rows against the
shard's ``Ls`` query rows) and this module's dropout source. The kNN and the
RBF features take their query/key forms (``ops/knn.py::knn_graph_qk``, the
``_qk`` entries of the RBF modules) at every graph size, G = 1 included. A
deterministic pass under no gradient takes the layers' fused route, a
training pass the message-table route (see ``models/mpnn.py``).

``all_gather_rows`` is autograd-aware: its backward sums the cotangent over
the graph row (an all-reduce) and keeps this rank's slice, so a rank's
gradient carries every other rank's use of its rows.

Partition-invariant randomness: coordinate noise, every dropout mask and the
decode order are functions of (seed, step, tag, global row, element) only,
through a counter-based hash (murmur3's mixing on 32-bit words, in int64
tensor ops) and Box-Muller for normals. A global row is ``b*L + l`` over the
whole batch, so the loss and its gradient do not depend on the mesh shape,
up to the order of the sums. The streams are not JAX's ``fold_in`` streams,
nor the one-device ``Trainer``'s ``torch.Generator`` draws.

``compute_dtype="bfloat16"`` follows the JAX Trainer on the same mesh. At
G > 1 (JAX ``forward_graph_parallel``, ``_forward_local``) only the RBF
projection is bf16 (rows 3 / 4 or 5 / 6 in their bf16 function, on the key
rows): the positional block, both layer stacks and ``W_out`` run in fp32.
At G = 1 (the JAX Trainer's data-parallel ``forward``, ``trainer.py:111-112``,
``:160-161``) the whole one-device bf16 trunk runs: the positional block,
the encoder's and decoder's parameters, ``h_V``, ``h_E``, ``h_S`` and the
masks in bf16, LayerNorm statistics and ``W_out`` in fp32, with this
module's row-keyed streams (uniforms drawn in fp32). Parameters and
gradients stay fp32 either way, so no collective carries bf16.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..models.config import ModelConfig, check_supported
from ..models.features import features_from_coords
from ..models.modules import linear, take_rows, widen
from ..models.mpnn import (_logits, _plain, _trunk_dtype, dec_layer,
                           embed_tokens, enc_layer, table_order, to_trunk)
from .mesh import Mesh

# Tags of the random streams (any distinct ints).
TAG_NOISE = 101
TAG_ORDER = 102
TAG_ENC = 200    # + 10 * layer + slot
TAG_DEC = 500    # + 10 * layer + slot


# ---------------------------------------------------------------------------
# The graph-axis all-gather
# ---------------------------------------------------------------------------

class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = [torch.empty_like(x) for _ in range(mesh.graph)]
        dist.all_gather(parts, x.contiguous(), group=mesh.graph_group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.graph_group)
        n = g.shape[1] // mesh.graph
        return g[:, mesh.graph_index * n:(mesh.graph_index + 1) * n], None


def all_gather_rows(x, mesh: Mesh):
    """``[B, Ls, ...]`` rows of this rank -> ``[B, G*Ls, ...]``, the graph
    row's blocks in graph order; identity at G = 1."""
    if mesh.graph == 1:
        return x
    return _AllGatherRows.apply(x, mesh)


# ---------------------------------------------------------------------------
# Counter-based random streams
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """``a * c mod 2**32`` for ``a`` in [0, 2**32), without int64 overflow."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _rotl32(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def _mix(h, k):
    """One murmur3 block: fold the 32-bit word ``k`` into the state ``h``."""
    k = _mul32(_rotl32(_mul32(k, 0xCC9E2D51), 15), 0x1B873593)
    h = _rotl32(h ^ k, 13)
    return (h * 5 + 0xE6546B64) & _M32


def _fmix(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def row_uniform(key: Tuple[int, int], tag: int, rid, n: int, dtype):
    """Uniforms in (0, 1) of shape ``rid.shape + (n,)``: element ``e`` of
    global row ``rid`` under ``key = (seed, step)`` and ``tag``."""
    seed, step = key
    h0 = _mix(_mix(_mix(0, seed & _M32), step & _M32), tag & _M32)
    h = _mix(torch.full_like(rid, h0), rid)[..., None]
    e = torch.arange(n, device=rid.device, dtype=torch.int64)
    bits = _fmix(_mix(h, e))
    return ((bits.to(torch.float64) + 0.5) * 2.0 ** -32).to(dtype)


def row_normal(key, tag: int, rid, shape, dtype):
    """Standard normals ``rid.shape + shape`` (Box-Muller on two uniforms
    per element)."""
    n = math.prod(shape)
    u = row_uniform(key, tag, rid, 2 * n, torch.float64)
    z = torch.sqrt(-2.0 * torch.log(u[..., 0::2])) * torch.cos(
        2.0 * math.pi * u[..., 1::2])
    return z.to(dtype).reshape(tuple(rid.shape) + tuple(shape))


def row_dropout(rate: float, key, tag: int, rid):
    """The graph-parallel layers' dropout source: ``drop(x, slot)`` keeps
    each entry of ``x [B, Ls, ...]`` where its row-keyed uniform (tag
    ``tag + slot``; fp32 for a bf16 ``x``) is below ``1 - rate``, scaled by
    ``1 / (1 - rate)``."""
    def drop(x, slot):
        if key is None or rate <= 0.0:
            return x
        keep = 1.0 - rate
        u = row_uniform(key, tag + slot, rid, math.prod(x.shape[2:]),
                        widen(x).dtype)
        return torch.where(u.view(x.shape) < keep, x / keep, 0.0)
    return drop


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

def forward_graph_parallel(params, cfg: ModelConfig, batch, mesh: Mesh,
                           decoding_order: Optional[torch.Tensor] = None,
                           key: Optional[Tuple[int, int]] = None):
    """Teacher-forced forward of this rank's rows -> ``log_probs [B/D, L/G,
    num_letters]``.

    ``batch`` is this rank's ``shard_batch`` of the global batch (on the
    mesh's device). ``decoding_order [B/D, L]`` (global positions of this
    rank's structures) is the decode order; without it the order is
    ``0..L-1`` when deterministic, else drawn from ``key``. ``key = (seed,
    step)`` turns on training randomness (coordinate noise, dropout);
    ``None`` is deterministic, and then the rows equal the one-device
    ``forward`` with the same decode order."""
    check_supported(cfg)
    X = batch["X"]
    plain = _plain(cfg, X)
    B, Ls = batch["S"].shape
    L = Ls * mesh.graph
    dev = X.device

    def gather(x):
        return all_gather_rows(x, mesh)

    b_glob = mesh.data_index * B + torch.arange(B, device=dev)
    l0 = mesh.graph_index * Ls
    rid = b_glob[:, None] * L + l0 + torch.arange(Ls, device=dev)[None]
    mask = batch["mask"].to(X.dtype)
    rate = cfg.dropout if key is not None else 0.0

    if key is not None and max(cfg.protein_augment_eps, cfg.dna_augment_eps,
                               cfg.rna_augment_eps) > 0:
        eps = (batch["protein_mask"] * cfg.protein_augment_eps
               + batch["dna_mask"] * cfg.dna_augment_eps
               + batch["rna_mask"] * cfg.rna_augment_eps).to(X.dtype)
        noise = row_normal(key, TAG_NOISE, rid, X.shape[2:], X.dtype)
        X = X + batch["X_m"][..., None].to(X.dtype) * eps[:, :, None, None] * noise
    cdt = _trunk_dtype(cfg) if mesh.graph == 1 else None
    V, E, E_idx, mask_attend = features_from_coords(
        params["features"], cfg, batch, X, plain, gather=gather,
        low_pos=cdt is not None)
    h_V = linear(params["W_v"], V)
    h_E = linear(params["W_e"], E)
    enc_layers, h_V, h_E, layer_mask, mask_attend = to_trunk(
        cdt, params["encoder"], h_V, h_E, mask, mask_attend)
    K, H = E_idx.shape[2], h_V.shape[-1]
    h_E2 = h_E.reshape(B * Ls * K, H)
    eidx2 = E_idx.reshape(-1)

    def drop(tag):
        return row_dropout(rate, key, tag, rid) if rate > 0 else None

    order = table_order(eidx2, K, Ls, L, plain, enc_layers, h_V, h_E2)
    for i, p in enumerate(enc_layers):
        h_V, h_E2 = enc_layer(p, h_V, h_E2, eidx2, mask_attend.reshape(-1),
                              layer_mask, drop(TAG_ENC + 10 * i), gather, plain,
                              order)

    if decoding_order is None:
        if key is None:
            decoding_order = torch.arange(L, device=dev).expand(B, L)
        else:
            chain_M = gather(mask)
            if cfg.decode_protein_first:
                chain_M = chain_M * (1.0 - gather(batch["protein_mask"].to(X.dtype)))
            rid_full = b_glob[:, None] * L + torch.arange(L, device=dev)[None]
            z = row_normal(key, TAG_ORDER, rid_full, (), X.dtype)
            decoding_order = torch.argsort((chain_M + 0.0001) * z.abs(), dim=-1,
                                           stable=True)
    rank = torch.argsort(decoding_order, dim=-1)              # [B, L]
    attend = take_rows(rank, E_idx) < rank[:, l0:l0 + Ls, None]
    m1d2 = layer_mask[:, :, None].expand(B, Ls, K).reshape(-1)
    mbw2 = m1d2 * attend.reshape(-1).to(layer_mask.dtype)
    dec_layers, h_S = to_trunk(cdt, params["decoder"],
                               embed_tokens(params, batch["S"]))
    h_V_enc = h_V
    for i, p in enumerate(dec_layers):
        h_V = dec_layer(p, h_V, h_V_enc, h_S, h_E2, eidx2, m1d2, mbw2, layer_mask,
                        drop(TAG_DEC + 10 * i), gather, plain, order)
    return torch.log_softmax(_logits(params, h_V), dim=-1)
