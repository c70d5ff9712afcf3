"""Edge-partitioned (graph-parallel) forward over the mesh ``graph`` axis,
with its gradients, and the edge-partitioned sampler (port of the JAX
package's ``parallel/graph_parallel.py``).

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

``_encode_local`` (features and the encoder on this rank's rows) is shared
by the forward and ``sample_graph_parallel``, which keeps the sampler's
``[L, K, 2H]`` decoder context split over the graph axis and makes one
all-reduce per decode step. The plain featurisation streams the kNN's keys
in chunks (``gp_knn_key_chunk``, ``_knn_local_rows``) and the plain RBF's
query rows in blocks (``gp_rbf_row_chunk``, ``models/features.py::
PairRbfProjection``).

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
from ..models.modules import _split_w1, linear, take_rows, widen
from ..models.mpnn import (_decoder_step, _draw, _gumbel, _letter_terms, _logits,
                           _pair_bias_step, _plain, _remat, _trunk_dtype,
                           dec_layer, embed_tokens, enc_layer,
                           sample_decoding_order, table_order, to_trunk)
from ..ops.knn import knn_graph_qk_plain
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
# The key-chunked kNN (plain route)
# ---------------------------------------------------------------------------

def _knn_local_rows(X_q, X_k, mask_q, mask_k, k, key_chunk: int = 0,
                    eps: float = 1e-6):
    """The plain query/key kNN (``ops/knn.py::knn_graph_qk_plain``: this
    rank's ``Lq`` query rows against the ``Lk`` key rows) with the keys
    streamed in chunks of ``key_chunk`` (JAX ``graph_parallel.py:57-128``),
    so the ``[B, Lq, Lk]`` distance matrix never exists: per-rank memory is
    O(Lq * (key_chunk + k)). ``key_chunk`` 0 or at least ``Lk`` is the
    one-shot version.

    Pass 1 takes each row's largest masked distance over the chunks (the
    value every masked key gets added). Pass 2 merges each chunk into a
    running best ``k``: the candidates are ``[best | chunk]`` and one stable
    sort of their distances keeps the ``k`` smallest; the earlier chunks'
    candidates come first and hold lower key indices, so equal distances
    keep the lowest index, the total order on (value, index) of the one-shot
    version and of ``csrc/knn.cu`` (``torch.topk`` orders ties otherwise).
    The selection is bitwise the one-shot selection: each distance is the
    same expression on the same operands (``masked_distances``). The padded
    tail of the last chunk ties the masked keys at the row's largest
    distance and comes after them, so it is picked only where a row has
    fewer than ``k`` keys; its indices are clamped to ``Lk - 1``."""
    Lk = X_k.shape[1]
    if key_chunk <= 0 or key_chunk >= Lk:
        return knn_graph_qk_plain(X_q, X_k, mask_q, mask_k, k, eps)
    C = int(key_chunk)
    k = min(k, Lk)
    pad = -Lk % C
    X_k = torch.nn.functional.pad(X_k, (0, 0, 0, pad))
    mask_k = torch.nn.functional.pad(mask_k.to(X_q.dtype), (0, pad))
    mask_q = mask_q.to(X_q.dtype)
    chunks = range(0, Lk + pad, C)

    def distances(c):
        m2 = mask_k[:, None, c:c + C] * mask_q[:, :, None]
        dX = X_q[:, :, None, :] - X_k[:, None, c:c + C, :]
        d2 = dX[..., 0] * dX[..., 0] + dX[..., 1] * dX[..., 1]
        d2 = d2 + dX[..., 2] * dX[..., 2]
        return m2 * torch.sqrt(d2 + eps), m2

    D_max = torch.stack([distances(c)[0].amax(dim=-1) for c in chunks]
                        ).amax(dim=0)[..., None]
    best = torch.full(mask_q.shape + (k,), math.inf, dtype=X_q.dtype,
                      device=X_q.device)
    best_idx = torch.zeros(mask_q.shape + (k,), dtype=torch.int64,
                           device=X_q.device)
    for c in chunks:
        D, m2 = distances(c)
        cols = torch.arange(c, c + C, device=X_q.device).expand(D.shape)
        vals, pos = torch.sort(torch.cat([best, D + (1.0 - m2) * D_max], -1),
                               dim=-1, stable=True)
        best = vals[..., :k]
        best_idx = torch.gather(torch.cat([best_idx, cols], -1), -1,
                                pos[..., :k])
    return best, best_idx.clamp_(max=Lk - 1)


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
    drop.rate = rate if key is not None else 0.0
    return drop


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

def _encode_local(params, cfg: ModelConfig, batch, mesh: Mesh,
                  key: Optional[Tuple[int, int]] = None):
    """Features and the encoder stack on this rank's rows (JAX
    ``_encode_local``, ``graph_parallel.py:333``), shared by
    ``forward_graph_parallel`` and ``sample_graph_parallel``. ``batch``
    holds this rank's ``[B, Ls]`` rows; ``key`` turns on the training
    randomness (coordinate noise, dropout). Returns a dict: the encoder's
    ``h_V [B,Ls,H]`` and flat ``h_E2 [B*Ls*K,H]`` (in the trunk's type),
    ``E_idx [B,Ls,K]`` (global key indices), the layers' ``mask``, the
    trunk type ``cdt`` (None: the input type), the stack's ``order``,
    ``plain``, ``drop(tag)`` (the layers' row-keyed dropout source, None
    without dropout) and ``remat``. The bf16 trunk runs whole
    at G = 1 and only in the RBF projection at G > 1 (the module's
    docstring); ``remat`` acts at G = 1, where JAX runs the one-device
    forward."""
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

    remat = _remat(cfg) and mesh.graph == 1
    order = table_order(eidx2, K, Ls, L, plain, enc_layers, h_V, h_E2)
    for i, p in enumerate(enc_layers):
        h_V, h_E2 = enc_layer(p, h_V, h_E2, eidx2, mask_attend.reshape(-1),
                              layer_mask, drop(TAG_ENC + 10 * i), gather, plain,
                              order, remat)
    return {"h_V": h_V, "h_E2": h_E2, "E_idx": E_idx, "mask": layer_mask,
            "cdt": cdt, "order": order, "plain": plain, "drop": drop,
            "remat": remat}


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
    X = batch["X"]
    B, Ls = batch["S"].shape
    L = Ls * mesh.graph
    dev = X.device

    def gather(x):
        return all_gather_rows(x, mesh)

    enc = _encode_local(params, cfg, batch, mesh, key)
    h_V, h_E2, E_idx, layer_mask = enc["h_V"], enc["h_E2"], enc["E_idx"], enc["mask"]
    K = E_idx.shape[2]
    b_glob = mesh.data_index * B + torch.arange(B, device=dev)
    l0 = mesh.graph_index * Ls
    if decoding_order is None:
        if key is None:
            decoding_order = torch.arange(L, device=dev).expand(B, L)
        else:
            mask = batch["mask"].to(X.dtype)
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
    dec_layers, h_S = to_trunk(enc["cdt"], params["decoder"],
                               embed_tokens(params, batch["S"]))
    h_V_enc = h_V
    eidx2 = E_idx.reshape(-1)
    for i, p in enumerate(dec_layers):
        h_V = dec_layer(p, h_V, h_V_enc, h_S, h_E2, eidx2, m1d2, mbw2, layer_mask,
                        enc["drop"](TAG_DEC + 10 * i), gather, enc["plain"],
                        enc["order"], enc["remat"])
    return torch.log_softmax(_logits(params, h_V), dim=-1)


# ---------------------------------------------------------------------------
# Edge-partitioned autoregressive sampling
# ---------------------------------------------------------------------------

@torch.no_grad()
def sample_graph_parallel(params, cfg: ModelConfig, batch, generator, mesh: Mesh,
                          num_samples: int = 1, temperature=0.1, bias=None,
                          pair_bias_ctx=None, gumbel=None):
    """Autoregressive sampling of one structure with its residues split
    over the graph axis (JAX ``sample_graph_parallel``, ``graph_parallel.py:
    444-670``) -> {"S", "sampling_probs", "log_probs", "decoding_order"},
    each ``[num_samples, L, ...]`` and the same on every rank.

    ``batch`` holds the whole structure (``[1, L]`` rows on the mesh's
    device, ``L`` a multiple of G, with ``chain_mask`` and optionally
    ``decoding_order``); each rank encodes its own block of ``L/G`` rows
    (``_encode_local``: under no gradient, the fused route). The
    ``[L, K, 2H]`` decoder context, the sampler's only O(L*K) array and the
    reason to split the structure, stays split: each rank keeps its rows'
    ``concat(h_E, h_V_enc(j))``. So do the decode state's rows (``h_S``, the
    decoder's middle levels, the probabilities). Each decode step makes one
    ``dist.all_reduce`` over the graph group (JAX's fused ``psum``,
    ``:517-525``): its owner's context rows and encoder state of each
    sample's position, and its K neighbours' ``h_S`` and middle levels, each
    from its owner, the other ranks adding zeros. Every rank then runs the
    same per-step math on the same values (the step of every sampler,
    ``models/mpnn.py::_decoder_step`` and ``_draw``) and the same draws: the decode
    order ``sample_decoding_order`` and each step's Gumbel noise ``_gumbel``
    from ``generator``, in the order ``sample`` draws them, or ``gumbel
    [L, num_samples, nl]`` and ``batch["decoding_order"]`` as given. With
    the same generator seed on every rank the tokens are the same on every
    rank, and the same as the one-device ``sample``'s. ``bias`` (``[L,nl]``
    or ``[num_samples,L,nl]``) and ``pair_bias_ctx`` as in ``sample``.

    A bf16 trunk follows the port's policy: at G = 1 the one-device bf16
    trunk encodes, at G > 1 the RBF projection alone is bf16 (JAX's mesh
    policy); the sampler runs in fp32 after either."""
    L = batch["S"].shape[-1]
    G, gi = mesh.graph, mesh.graph_index
    if L % G:
        raise ValueError(f"length {L} does not split over graph={G}")
    Ls, l0 = L // G, mesh.graph_index * (L // G)
    B = num_samples
    nl = cfg.num_letters
    n_dec = cfg.num_decoder_layers
    rows = {k: batch[k][0:1, l0:l0 + Ls] for k in (
        "X", "X_m", "mask", "S", "R_idx", "chain_labels", "protein_mask",
        "dna_mask", "rna_mask", "R_polymer_type")}
    enc = _encode_local(params, cfg, rows, mesh)
    h_V0 = widen(enc["h_V"])[0]                               # [Ls, H]
    dtype, device = h_V0.dtype, h_V0.device
    H = h_V0.shape[-1]
    E_idx = enc["E_idx"][0]                                   # [Ls, K]
    K = E_idx.shape[-1]
    E_idx_g = all_gather_rows(enc["E_idx"], mesh)[0]          # [L, K]
    h_V0_g = all_gather_rows(h_V0[None], mesh)[0]             # [L, H]
    context = torch.cat([widen(enc["h_E2"]).view(Ls, K, H), h_V0_g[E_idx]], -1)

    mask = batch["mask"][0].to(dtype).expand(B, L)
    chain_mask = mask * batch["chain_mask"][0].to(dtype).expand(B, L)
    S_true = batch["S"][0].long().expand(B, L)
    if "decoding_order" in batch:
        decoding_order = batch["decoding_order"].expand(B, L)
    else:
        decoding_order = sample_decoding_order(chain_mask, generator)
    rank = torch.argsort(decoding_order, dim=-1)
    bias, omit = _letter_terms(cfg, bias, B, L, dtype, device)
    w_splits = [_split_w1(p, H) for p in params["decoder"]]

    # this rank's rows of the decode state
    h_S = torch.zeros((B, Ls, H), dtype=dtype, device=device)
    mid = torch.zeros((B, Ls, (n_dec - 1) * H), dtype=dtype, device=device)
    probs_out = torch.zeros((B, Ls, nl), dtype=dtype, device=device)
    log_probs_out = torch.zeros((B, Ls, nl), dtype=dtype, device=device)
    S = torch.full((B, L), nl - 1, dtype=torch.int64, device=device)
    b_idx = torch.arange(B, device=device)
    sizes = (B * K * 2 * H, B * H, B * K * H, B * K * (n_dec - 1) * H)
    zero = torch.zeros((), dtype=dtype, device=device)

    for step in range(L):
        t = decoding_order[:, step]                           # [B]
        lt = (t - l0).clamp(0, Ls - 1)
        own_t = (t // Ls == gi)[:, None]
        j = E_idx_g[t]                                        # [B, K]
        lj = (j - l0).clamp(0, Ls - 1)
        own_j = (j // Ls == gi)[..., None]
        parts = (torch.where(own_t[..., None], context[lt], zero),
                 torch.where(own_t, h_V0[lt], zero),
                 torch.where(own_j, h_S[b_idx[:, None], lj], zero),
                 torch.where(own_j, mid[b_idx[:, None], lj], zero))
        buf = torch.cat([x.reshape(-1) for x in parts])
        dist.all_reduce(buf, group=mesh.graph_group)
        ctx_t, h_V_t, s_j, mid_j = torch.split(buf, sizes)
        ctx_t = ctx_t.view(B, K, 2 * H)

        mask_t = mask[b_idx, t]
        attend = (rank[b_idx[:, None], j] < rank[b_idx, t][:, None]).to(dtype)
        bw = (mask_t[:, None] * attend)[..., None]            # [B, K, 1]
        fw = (mask_t[:, None] * (1.0 - attend))[..., None]
        m1d = mask_t[:, None, None]
        static_t = torch.stack([
            m1d * (ctx_t[..., :H] @ wb) + (m1d if l == 0 else fw) * (ctx_t[..., H:] @ wv)
            + b1 for l, ((_, wb, _, wv), b1) in enumerate(w_splits)], dim=1)
        logits, mid_out = _decoder_step(params, w_splits, h_V_t.view(B, H),
                                        bw * s_j.view(B, K, H), static_t,
                                        bw * mid_j.view(B, K, (n_dec - 1) * H), mask_t)
        log_probs = torch.log_softmax(logits, dim=-1)
        total_bias = bias[b_idx, t]
        if pair_bias_ctx is not None:
            total_bias = total_bias + _pair_bias_step(pair_bias_ctx, t, S)
        g = (gumbel[step].to(dtype) if gumbel is not None
             else _gumbel(generator, (B, nl), dtype, device))
        probs_sample, S_t = _draw(logits, total_bias, temperature, omit, g)
        cm_t = chain_mask[b_idx, t]
        S_t = torch.where(cm_t > 0, S_t, S_true[b_idx, t])
        S[b_idx, t] = S_t

        def owner_set(acc, val):
            acc[b_idx, lt] = torch.where(own_t, val, acc[b_idx, lt])

        owner_set(h_S, embed_tokens(params, S_t).to(dtype))
        if mid_out:
            owner_set(mid, torch.cat(mid_out, dim=-1))
        owner_set(probs_out, cm_t[:, None] * probs_sample)
        owner_set(log_probs_out, cm_t[:, None] * log_probs)

    return {"S": S, "sampling_probs": all_gather_rows(probs_out, mesh),
            "log_probs": all_gather_rows(log_probs_out, mesh),
            "decoding_order": decoding_order}
