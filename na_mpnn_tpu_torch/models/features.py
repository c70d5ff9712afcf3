"""Geometric featurisation: virtual atoms, kNN graph, RBF edge features.

Port of the JAX package's ``models/features.py``. The
kNN graph and the RBF edge projection run on the kernels of ``ops/knn.py``,
``ops/rbf_classed.py`` (``rbf_mode="classed"``) and ``ops/rbf_edge.py``
(``rbf_mode="dense"``); ``knn_graph`` here is ``ops/knn.py``'s (the
kernel on CUDA tensors), ``all_pair_rbf`` the plain version the RBF
kernels are held to. The RBF kernels take the 18-slot
frame; the other frames (no virtual base N, the 65-atom table) take
``PairRbfProjection``, the plain RBF and one product, as the JAX package
computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import constants
from ..ops.knn import knn_graph, knn_graph_plain
from .config import ModelConfig
from .modules import init_layer_norm, init_linear, layer_norm, take_rows

RBF_D_MIN = 2.0
RBF_D_MAX = 22.0


def get_virtual_atom(a1, a2, a3, w_a, w_b, w_c):
    """Place a virtual atom from three anchors: Cb from (N, CA, C), pseudo
    base-N from (O4', C1', C2')."""
    b = a2 - a1
    c = a3 - a2
    a = torch.linalg.cross(b, c, dim=-1)
    return w_a * a + w_b * b + w_c * c + a2


def rbf_embed(D, num_rbf):
    """Radial basis expansion over [2, 22] A with ``num_rbf`` bins."""
    mu = torch.linspace(RBF_D_MIN, RBF_D_MAX, num_rbf, dtype=D.dtype,
                        device=D.device)
    sigma = (RBF_D_MAX - RBF_D_MIN) / num_rbf
    z = (D[..., None] - mu) / sigma
    return torch.exp(-z * z)


def all_pair_rbf(X_aug, E_idx, X_m_aug, num_rbf, X_aug_k=None, X_m_k=None):
    """All-pair-atom RBF features per edge, ``[B,L,K,A*A*num_rbf]``, masked
    by atom presence on both endpoints; pair ``(a, b)``, bin ``r`` at
    ``(a*A + b)*num_rbf + r``. The neighbours ``E_idx`` index the key rows
    ``X_aug_k [B,Lk,A,3]``, ``X_m_k`` where given (the graph-parallel
    forward's gathered structure), else the query rows."""
    if X_aug_k is None:
        X_aug_k, X_m_k = X_aug, X_m_aug
    B, L, A, _ = X_aug.shape
    K = E_idx.shape[2]
    X_g = take_rows(X_aug_k.reshape(B, -1, A * 3), E_idx).reshape(B, L, K, A, 3)
    d = X_aug[:, :, None, :, None, :] - X_g[:, :, :, None, :, :]
    D = torch.sqrt((d * d).sum(-1) + 1e-6)                   # [B,L,K,A,A]
    RBF = rbf_embed(D, num_rbf)                              # [B,L,K,A,A,R]
    X_m_g = take_rows(X_m_k, E_idx)                          # [B,L,K,A]
    RBF = RBF * X_m_aug[:, :, None, :, None, None] * X_m_g[:, :, :, None, :, None]
    return RBF.reshape(B, L, K, A * A * num_rbf)


def positional_embed(p, offset, E_chains, max_relative_feature):
    """Relative-position embedding clipped at +-max_relative_feature with a
    separate cross-chain bucket: a row gather of the table ``p["w"]``
    (plus ``p["b"]`` where present). The featuriser computes the same rows
    folded through the edge projection (``features_from_coords``)."""
    mrf = max_relative_feature
    d = torch.clamp(offset + mrf, 0, 2 * mrf)
    d = d * E_chains + (1 - E_chains) * (2 * mrf + 1)
    out = p["w"][d.long()]
    return out + p["b"] if "b" in p else out


def init_features(rng, cfg: ModelConfig):
    """The featuriser's parameters as a numpy tree in the JAX layout
    (xavier-uniform weights, zero biases, unit LayerNorms), drawn from the
    numpy Generator ``rng``."""
    return {
        "positional": init_linear(rng, 2 * cfg.max_relative_feature + 2,
                                  cfg.num_positional_embeddings),
        "node_embedding": init_linear(rng, cfg.node_in, cfg.node_features,
                                      bias=False),
        "norm_nodes": init_layer_norm(cfg.node_features),
        "edge_embedding": init_linear(rng, cfg.edge_in, cfg.edge_features,
                                      bias=False),
        "norm_edges": init_layer_norm(cfg.edge_features),
    }


def augment_coordinates(X, X_m, batch, cfg: ModelConfig, generator):
    """Training noise: per-polymer Gaussian noise (``*_augment_eps`` A) on
    present atoms, drawn from ``generator``."""
    eps = (batch["protein_mask"] * cfg.protein_augment_eps
           + batch["dna_mask"] * cfg.dna_augment_eps
           + batch["rna_mask"] * cfg.rna_augment_eps).to(X.dtype)
    noise = torch.randn(X.shape, generator=generator, dtype=X.dtype,
                        device=X.device)
    return X + X_m[..., None].to(X.dtype) * eps[:, :, None, None] * noise


def build_augmented_atoms(X, X_m, batch, cfg: ModelConfig):
    """Append virtual Cb and (with ``include_pred_na_N``) virtual base-N to
    the atom frame. Returns (``X_aug [B,L,A,3]``, ``X_m_aug [B,L,A]``,
    ``X_ref [B,L,3]``), ``A = cfg.total_atoms``: 18 for the backbone table,
    17 without the base N, 67 (66) for the 65-atom table; ``X_ref`` = CA +
    C1' (disjoint support: the residue centre)."""
    ad = cfg.atom_dict
    Cb = get_virtual_atom(X[:, :, ad["N"]], X[:, :, ad["CA"]], X[:, :, ad["C"]],
                          *constants.CB_WEIGHTS)
    X_ref = X[:, :, ad["CA"]] + X[:, :, cfg.na_ref_atom_idx]
    protein_mask = batch["protein_mask"].to(X.dtype)
    atoms = [X, Cb[:, :, None]]
    masks = [X_m.to(X.dtype), protein_mask[..., None]]
    if cfg.include_pred_na_N:
        N_na = get_virtual_atom(X[:, :, ad["O4'"]], X[:, :, ad["C1'"]],
                                X[:, :, ad["C2'"]], *constants.NA_N_WEIGHTS)
        atoms.append(N_na[:, :, None])
        masks.append((batch["rna_mask"] + batch["dna_mask"]).to(X.dtype)[..., None])
    return torch.cat(atoms, dim=-2), torch.cat(masks, dim=-1), X_ref


# The atom frame of the RBF kernels (rows 3-6, ``csrc/rbf_common.cuh``):
# the 16-atom backbone table with both virtual atoms.
KERNEL_FRAME = 18


def _row_blocks(n, row_chunk):
    """The query-row slices of ``n`` rows in blocks of ``row_chunk`` (one
    block for 0 or at least ``n``)."""
    step = row_chunk if 0 < row_chunk < n else n
    return [slice(a, min(a + step, n)) for a in range(0, n, step)]


class PairRbfProjection(torch.autograd.Function):
    """``all_pair_rbf(...) @ W`` on any atom frame, the RBF block of the
    frames the kernels do not take (17 and 67 slots) on every route: the
    JAX featurisers' plain XLA ``all_pair_rbf`` and one product
    (``features.py:235-237``, ``graph_parallel.py:236-267``), a
    ``torch.matmul`` in the coordinates' type. The query rows go in blocks
    of ``row_chunk`` (``gp_rbf_row_chunk``; 0: one block), each block's
    ``[B, rows, K, A*A*num_rbf]`` RBF existing only inside its product (JAX
    pads the last block, which changes no row; here it is shorter). The
    backward forms ``dW`` by recomputing each block's RBF and summing its
    product with the cotangent's rows: only the coordinates, the masks and
    ``E_idx`` are saved, so the block (at 67 slots about 56 GB at fp32 for
    B = 8 x L = 768) never outlives one block's product. The coordinates get
    no gradient, as in the JAX package. ``X_aug_k``, ``X_m_k``: the key rows
    ``E_idx`` indexes (the query rows themselves on one device)."""

    @staticmethod
    def forward(ctx, X_aug, X_m_aug, X_aug_k, X_m_k, E_idx, W, num_rbf,
                row_chunk):
        ctx.save_for_backward(X_aug, X_m_aug, X_aug_k, X_m_k, E_idx)
        ctx.num_rbf, ctx.row_chunk = num_rbf, row_chunk
        return torch.cat([
            all_pair_rbf(X_aug[:, r], E_idx[:, r], X_m_aug[:, r], num_rbf,
                         X_aug_k, X_m_k) @ W
            for r in _row_blocks(X_aug.shape[1], row_chunk)], dim=1)

    @staticmethod
    def backward(ctx, g):
        X_aug, X_m_aug, X_aug_k, X_m_k, E_idx = ctx.saved_tensors
        dW = None
        for r in _row_blocks(X_aug.shape[1], ctx.row_chunk):
            rbf = all_pair_rbf(X_aug[:, r], E_idx[:, r], X_m_aug[:, r],
                               ctx.num_rbf, X_aug_k, X_m_k)
            part = (rbf.reshape(-1, rbf.shape[-1]).T
                    @ g[:, r].reshape(-1, g.shape[-1]))
            dW = part if dW is None else dW + part
        return None, None, None, None, None, dW, None, None


def features_apply(p, cfg: ModelConfig, batch, plain: bool = False,
                   generator=None):
    """(``V [B,L,node_features]``, ``E [B,L,K,edge_features]``,
    ``E_idx [B,L,K]``, ``mask_attend [B,L,K]``).

    ``plain=True`` takes the plain versions of the kNN and RBF kernels.
    With a ``generator`` (training), coordinates get the configured noise
    first; without one the function is deterministic."""
    X = batch["X"]
    if generator is not None and max(cfg.protein_augment_eps,
                                     cfg.dna_augment_eps,
                                     cfg.rna_augment_eps) > 0:
        X = augment_coordinates(X, batch["X_m"], batch, cfg, generator)
    return features_from_coords(p, cfg, batch, X, plain)


def features_from_coords(p, cfg: ModelConfig, batch, X, plain: bool = False,
                         gather=None, low_pos=None):
    """``features_apply`` on the (possibly noised) coordinates ``X``.

    ``gather`` is None on one device. On the graph-parallel route the batch
    holds a shard's query rows, ``gather`` all-gathers ``[B,Ls,...]`` rows
    along the graph axis into the structure's ``[B,L,...]`` key rows, and the
    query/key forms of the kNN and RBF kernels run; ``E_idx`` then holds key
    (global) indices. At ``compute_dtype="bfloat16"`` the RBF projection
    takes its bf16 function on every route; ``low_pos`` (default: the same
    as the RBF) makes the positional block bf16 too, as the one-device JAX
    featuriser does (``features.py:216``) and the JAX graph-parallel one does
    not (``graph_parallel.py:275-278``).

    The RBF block of a frame other than the kernels' 18 slots takes
    ``PairRbfProjection`` (fp32, as JAX's plain product; at bf16 the bf16
    positional block is added to it in fp32), on the graph-parallel route in
    blocks of ``gp_rbf_row_chunk`` query rows; so does the 18-slot block
    with a row chunk where the plain versions run (``plain``, or CPU
    tensors: JAX's chunk acts on its plain RBF alone). On the
    graph-parallel route the plain kNN streams its keys in chunks of
    ``gp_knn_key_chunk`` (``parallel/graph_parallel.py::_knn_local_rows``);
    the kernel streams them through shared memory in tiles and ignores the
    chunk, as JAX's Pallas route does. A tree without ``node_embedding``
    (LigandMPNN's trunk, ``models/ligand.py``) gives no node features:
    ``V`` is None."""
    from ..ops.knn import knn_graph_qk
    from ..ops.rbf_classed import rbf_edge_features_classed_qk
    from ..ops.rbf_edge import rbf_edge_features_qk

    low = cfg.compute_dtype == "bfloat16"
    low_pos = low if low_pos is None else low_pos
    mask = batch["mask"].to(X.dtype)
    X_aug, X_m_aug, X_ref = build_augmented_atoms(X, batch["X_m"], batch, cfg)
    # Relative position, same-chain indicator and neighbour mask through one
    # packed row gather (all values exact in the float type: ints < 2^24).
    R_idx = batch["R_idx"].long()
    chain_labels = batch["chain_labels"].long()
    scalar_tab = torch.stack([R_idx.to(X.dtype), chain_labels.to(X.dtype), mask],
                             dim=-1)
    n_pos = cfg.num_positional_embeddings
    W = p["edge_embedding"]["w"]
    if gather is None:
        knn = knn_graph_plain if plain else knn_graph
        _, E_idx = knn(X_ref, mask, cfg.k_neighbors)
        keys = (X_aug, X_m_aug)
    else:
        if plain or not X_ref.is_cuda:
            from ..parallel.graph_parallel import _knn_local_rows
            _, E_idx = _knn_local_rows(X_ref, gather(X_ref), mask, gather(mask),
                                       cfg.k_neighbors, cfg.gp_knn_key_chunk)
        else:
            _, E_idx = knn_graph_qk(X_ref, gather(X_ref), mask, gather(mask),
                                    cfg.k_neighbors)
        keys = (gather(X_aug), gather(X_m_aug))
        scalar_tab = gather(scalar_tab)
    row_chunk = cfg.gp_rbf_row_chunk if gather is not None else 0
    if X_aug.shape[2] != KERNEL_FRAME or (row_chunk > 0 and (plain or not X.is_cuda)):
        E_rbf = PairRbfProjection.apply(X_aug, X_m_aug, *keys, E_idx, W[n_pos:],
                                        cfg.num_rbf, row_chunk)
    else:
        rbf = (rbf_edge_features_qk if cfg.rbf_mode == "dense"
               else rbf_edge_features_classed_qk)
        E_rbf = rbf(X_aug, X_m_aug, *keys, E_idx, W[n_pos:], low=low,
                    plain=plain)
    g = take_rows(scalar_tab, E_idx)                            # [B,L,K,3]
    offset = R_idx[:, :, None] - g[..., 0].long()
    E_chains = (chain_labels[:, :, None] == g[..., 1].long()).long()
    mask_attend = mask[:, :, None] * g[..., 2]

    # Positional block folded through the projection:
    # (table[d] + b) @ W_pos == (table @ W_pos)[d] + b @ W_pos, the row
    # picked by a one-hot product in the compute type (the JAX package's
    # form, features.py:210-219: exact in any type, and its table gradient
    # is a product, not an index scatter). With ``low_pos`` the block is
    # bf16 and E = E_pos + E_rbf promotes to fp32.
    mrf = cfg.max_relative_feature
    d = torch.clamp(offset + mrf, 0, 2 * mrf)
    d = d * E_chains + (1 - E_chains) * (2 * mrf + 1)
    pos_table = p["positional"]["w"] @ W[:n_pos]               # [66,H]
    cdt = torch.bfloat16 if low_pos else pos_table.dtype
    E_pos = F.one_hot(d, pos_table.shape[0]).to(cdt) @ pos_table.to(cdt)
    if "b" in p["positional"]:
        E_pos = E_pos + (p["positional"]["b"] @ W[:n_pos]).to(cdt)
    E = layer_norm(p["norm_edges"], E_pos + E_rbf)
    if "node_embedding" not in p:       # LigandMPNN: h_V starts at zero
        return None, E, E_idx, mask_attend

    V = F.one_hot(batch["R_polymer_type"].long(), cfg.num_polytypes).to(X.dtype)
    V = layer_norm(p["norm_nodes"], V @ p["node_embedding"]["w"])
    return V, E, E_idx, mask_attend
