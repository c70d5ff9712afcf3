"""LigandMPNN on the port's trunk: the atom-context encoder.

LigandMPNN (Dauparas et al., "Atomic context-conditioned protein sequence
design using LigandMPNN", Nature Methods 2025; github.com/dauparas/LigandMPNN,
``model_utils.py``: ``ProteinMPNN(model_type="ligand_mpnn")``,
``ProteinFeaturesLigand``, ``DecLayerJ``; ``data_utils.py``:
``get_nearest_neighbours``) is ProteinMPNN with a second encoder over atoms
that are not designed: ligands, metals and nucleic acids. Here it runs on
NA-MPNN's trunk (``models/mpnn.py``):

* the residues are protein residues; the trunk's edge RBF is ProteinMPNN's
  25 pairs of (N, CA, C, O, virtual CB), which the 18-slot classed RBF
  kernel (row 3) computes once their 400 weight rows are scattered into the
  frame's ``18 * 18 * 16`` (``trunk_features``): a protein residue's other
  slots are absent, so their rows meet only zeros;
* each residue takes its ``atom_context_num`` (25) context atoms nearest
  its virtual CB (``nearest_atoms``), and builds from them the context
  features (``context_features``): the RBF of N, CA, C, O and CB to each
  atom, its element (atomic number, group and period one-hot through
  ``type_linear``) and four angle features in the residue's N-CA-C frame
  (``node_project_down``, LayerNorm); the atoms' own features (``y_nodes``);
  and a dense graph of the 25 atoms, the RBF of every atom pair
  (``y_edges``), 625 rows a residue;
* the protein encoder starts from ``h_V = 0``; after it, ``h_V_C =
  W_c(h_V)`` and ``NUM_CONTEXT_LAYERS`` (2) times: a ``DecLayerJ`` over the atom
  graph (its message reads the receiving atom's own row and the pair's
  edge, not the neighbour's row), then a ``DecLayer(H, 2H)`` from the 25
  atoms into the residue (``context_layer``, one function for both); last
  ``h_V += V_C_norm(dropout(V_C(h_V_C)))``. The decoders, the sampler and
  the score are the trunk's, over 21 letters (``ACDEFGHIKLMNPQRSTVWYX``).

Departures from the published code, each harmless where the published code
is defined:

* ties in the nearest-atom selection go to the lower atom index (a stable
  sort; ``torch.argsort`` there leaves them open), and absent atoms (a
  batch's padding, ``Y_m = 0``) sort after every present one: the published
  code fills absent pairs with 1000 A^2 and runs one structure at a time,
  with no padding, so a residue's own far atoms (beyond 31.6 A) are never
  displaced by another structure's padding here;
* an edge to an absent residue carries a zero RBF (the trunk's frame masks
  absent atoms; only a structure of fewer than K residues has one);
* element 0 (unknown) and 119 take group and period 0; the lanthanides and
  actinides take group 3.

The context encoder is plain PyTorch. With ``compute_dtype="bfloat16"`` it
takes the trunk's policy: parameters cast on the way in, activations and
every product's operands bf16 (fp32 accumulation), LayerNorm statistics
fp32, and ``h_V`` leaves the encoder in fp32. Spans: ``features.context``
around the selection, the context atoms' noise and the context features,
counting ``rows`` (atom-pair rows built); ``model.context`` around the
context layers.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants, trace
from .config import LIGAND_ALPHABET, ModelConfig
from .features import augment_coordinates, get_virtual_atom, rbf_embed
from .modules import (MESSAGE_SCALE, _message_tail, cast_tree, init_dec_layer,
                      init_enc_layer, init_layer_norm, init_linear, layer_norm,
                      linear)

ALPHABET = LIGAND_ALPHABET
UNKNOWN = ALPHABET.index("X")
NUM_CONTEXT_LAYERS = 2      # every released checkpoint's
RESTYPE_TO_INT = {constants.RESTYPE_1_TO_3[a]: i for i, a in enumerate(ALPHABET)
                  if a != "X"}
NUM_ELEMENTS = 120          # one-hot width of the atomic number (0 = unknown)
NUM_GROUPS, NUM_PERIODS = 19, 8
ELEMENT_FEATURES = NUM_ELEMENTS + NUM_GROUPS + NUM_PERIODS     # 147
TYPE_FEATURES = 64
ANGLE_FEATURES = 4

# ProteinMPNN's 25 backbone pairs in ``ProteinFeaturesLigand``'s order, (atom
# of residue i, atom of neighbour j), and their slots in the 18-slot frame
PAIRS = ("CA CA", "N N", "C C", "O O", "CB CB", "CA N", "CA C", "CA O",
         "CA CB", "N C", "N O", "N CB", "CB C", "CB O", "O C", "N CA", "C CA",
         "O CA", "CB CA", "C N", "O N", "CB N", "C CB", "O CB", "C O")
_SLOT = {"N": 0, "CA": 1, "C": 2, "O": 3, "CB": 16}
_FRAME = 18


def _periodic_table():
    """(group, period) of atomic numbers 0..119: periods of 2, 8, 8, 18,
    18, 32, 32 elements; in a period of 32 the 15 lanthanides (actinides)
    take group 3."""
    group = np.zeros(NUM_ELEMENTS, np.int64)
    period = np.zeros(NUM_ELEMENTS, np.int64)
    z = 1
    for p, n in enumerate((2, 8, 8, 18, 18, 32, 32), start=1):
        for k in range(n):
            period[z] = p
            if n == 2:
                group[z] = 1 if k == 0 else 18
            elif n == 8:
                group[z] = k + 1 if k < 2 else k + 11
            elif n == 18:
                group[z] = k + 1
            else:
                group[z] = k + 1 if k < 2 else (3 if k < 17 else k - 13)
            z += 1
    return group, period


ELEMENT_GROUP, ELEMENT_PERIOD = _periodic_table()


def frame_rows(num_rbf: int) -> np.ndarray:
    """The RBF rows of the 18-slot frame (pair (a, b), bin r at ``(a*18 +
    b)*num_rbf + r``) that take ProteinMPNN's 25 pairs, in its order."""
    rows = []
    for pair in PAIRS:
        a, b = (_SLOT[x] for x in pair.split())
        rows.extend((a * _FRAME + b) * num_rbf + r for r in range(num_rbf))
    return np.asarray(rows, np.int64)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_tree(rng, cfg: ModelConfig):
    """LigandMPNN's parameters as a numpy tree in the JAX layout (xavier-
    uniform weights, zero biases, unit LayerNorms) from the numpy Generator
    ``rng``. Key names: the trunk's, ``context`` for the context features
    (``ProteinFeaturesLigand``'s layers), ``W_c``, ``W_nodes_y``,
    ``W_edges_y``, ``V_C``, ``V_C_norm``, and the layers ``context_layers``
    (``context_encoder_layers``) and ``y_context_layers``
    (``y_context_encoder_layers``)."""
    H, nr = cfg.hidden_dim, cfg.num_rbf
    n_pos = cfg.num_positional_embeddings
    nf = cfg.node_features
    return {
        "features": {
            "positional": init_linear(rng, 2 * cfg.max_relative_feature + 2, n_pos),
            "edge_embedding": init_linear(rng, cfg.edge_in, cfg.edge_features,
                                          bias=False),
            "norm_edges": init_layer_norm(cfg.edge_features),
        },
        "context": {
            "type_linear": init_linear(rng, ELEMENT_FEATURES, TYPE_FEATURES),
            "node_project_down": init_linear(
                rng, 5 * nr + TYPE_FEATURES + ANGLE_FEATURES, nf),
            "norm_nodes": init_layer_norm(nf),
            "y_nodes": init_linear(rng, ELEMENT_FEATURES, nf, bias=False),
            "y_edges": init_linear(rng, nr, nf, bias=False),
            "norm_y_nodes": init_layer_norm(nf),
            "norm_y_edges": init_layer_norm(nf),
        },
        "W_v": init_linear(rng, nf, H),
        "W_e": init_linear(rng, cfg.edge_features, H),
        "W_c": init_linear(rng, H, H),
        "W_nodes_y": init_linear(rng, H, H),
        "W_edges_y": init_linear(rng, H, H),
        "V_C": init_linear(rng, H, H, bias=False),
        "V_C_norm": init_layer_norm(H),
        "W_s": {"emb": rng.standard_normal((cfg.vocab, H)).astype(np.float32)},
        "W_out": init_linear(rng, H, cfg.num_letters),
        "encoder": [init_enc_layer(rng, H, 2 * H)
                    for _ in range(cfg.num_encoder_layers)],
        "decoder": [init_dec_layer(rng, H, 3 * H)
                    for _ in range(cfg.num_decoder_layers)],
        "context_layers": [init_dec_layer(rng, H, 2 * H)
                           for _ in range(NUM_CONTEXT_LAYERS)],
        "y_context_layers": [init_dec_layer(rng, H, H)
                             for _ in range(NUM_CONTEXT_LAYERS)],
    }


def trunk_features(params, cfg: ModelConfig):
    """The trunk featuriser's tree for ``features_from_coords``: the
    positional rows of ``edge_embedding`` as they are, its 25 pairs' rows
    scattered into the 18-slot frame (zeros elsewhere; differentiable), no
    node embedding."""
    f = params["features"]
    W = f["edge_embedding"]["w"]
    n_pos = cfg.num_positional_embeddings
    rows = torch.as_tensor(frame_rows(cfg.num_rbf), device=W.device)
    W_rbf = W.new_zeros((cfg.num_rbf * _FRAME * _FRAME, W.shape[1]))
    W_rbf = W_rbf.index_copy(0, rows, W[n_pos:])
    return {"positional": f["positional"],
            "edge_embedding": {"w": torch.cat([W[:n_pos], W_rbf])},
            "norm_edges": f["norm_edges"]}


# ---------------------------------------------------------------------------
# Context atoms and their features
# ---------------------------------------------------------------------------

def virtual_cb(X):
    """The virtual CB of each residue from the frame's N, CA, C."""
    return get_virtual_atom(X[:, :, 0], X[:, :, 1], X[:, :, 2], *constants.CB_WEIGHTS)


def nearest_atoms(X, mask, Y, Y_t, Y_m, num: int):
    """The ``num`` context atoms nearest each residue's virtual CB
    (``get_nearest_neighbours``): ``X [B,L,16,3]``, ``mask [B,L]``, the
    structure's atoms ``Y [B,N,3]``, ``Y_t [B,N]`` (atomic numbers), ``Y_m
    [B,N]`` -> (``Y [B,L,num,3]``, ``Y_t``, ``Y_m [B,L,num]``), nearest
    first. The squared distance is summed as ``(dx*dx + dy*dy) + dz*dz``;
    a pair of a present residue and a present atom sorts by it, a pair with
    an absent residue at 1000 A^2 (as published), a pair with an absent atom
    after every other; ties go to the lower index. Fewer than ``num`` atoms
    leave the last slots zero and absent."""
    cb = virtual_cb(X)
    d = cb[:, :, None, :] - Y[:, None, :, :].to(cb.dtype)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    d2 = d2 + d[..., 2] * d[..., 2]
    m = mask.to(d2.dtype)[:, :, None]
    d2 = d2 * m + (1.0 - m) * 1000.0
    d2 = torch.where(Y_m[:, None, :] > 0, d2, float("inf"))
    B, L, N = d2.shape
    n = min(num, N)
    idx = torch.sort(d2, dim=-1, stable=True)[1][..., :n]
    Ys = torch.gather(Y[:, None].expand(B, L, N, 3), 2,
                      idx[..., None].expand(B, L, n, 3))
    Ts = torch.gather(Y_t[:, None].expand(B, L, N), 2, idx)
    Ms = torch.gather(Y_m[:, None].expand(B, L, N), 2, idx)
    if n < num:
        Ys = F.pad(Ys, (0, 0, 0, num - n))
        Ts = F.pad(Ts, (0, num - n))
        Ms = F.pad(Ms, (0, num - n))
    return Ys, Ts, Ms


def element_one_hot(Y_t, dtype):
    """Atomic number, group and period one-hot: ``[..., 147]``."""
    t = Y_t.long()
    group = torch.as_tensor(ELEMENT_GROUP, device=t.device)[t]
    period = torch.as_tensor(ELEMENT_PERIOD, device=t.device)[t]
    return torch.cat([F.one_hot(t, NUM_ELEMENTS), F.one_hot(group, NUM_GROUPS),
                      F.one_hot(period, NUM_PERIODS)], dim=-1).to(dtype)


def angle_features(N, CA, C, Y):
    """Four features of each context atom in the residue's frame (e1 along
    N - CA, e2 the rest of C - CA, e3 = e1 x e2): (x, y) / r_xy, r_xy / r,
    z / r (``_make_angle_features``)."""
    v1, v2 = N - CA, C - CA
    e1 = F.normalize(v1, dim=-1)
    u2 = v2 - e1 * (e1 * v2).sum(-1, keepdim=True)
    e2 = F.normalize(u2, dim=-1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    R = torch.stack([e1, e2, e3], dim=-1)                  # [B,L,3(q),3(p)]
    local = torch.einsum("blqp,blyq->blyp", R, Y - CA[:, :, None, :])
    rxy = torch.sqrt(local[..., 0] ** 2 + local[..., 1] ** 2 + 1e-8)
    rxyz = torch.linalg.norm(local, dim=-1) + 1e-8
    return torch.stack([local[..., 0] / rxy, local[..., 1] / rxy, rxy / rxyz,
                        local[..., 2] / rxyz], dim=-1)


def context_features(p, cfg: ModelConfig, X, Y, Y_t, cdt=None):
    """(``V [B,L,M,node_features]``, ``Y_nodes [B,L,M,H]``, ``Y_edges
    [B,L,M,M,H]``) of the context atoms ``Y [B,L,M,3]`` of each residue of
    ``X [B,L,16,3]``. Distances, RBFs, one-hots and angles are built in the
    coordinates' type; with ``cdt`` (bf16) they are rounded to it at their
    first product, which returns ``cdt``."""
    N, CA, C, O = X[:, :, 0], X[:, :, 1], X[:, :, 2], X[:, :, 3]
    CB = virtual_cb(X)

    def rbf_to(A):
        return rbf_embed(torch.sqrt(((A[:, :, None, :] - Y) ** 2).sum(-1) + 1e-6),
                         cfg.num_rbf)

    def lin(q, x):
        return linear(q, x if cdt is None else x.to(cdt))

    onehot = element_one_hot(Y_t, X.dtype)
    D_all = torch.cat([rbf_to(N), rbf_to(CA), rbf_to(C), rbf_to(O), rbf_to(CB),
                       lin(p["type_linear"], onehot).to(X.dtype),
                       angle_features(N, CA, C, Y)], dim=-1)
    V = layer_norm(p["norm_nodes"], lin(p["node_project_down"], D_all))
    D_yy = torch.sqrt(((Y[:, :, :, None, :] - Y[:, :, None, :, :]) ** 2).sum(-1) + 1e-6)
    Y_edges = layer_norm(p["norm_y_edges"],
                         lin(p["y_edges"], rbf_embed(D_yy, cfg.num_rbf)))
    Y_nodes = layer_norm(p["norm_y_nodes"], lin(p["y_nodes"], onehot))
    return V, Y_nodes, Y_edges


# ---------------------------------------------------------------------------
# Context layers
# ---------------------------------------------------------------------------

def context_layer(p, h_V, h_E, mask_V, mask_attend, drop=None):
    """``DecLayer`` with the receiving row's own state: the message of
    ``cat(h_V_i, h_E_ij)`` (``W1``'s first H rows take ``h_V``, applied once
    per row and broadcast over the neighbours), masked by ``mask_attend``,
    summed / 30; LN1, FFN, LN2, ``mask_V``. ``h_V [..., H]``, ``h_E [..., M,
    C]``: the atom graph (``DecLayerJ``: ``h_V [B,L,M,H]``, ``h_E
    [B,L,M,M,H]``) or the atoms into the residue (``h_V [B,L,H]``, ``h_E
    [B,L,M,2H]``). ``drop(x, slot)`` on the message (0) and the FFN output
    (1)."""
    from .mpnn import _no_dropout, _node_tail

    H = h_V.shape[-1]
    w1 = p["W1"]["w"]
    x = h_E @ w1[H:] + (h_V @ w1[:H] + p["W1"]["b"]).unsqueeze(-2)
    m = mask_attend.to(x.dtype)[..., None] * _message_tail(p, x)
    dh = m.sum(-2) / MESSAGE_SCALE
    return _node_tail(p, h_V, dh, mask_V.to(h_V.dtype), drop or _no_dropout)


def context_encoder(params, cfg: ModelConfig, h_V, V, Y_nodes, Y_edges, Y_m, mask,
                    drop=None):
    """``h_V`` of the protein encoder plus the context: ``h_V_C = W_c(h_V)``;
    per context layer the atom graph (``y_context_layers``) then the atoms
    into the residue (``context_layers``, over ``cat(W_v(V), Y_nodes)``);
    ``h_V + V_C_norm(dropout(V_C(h_V_C)))``, in fp32. Span
    ``model.context``."""
    with trace.span("model.context", rows=int(Y_edges.shape[:-1].numel())):
        cdt = Y_edges.dtype if Y_edges.dtype == torch.bfloat16 else None
        keys = ("W_v", "W_c", "W_nodes_y", "W_edges_y", "V_C", "context_layers",
                "y_context_layers")
        q = {k: params[k] for k in keys}
        if cdt is not None:
            q = cast_tree(q, cdt)
        mask = mask.to(h_V.dtype if cdt is None else cdt)
        Y_m = Y_m.to(mask.dtype)
        Y_m_edges = Y_m[..., :, None] * Y_m[..., None, :]
        h_E_context = linear(q["W_v"], V)
        h_V_C = linear(q["W_c"], h_V if cdt is None else h_V.to(cdt))
        Y_nodes = linear(q["W_nodes_y"], Y_nodes)
        Y_edges = linear(q["W_edges_y"], Y_edges)
        for py, pc in zip(q["y_context_layers"], q["context_layers"]):
            Y_nodes = context_layer(py, Y_nodes, Y_edges, Y_m, Y_m_edges, drop)
            h_V_C = context_layer(pc, h_V_C, torch.cat([h_E_context, Y_nodes], -1),
                                  mask, Y_m, drop)
        h_V_C = linear(q["V_C"], h_V_C)
        if drop is not None:
            h_V_C = drop(h_V_C, 0)
        h_V_C = layer_norm(params["V_C_norm"], h_V_C.float() if cdt else h_V_C)
        return (h_V.float() if cdt else h_V) + h_V_C


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, batch, generator=None):
    """LigandMPNN's encode -> (``h_V [B,L,H]``, ``h_E [B,L,K,H]``, ``E_idx``),
    as ``mpnn.encode`` returns them. The batch carries the structure's
    context atoms ``Y [B,N,3]``, ``Y_t``, ``Y_m [B,N]``. The context atoms
    are chosen on the coordinates as given; with a ``generator`` the
    coordinates then take the training noise (the residues' atoms as the
    trunk's, ``protein_augment_eps`` on each context slot after them), and
    every layer dropout (the encoder's, then the context layers' in order,
    then the one on ``V_C``)."""
    from .features import features_from_coords
    from .mpnn import _plain, _trunk_dtype, encoder_stack, generator_dropout

    plain = _plain(cfg, batch["X"])
    X = batch["X"]
    mask = batch["mask"].to(X.dtype)
    B, L = mask.shape
    M = cfg.atom_context_num
    cdt = _trunk_dtype(cfg)
    with trace.span("features.context", rows=B * L * M * M):
        Y, Y_t, Y_m = nearest_atoms(X, mask, batch["Y"], batch["Y_t"], batch["Y_m"], M)
        Y = Y.to(X.dtype)
        eps = cfg.protein_augment_eps
        if generator is not None and max(cfg.protein_augment_eps, cfg.dna_augment_eps,
                                         cfg.rna_augment_eps) > 0:
            X = augment_coordinates(X, batch["X_m"], batch, cfg, generator)
        if generator is not None and eps > 0:
            Y = Y + eps * torch.randn(Y.shape, generator=generator, dtype=Y.dtype,
                                      device=Y.device)
        q = params["context"] if cdt is None else cast_tree(params["context"], cdt)
        V, Y_nodes, Y_edges = context_features(q, cfg, X, Y, Y_t, cdt)
    _, E, E_idx, mask_attend = features_from_coords(trunk_features(params, cfg), cfg,
                                                    batch, X, plain)
    drop = generator_dropout(cfg.dropout, generator)
    h_V = torch.zeros((B, L, cfg.hidden_dim), dtype=E.dtype, device=E.device)
    h_V, h_E = encoder_stack(params, cfg, h_V, E, E_idx, mask, mask_attend, plain,
                             drop)
    h_V = context_encoder(params, cfg, h_V, V, Y_nodes, Y_edges, Y_m, mask, drop)
    return h_V, h_E, E_idx
