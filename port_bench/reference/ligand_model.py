"""LigandMPNN's forward in plain PyTorch, written from the published code
(github.com/dauparas/LigandMPNN: ``model_utils.py``, ``ProteinMPNN`` with
``model_type="ligand_mpnn"``, ``ProteinFeaturesLigand``, ``DecLayerJ``,
``DecLayer``, ``EncLayer``; ``data_utils.py``, ``get_nearest_neighbours``),
on a state dict under LigandMPNN's own key names (``features.*``, ``W_e``,
``W_v``, ``W_c``, ``W_nodes_y``, ``W_edges_y``, ``V_C``, ``V_C_norm``,
``W_s``, ``W_out``, ``encoder_layers.i``, ``decoder_layers.i``,
``context_encoder_layers.i``, ``y_context_encoder_layers.i``; ``nn.Linear``
weights ``[out, in]``).

The protein features are ProteinMPNN's: 25 backbone atom pairs of (N, CA,
C, O, virtual CB) in the published order, 16 RBF bins over 2-22 A, a
relative position one-hot of 66 classes, the kNN on CA. The context: each
residue's 25 atoms nearest its CB, their RBF to the five backbone atoms,
element one-hots (atomic number 120, group 19, period 8) through
``type_linear``, four angle features in the residue frame, and the RBF of
every pair of the 25 atoms. The encoder starts from ``h_V = 0``; after it
two rounds of ``DecLayerJ`` on the atom graph (message of the receiving
atom's own row and the edge) and ``DecLayer`` from the atoms into the
residue; ``h_V += V_C_norm(dropout(V_C(h_V_C)))``. Decoders as in
``model.py`` (the same ``decoder``), over 21 letters.

Departures from the published code, each noted where it is made: ties in
the nearest-atom selection go to the lower index and absent atoms sort
after every present one (the published code runs one unpadded structure at
a time); element 0 and 119 take group and period 0, the lanthanides and
actinides group 3; an edge to an absent residue has a zero RBF.

Every product of a weight goes through ``model.Precision``. Nothing of the
program (``na_mpnn_tpu_torch``) and nothing of JAX is imported.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import model as M

ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"
X_TOKEN = 20
CB_W = (-0.58273431, 0.56802827, -0.54067466)
ATOM_CONTEXT = 25


def _tables():
    """(group, period) of atomic numbers 0..119 from the periodic table's
    rows (2, 8, 8, 18, 18, 32, 32 elements; f-block in group 3)."""
    group, period = [0] * 120, [0] * 120
    z = 1
    for p, n in enumerate((2, 8, 8, 18, 18, 32, 32), start=1):
        for k in range(n):
            period[z] = p
            if n == 2:
                group[z] = (1, 18)[k]
            elif n == 8:
                group[z] = k + 1 if k < 2 else k + 11
            elif n == 18:
                group[z] = k + 1
            elif k < 2:
                group[z] = k + 1
            elif k < 17:
                group[z] = 3
            else:
                group[z] = k - 13
            z += 1
    return group, period


GROUP, PERIOD = _tables()


def cb(N, CA, C):
    b = CA - N
    c = C - CA
    a = torch.linalg.cross(b, c, dim=-1)
    return CB_W[0] * a + CB_W[1] * b + CB_W[2] * c + CA


def nearest_atoms(X, mask, Y, Y_t, Y_m, num=ATOM_CONTEXT):
    """``get_nearest_neighbours`` over a batch: each residue's ``num`` atoms
    of ``Y [B,N,3]`` nearest its CB, by the squared distance summed as
    ``(dx*dx + dy*dy) + dz*dz``, 1000 for an absent residue (published);
    absent atoms after all (departure: the published code has no padding),
    ties to the lower index (departure: a stable sort)."""
    CB = cb(X[:, :, 0], X[:, :, 1], X[:, :, 2])
    d = CB[:, :, None, :] - Y[:, None, :, :]
    L2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    L2 = L2 + d[..., 2] * d[..., 2]
    m = mask[:, :, None].to(L2.dtype)
    L2 = L2 * m + (1.0 - m) * 1000.0
    L2 = torch.where(Y_m[:, None, :] > 0, L2, float("inf"))
    B, L, N = L2.shape
    out_Y = torch.zeros((B, L, num, 3), dtype=Y.dtype, device=Y.device)
    out_t = torch.zeros((B, L, num), dtype=torch.long, device=Y.device)
    out_m = torch.zeros((B, L, num), dtype=Y.dtype, device=Y.device)
    nn_idx = torch.argsort(L2, dim=-1, stable=True)[..., :num]
    n = nn_idx.shape[-1]
    bi = torch.arange(B, device=Y.device)[:, None, None]
    out_Y[:, :, :n] = Y[bi, nn_idx]
    out_t[:, :, :n] = Y_t.long()[bi, nn_idx]
    out_m[:, :, :n] = Y_m.to(Y.dtype)[bi, nn_idx]
    return out_Y, out_t, out_m


def _rbf(D):
    mu = torch.linspace(M.RBF_MIN, M.RBF_MAX, M.RBF_BINS, dtype=D.dtype, device=D.device)
    sigma = (M.RBF_MAX - M.RBF_MIN) / M.RBF_BINS
    return torch.exp(-((D[..., None] - mu) / sigma) ** 2)


def _angles(A, Bc, C, Y):
    """``_make_angle_features(N, Ca, C, Y)``."""
    v1, v2 = A - Bc, C - Bc
    e1 = F.normalize(v1, dim=-1)
    e1_v2_dot = torch.einsum("bli,bli->bl", e1, v2)[..., None]
    u2 = v2 - e1 * e1_v2_dot
    e2 = F.normalize(u2, dim=-1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    R = torch.cat([e1[..., None], e2[..., None], e3[..., None]], dim=-1)
    local = torch.einsum("blqp,blyq->blyp", R, Y - Bc[:, :, None, :])
    rxy = torch.sqrt(local[..., 0] ** 2 + local[..., 1] ** 2 + 1e-8)
    f1, f2 = local[..., 0] / rxy, local[..., 1] / rxy
    rxyz = torch.norm(local, dim=-1) + 1e-8
    return torch.stack([f1, f2, rxy / rxyz, local[..., 2] / rxyz], dim=-1)


PAIRS = (("CA", "CA"), ("N", "N"), ("C", "C"), ("O", "O"), ("CB", "CB"),
         ("CA", "N"), ("CA", "C"), ("CA", "O"), ("CA", "CB"), ("N", "C"),
         ("N", "O"), ("N", "CB"), ("CB", "C"), ("CB", "O"), ("O", "C"),
         ("N", "CA"), ("C", "CA"), ("O", "CA"), ("CB", "CA"), ("C", "N"),
         ("O", "N"), ("CB", "N"), ("C", "CB"), ("O", "CB"), ("C", "O"))


def features(sd, batch, k, prec, X=None, Y=None, Y_t=None, Y_m=None):
    """``ProteinFeaturesLigand.forward`` after ``featurize``: (``V [B,L,M,
    128]`` the context nodes (``E_context``), ``E [B,L,K,128]``, ``E_idx``,
    ``Y_nodes``, ``Y_edges``, ``Y_m``). ``X`` (the frame's first four slots
    are N, CA, C, O) and ``Y`` (each residue's context atoms ``[B,L,M,3]``)
    replace the batch's (the noised coordinates)."""
    X = batch["X"] if X is None else X
    mask = batch["mask"].to(X.dtype)
    N, Ca, C, O = X[:, :, 0], X[:, :, 1], X[:, :, 2], X[:, :, 3]
    Cb = cb(N, Ca, C)
    atoms = {"N": N, "CA": Ca, "C": C, "O": O, "CB": Cb}
    E_idx = M.neighbours(Ca, mask, k)
    B, L, K = E_idx.shape

    def get_rbf(A, Bt):
        D = torch.sqrt(((A[:, :, None, :] - Bt[:, None, :, :]) ** 2).sum(-1) + 1e-6)
        D = torch.gather(D, 2, E_idx)
        return _rbf(D)

    RBF_all = torch.cat([get_rbf(atoms[a], atoms[b]) for a, b in PAIRS], dim=-1)
    # an edge to or from an absent residue carries no RBF (departure)
    RBF_all = RBF_all * mask[:, :, None, None] * M.gather_nodes(mask[..., None], E_idx)
    R = batch["R_idx"].long()
    off = R[:, :, None] - M.gather_nodes(R[..., None], E_idx)[..., 0]
    same = (batch["chain_labels"].long()[:, :, None]
            == M.gather_nodes(batch["chain_labels"].long()[..., None], E_idx)[..., 0])
    d = torch.clamp(off + M.MAX_REL, 0, 2 * M.MAX_REL) * same + (~same) * (2 * M.MAX_REL + 1)
    E_pos = M.linear(sd, "features.embeddings.linear",
                     F.one_hot(d, 2 * M.MAX_REL + 2).to(X.dtype), prec)
    E = M.linear(sd, "features.edge_embedding", torch.cat([E_pos, RBF_all], -1), prec)
    E = M.layer_norm(sd, "features.norm_edges", E)

    Y_t = Y_t.long()
    g = torch.as_tensor(GROUP, device=Y_t.device)[Y_t]
    p = torch.as_tensor(PERIOD, device=Y_t.device)[Y_t]
    Y_t_1hot_ = torch.cat([F.one_hot(Y_t, 120), F.one_hot(g, 19), F.one_hot(p, 8)],
                          -1).to(X.dtype)
    Y_t_1hot = M.linear(sd, "features.type_linear", Y_t_1hot_, prec)

    def to_y(A):
        return _rbf(torch.sqrt(torch.sum((A[:, :, None, :] - Y) ** 2, -1) + 1e-6))

    D_all = torch.cat([to_y(N), to_y(Ca), to_y(C), to_y(O), to_y(Cb), Y_t_1hot,
                       _angles(N, Ca, C, Y)], dim=-1)
    V = M.layer_norm(sd, "features.norm_nodes",
                     M.linear(sd, "features.node_project_down", D_all, prec))
    Y_edges = _rbf(torch.sqrt(torch.sum((Y[:, :, :, None, :] - Y[:, :, None, :, :]) ** 2,
                                        -1) + 1e-6))
    Y_edges = M.linear(sd, "features.y_edges", Y_edges, prec)
    Y_nodes = M.linear(sd, "features.y_nodes", Y_t_1hot_, prec)
    Y_edges = M.layer_norm(sd, "features.norm_y_edges", Y_edges)
    Y_nodes = M.layer_norm(sd, "features.norm_y_nodes", Y_nodes)
    return V, E, E_idx, Y_nodes, Y_edges, Y_m


def _dec_layer(sd, p, h_V, h_E, mask_V, mask_attend, prec, drop):
    """``DecLayer`` / ``DecLayerJ``: ``h_V`` expanded over the neighbour
    axis and concatenated with ``h_E``; the message MLP, masked, summed /
    30; LN1, FFN, LN2, ``mask_V``. ``drop(x, slot)`` on the message (0) and
    the FFN (1)."""
    h_V_expand = h_V.unsqueeze(-2).expand(*h_E.shape[:-1], h_V.shape[-1])
    h_EV = torch.cat([h_V_expand, h_E], -1)
    h_message = M._mlp(sd, p, h_EV, prec)
    h_message = mask_attend.unsqueeze(-1) * h_message
    dh = torch.sum(h_message, -2) / M.MESSAGE_SCALE
    h_V = M.layer_norm(sd, f"{p}.norm1", h_V + M._keep(dh, drop, 0))
    h_V = M.layer_norm(sd, f"{p}.norm2", h_V + M._keep(M._ffn(sd, p, h_V, prec), drop, 1))
    return mask_V.unsqueeze(-1) * h_V


def context(sd, h_V, V, Y_nodes, Y_edges, Y_m, mask, prec, drop=None):
    """The context encoder after the protein encoder."""
    n = sum(1 for key in sd if key.startswith("context_encoder_layers.")
            and key.endswith(".W1.weight"))
    h_E_context = M.linear(sd, "W_v", V, prec)
    h_V_C = M.linear(sd, "W_c", h_V, prec)
    Y_m_edges = Y_m[:, :, :, None] * Y_m[:, :, None, :]
    Y_nodes = M.linear(sd, "W_nodes_y", Y_nodes, prec)
    Y_edges = M.linear(sd, "W_edges_y", Y_edges, prec)
    for i in range(n):
        Y_nodes = _dec_layer(sd, f"y_context_encoder_layers.{i}", Y_nodes, Y_edges, Y_m,
                             Y_m_edges, prec, drop)
        h_E_context_cat = torch.cat([h_E_context, Y_nodes], -1)
        h_V_C = _dec_layer(sd, f"context_encoder_layers.{i}", h_V_C, h_E_context_cat,
                           mask, Y_m, prec, drop)
    h_V_C = M.linear(sd, "V_C", h_V_C, prec)
    return h_V + M.layer_norm(sd, "V_C_norm", M._keep(h_V_C, drop, 0))


def encode(sd, batch, k, prec, X=None, Y=None, Y_t=None, Y_m=None, drop=None):
    """(``h_V``, ``h_E``, ``E_idx``) of LigandMPNN's ``encode``; ``Y``,
    ``Y_t``, ``Y_m`` are each residue's context atoms (``nearest_atoms``)."""
    X = batch["X"] if X is None else X
    mask = batch["mask"].to(X.dtype)
    V, E, E_idx, Y_nodes, Y_edges, Y_m = features(sd, batch, k, prec, X, Y, Y_t, Y_m)
    h_E = M.linear(sd, "W_e", E, prec)
    h_V = torch.zeros(E.shape[0], E.shape[1], h_E.shape[-1], dtype=X.dtype, device=X.device)
    mask_attend = mask[:, :, None] * M.gather_nodes(mask[..., None], E_idx)[..., 0]
    h_V, h_E = M.encoder(sd, h_V, h_E, E_idx, mask, mask_attend, prec, drop)
    h_V = context(sd, h_V, V, Y_nodes, Y_edges, Y_m, mask, prec, drop)
    return h_V, h_E, E_idx


def log_probs(sd, batch, k, prec, S, order):
    """Teacher-forced log-probabilities of ``S`` under ``order`` (``S``
    None: the unconditional ones), deterministic."""
    mask = batch["mask"].float()
    Y, Y_t, Y_m = nearest_atoms(batch["X"], mask, batch["Y"], batch["Y_t"], batch["Y_m"])
    h_V, h_E, E_idx = encode(sd, batch, k, prec, Y=Y, Y_t=Y_t, Y_m=Y_m)
    return M.decoder(sd, h_V, h_E, E_idx, mask, S, order, prec)


ELEMENTS = (
    "H HE LI BE B C N O F NE NA MG AL SI P S CL AR K CA SC TI V CR MN FE CO NI "
    "CU ZN GA GE AS SE BR KR RB SR Y ZR NB MO TC RU RH PD AG CD IN SN SB TE I "
    "XE CS BA LA CE PR ND PM SM EU GD TB DY HO ER TM YB LU HF TA W RE OS IR PT "
    "AU HG TL PB BI PO AT RN FR RA AC TH PA U NP PU AM CM BK CF ES FM MD NO LR "
    "RF DB SG BH HS MT DS RG CN NH FL MC LV TS OG").split()
_WATER = {"HOH", "WAT", "DOD", "H2O"}
_PROTEIN = ("ALA", "CYS", "ASP", "GLU", "PHE", "GLY", "HIS", "ILE", "LYS", "LEU",
            "MET", "ASN", "PRO", "GLN", "ARG", "SER", "THR", "VAL", "TRP", "TYR")


def read_pdb(path):
    """A PDB file as LigandMPNN reads it: the protein residues with N, CA,
    C and O (file order; ``X [L,4,3]`` in that order, tokens in
    ``ACDEFGHIKLMNPQRSTVWYX``) and the context atoms ``Y [N,3]``, ``Y_t``
    (atomic number) of every other residue but water, hydrogens left out.
    Residue names outside the twenty are not protein here."""
    residues, index, context = [], {}, []
    with open(path) as f:
        lines = [ln for ln in f if ln.startswith(("ATOM", "HETATM"))]
    for ln in lines:
        name, resname = ln[12:16].strip(), ln[17:20].strip()
        key = (ln[21], int(ln[22:26]), ln[26].strip())
        xyz = (float(ln[30:38]), float(ln[38:46]), float(ln[46:54]))
        element = ln[76:78].strip().upper() if len(ln) > 76 else ""
        if resname in _PROTEIN:
            if key not in index:
                index[key] = len(residues)
                residues.append({"key": key, "resname": resname, "atoms": {}})
            residues[index[key]]["atoms"].setdefault(name, xyz)
        elif resname not in _WATER and element in ELEMENTS and element != "H":
            context.append((xyz, ELEMENTS.index(element) + 1))
    residues = [r for r in residues if all(a in r["atoms"] for a in ("N", "CA", "C", "O"))]
    X = np.array([[r["atoms"][a] for a in ("N", "CA", "C", "O")] for r in residues],
                 np.float32)
    chains = {}
    for r in residues:
        chains.setdefault(r["key"][0], len(chains))
    one = dict(zip(_PROTEIN, "ACDEFGHIKLMNPQRSTVWY"))
    S = np.array([ALPHABET.index(one[r["resname"]]) for r in residues], np.int64)
    Y = np.array([c[0] for c in context], np.float32).reshape(-1, 3)
    Y_t = np.array([c[1] for c in context], np.int64)
    return {"X": X, "S": S, "mask": np.ones(len(residues), np.float32),
            "R_idx": np.array([r["key"][1] for r in residues], np.int64),
            "chain_labels": np.array([chains[r["key"][0]] for r in residues], np.int64),
            "Y": Y, "Y_t": Y_t, "Y_m": np.ones(len(Y_t), np.float32)}
