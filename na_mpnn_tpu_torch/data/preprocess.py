"""Offline dataset preprocessing: base-pair labels + interface masks (the
port's own numpy copy of the JAX package's ``data/preprocess.py``, array for
array).

Vectorized numpy re-implementation of the reference preprocessor (reference
data/preprocess_dataset.py). The reference's H-bond engine is a pure-Python
double loop over residue pairs x donor/acceptor atoms (its slowest component,
data/preprocess_dataset.py:244-335); here candidate pairs are grouped by
residue-type pair and evaluated as numpy batches, with identical thresholds
and the same quirks (including the donor-first atom-pair dedup and the
top-left-block Y_ij indexing of _compute_pairwise_base_params — see notes).

Outputs the same eight per-structure .npy side files consumed by the training
loader (reference na_data_utils.py:906-957).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .. import constants

INTERFACE_DISTANCE_CUTOFF = 5.0  # Å (reference data/preprocess_dataset.py:21)

# ---------------------------------------------------------------------------
# RFaa-style residue tables (heavy atoms only; reference HB_data.aa2long,
# data/preprocess_dataset.py:101-137). Slot 1 is the frame atom
# (CA for protein, C1' for nucleic).
# ---------------------------------------------------------------------------

RFAA_TYPES = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "UNK", "MAS",
    "DA", "DC", "DG", "DT", "DX", "RA", "RC", "RG", "RU", "RX",
]
RFAA_TYPE_TO_INT = {t: i for i, t in enumerate(RFAA_TYPES)}
NTOTAL = 36  # atom slots per residue (heavy atoms occupy the leading slots)

RFAA_HEAVY_ATOMS: Dict[str, Tuple[str, ...]] = {
    "ALA": ("N", "CA", "C", "O", "CB"),
    "ARG": ("N", "CA", "C", "O", "CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"),
    "ASN": ("N", "CA", "C", "O", "CB", "CG", "OD1", "ND2"),
    "ASP": ("N", "CA", "C", "O", "CB", "CG", "OD1", "OD2"),
    "CYS": ("N", "CA", "C", "O", "CB", "SG"),
    "GLN": ("N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "NE2"),
    "GLU": ("N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "OE2"),
    "GLY": ("N", "CA", "C", "O"),
    "HIS": ("N", "CA", "C", "O", "CB", "CG", "ND1", "CD2", "CE1", "NE2"),
    "ILE": ("N", "CA", "C", "O", "CB", "CG1", "CG2", "CD1"),
    "LEU": ("N", "CA", "C", "O", "CB", "CG", "CD1", "CD2"),
    "LYS": ("N", "CA", "C", "O", "CB", "CG", "CD", "CE", "NZ"),
    "MET": ("N", "CA", "C", "O", "CB", "CG", "SD", "CE"),
    "PHE": ("N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"),
    "PRO": ("N", "CA", "C", "O", "CB", "CG", "CD"),
    "SER": ("N", "CA", "C", "O", "CB", "OG"),
    "THR": ("N", "CA", "C", "O", "CB", "OG1", "CG2"),
    "TRP": ("N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "NE1", "CE2",
            "CE3", "CZ2", "CZ3", "CH2"),
    "TYR": ("N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2",
            "CZ", "OH"),
    "VAL": ("N", "CA", "C", "O", "CB", "CG1", "CG2"),
    "UNK": ("N", "CA", "C", "O", "CB"),
    "MAS": ("N", "CA", "C", "O", "CB"),
    "DA": ("O4'", "C1'", "C2'", "OP1", "P", "OP2", "O5'", "C5'", "C4'", "C3'",
           "O3'", "N9", "C4", "N3", "C2", "N1", "C6", "C5", "N7", "C8", "N6"),
    "DC": ("O4'", "C1'", "C2'", "OP1", "P", "OP2", "O5'", "C5'", "C4'", "C3'",
           "O3'", "N1", "C2", "O2", "N3", "C4", "N4", "C5", "C6"),
    "DG": ("O4'", "C1'", "C2'", "OP1", "P", "OP2", "O5'", "C5'", "C4'", "C3'",
           "O3'", "N9", "C4", "N3", "C2", "N1", "C6", "C5", "N7", "C8", "N2", "O6"),
    "DT": ("O4'", "C1'", "C2'", "OP1", "P", "OP2", "O5'", "C5'", "C4'", "C3'",
           "O3'", "N1", "C2", "O2", "N3", "C4", "O4", "C5", "C7", "C6"),
    "DX": ("O4'", "C1'", "C2'", "OP1", "P", "OP2", "O5'", "C5'", "C4'", "C3'",
           "O3'"),
    "RA": ("O4'", "C1'", "C2'", "OP1", "P", "OP2", "O5'", "C5'", "C4'", "C3'",
           "O3'", "O2'", "N1", "C2", "N3", "C4", "C5", "C6", "N6", "N7", "C8", "N9"),
    "RC": ("O4'", "C1'", "C2'", "OP1", "P", "OP2", "O5'", "C5'", "C4'", "C3'",
           "O3'", "O2'", "N1", "C2", "O2", "N3", "C4", "N4", "C5", "C6"),
    "RG": ("O4'", "C1'", "C2'", "OP1", "P", "OP2", "O5'", "C5'", "C4'", "C3'",
           "O3'", "O2'", "N1", "C2", "N2", "N3", "C4", "C5", "C6", "O6", "N7",
           "C8", "N9"),
    "RU": ("O4'", "C1'", "C2'", "OP1", "P", "OP2", "O5'", "C5'", "C4'", "C3'",
           "O3'", "O2'", "N1", "C2", "O2", "N3", "C4", "O4", "C5", "C6"),
    "RX": ("O4'", "C1'", "C2'", "OP1", "P", "OP2", "O5'", "C5'", "C4'", "C3'",
           "O3'", "O2'"),
}

RFAA_ATOM_SLOT = {t: {a: i for i, a in enumerate(atoms)}
                  for t, atoms in RFAA_HEAVY_ATOMS.items()}

# H-bond donor/acceptor atoms per residue type, in list order (order matters
# for the dedup quirk; reference HB_data._init_hb_chemdata,
# data/preprocess_dataset.py:637-702). Entries: (atom, is_donor).
HBOND_ATOMS: Dict[str, List[Tuple[str, int]]] = {
    "ALA": [], "GLY": [], "ILE": [], "LEU": [], "PHE": [], "PRO": [],
    "VAL": [], "UNK": [], "MAS": [], "DX": [],
    "ARG": [("NH1", 1), ("NH2", 1)],
    "ASN": [("ND2", 1), ("OD1", 0)],
    "ASP": [("OD2", 1), ("OD1", 0), ("OD2", 0)],
    "CYS": [("SG", 1)],
    "GLN": [("NE2", 1), ("OE1", 0)],
    "GLU": [("OE2", 1), ("OE1", 0), ("OE2", 0)],
    "HIS": [("ND1", 1), ("NE2", 1), ("ND1", 0), ("NE2", 0)],
    "LYS": [("NZ", 1)],
    "MET": [("SD", 0)],
    "SER": [("OG", 1)],
    "THR": [("OG1", 1)],
    "TRP": [("NE1", 0)],
    "TYR": [("OH", 1)],
    "DA": [("N6", 1), ("N1", 0), ("N3", 0), ("N7", 0)],
    "DG": [("N1", 1), ("N2", 1), ("N7", 1), ("O6", 0), ("N1", 0), ("N3", 0), ("N7", 0)],
    "DC": [("N4", 1), ("N3", 1), ("O2", 0), ("N3", 0)],
    "DT": [("N3", 1), ("O2", 0), ("O4", 0)],
    "RA": [("O2'", 1), ("N6", 1), ("N1", 0), ("N3", 0), ("N7", 0)],
    "RG": [("O2'", 1), ("N1", 1), ("N2", 1), ("N7", 1), ("O6", 0), ("N1", 0),
           ("N3", 0), ("N7", 0)],
    "RC": [("O2'", 1), ("N4", 1), ("N3", 1), ("O2", 0), ("N3", 0)],
    "RU": [("O2'", 1), ("N3", 1), ("O2", 0), ("O4", 0)],
    "RX": [("O2'", 1)],
}

# Rear atoms behind each donor/acceptor (reference data/preprocess_dataset.py:707-740).
REAR_ATOMS: Dict[str, Dict[str, List[str]]] = {
    "ARG": {"NH1": ["CZ"], "NH2": ["CZ"]},
    "ASN": {"OD1": ["CG"], "ND2": ["CG"]},
    "ASP": {"OD1": ["CG"], "OD2": ["CG"]},
    "CYS": {"SG": ["CB"]},
    "GLN": {"OE1": ["CD"], "NE2": ["CD"]},
    "GLU": {"OE1": ["CD"], "OE2": ["CD"]},
    "HIS": {"ND1": ["CG", "CE1"], "NE2": ["CD2", "CE1"]},
    "LYS": {"NZ": ["CE"]},
    "MET": {"SD": ["CG", "CE"]},
    "SER": {"OG": ["CB"]},
    "THR": {"OG1": ["CB"]},
    "TRP": {"NE1": ["CD1", "CE2"]},
    "TYR": {"OH": ["CZ"]},
    "DA": {"N6": ["C6"], "N1": ["C2", "C6"], "N3": ["C2", "C4"], "N7": ["C5", "C8"]},
    "DG": {"N1": ["C2", "C6"], "N2": ["C2"], "N7": ["C5", "C8"], "O6": ["C6"],
           "N3": ["C2", "C4"]},
    "DC": {"N4": ["C4"], "N3": ["C2", "C5"], "O2": ["C2"]},
    "DT": {"N3": ["C2", "C4"], "O2": ["C2"], "O4": ["C4"]},
    "RA": {"O2'": ["C2'"], "N6": ["C6"], "N1": ["C2", "C6"], "N3": ["C2", "C4"],
           "N7": ["C5", "C8"]},
    "RG": {"O2'": ["C2'"], "N1": ["C2", "C6"], "N2": ["C2"], "N7": ["C5", "C8"],
           "O6": ["C6"], "N3": ["C2", "C4"]},
    "RC": {"O2'": ["C2'"], "N4": ["C4"], "N3": ["C2", "C5"], "O2": ["C2"]},
    "RU": {"O2'": ["C2'"], "N3": ["C2", "C4"], "O2": ["C2"], "O4": ["C4"]},
    "RX": {"O2'": ["C2'"]},
}

IDEAL_ANGLE = {  # element -> num_rear -> ideal donor/acceptor angle (rad)
    "O": {1: np.deg2rad(109.5), 2: np.deg2rad(180.0)},
    "N": {1: np.deg2rad(120.0), 2: np.deg2rad(180.0)},
    "S": {1: np.deg2rad(109.5), 2: np.deg2rad(180.0)},
    "P": {1: np.deg2rad(120.0), 2: np.deg2rad(180.0)},
}

# Base-frame definitions (reference data/preprocess_dataset.py:762-780).
NUC_TYPES = ["DA", "DG", "DC", "DT", "RA", "RG", "RC", "RU"]
VEC_ATOMS = {
    "DA": {"S_start": "C1'", "S_stop": "N3"},
    "DG": {"S_start": "C1'", "S_stop": "N3"},
    "DC": {"S_start": "C1'", "S_stop": "O2"},
    "DT": {"S_start": "C1'", "S_stop": "O2"},
    "RA": {"S_start": "C1'", "S_stop": "N3"},
    "RG": {"S_start": "C1'", "S_stop": "N3"},
    "RC": {"S_start": "C1'", "S_stop": "O2"},
    "RU": {"S_start": "C1'", "S_stop": "O2"},
}
RING_ATOMS = ["N1", "C2", "N3", "C4", "C6", "C5"]

EPS = 1e-8


@dataclasses.dataclass
class HBParams:
    """Thresholds of the H-bond / base-pair engine (reference
    data/preprocess_dataset.py:159-186)."""
    hbond_da_upper: float = 3.9
    hbond_ha_upper: float = 2.5
    D_ij_limit: float = 20.0
    H_ij_limit: float = 1.5
    P_ij_limit: float = np.pi / 5
    B_ij_limit: float = np.pi / 5
    min_hbonds_for_bp: float = 2.0
    bp_hbond_coeff: float = 8.0
    bp_val_cutoff: float = 0.5


# ---------------------------------------------------------------------------
# NA-MPNN -> RFaa conversion
# ---------------------------------------------------------------------------

def convert_mpnn_representation(S, X, X_m, rna_mask, atom_dict,
                                int_to_restype=None,
                                na_shared_tokens=True):
    """NA-MPNN tokens/coords -> (S_rfaa, X_rfaa[L,36,3]) (reference
    convert_mpnn_representation, data/preprocess_dataset.py:782-870)."""
    if int_to_restype is None:
        int_to_restype = constants.INT_TO_RESTYPE
    idx_to_name = {i: a for a, i in atom_dict.items()}
    L = S.shape[0]

    S_rfaa = np.zeros(L, np.int64)
    for i in range(L):
        restype = int_to_restype[int(S[i])]
        if rna_mask[i]:
            conv = {"DA": "RA", "A": "RA", "DC": "RC", "C": "RC",
                    "DG": "RG", "G": "RG", "DT": "RU", "U": "RU",
                    "DX": "RX", "RX": "RX"}
            if restype not in conv:
                raise ValueError("RNA restype not recognized.")
            restype = conv[restype]
        S_rfaa[i] = RFAA_TYPE_TO_INT[restype]

    X_rfaa = np.zeros((L, NTOTAL, 3), np.float32)
    for i in range(L):
        t = RFAA_TYPES[S_rfaa[i]]
        slots = RFAA_ATOM_SLOT[t]
        for atom_idx in range(X.shape[1]):
            if X_m[i, atom_idx] != 1:
                continue
            name = idx_to_name[atom_idx]
            if t in ("UNK", "DX", "RX") and name not in slots:
                continue
            if t in ("DA", "DC", "DG", "DT") and name == "O2'":
                continue  # mislabeled DNA/RNA hybrid chains
            if name == "OXT":
                continue
            if name in slots:
                X_rfaa[i, slots[name]] = X[i, atom_idx]
    return S_rfaa, X_rfaa


# ---------------------------------------------------------------------------
# H-bond network (vectorized)
# ---------------------------------------------------------------------------

def _site_pair_table():
    """Static per-type-pair table of deduped donor/acceptor atom pairs.

    Reproduces the reference's iteration-order dedup: for each (type_i,
    type_j), iterate site lists in order, keep the FIRST occurrence of each
    (atom_i, atom_j) name pair, and require exactly one donor
    (reference data/preprocess_dataset.py:244-248).
    Entry: dict type-pair -> list of (slot_i, slot_j, rear_slots_i,
    rear_slots_j, donor_i, ideal_angle_i, ideal_angle_j).
    """
    table = {}
    for ti in RFAA_TYPES:
        for tj in RFAA_TYPES:
            pairs = []
            seen = set()
            for (ai, di) in HBOND_ATOMS.get(ti, []):
                for (aj, dj) in HBOND_ATOMS.get(tj, []):
                    key = (ai, aj)
                    # Record a name pair only when it is actually counted:
                    # the reference adds the dict entry inside the same
                    # donor+acceptor branch (data/preprocess_dataset.py:248,334).
                    if di + dj != 1 or key in seen:
                        continue
                    seen.add(key)
                    rear_i = [RFAA_ATOM_SLOT[ti][r] for r in REAR_ATOMS[ti][ai]]
                    rear_j = [RFAA_ATOM_SLOT[tj][r] for r in REAR_ATOMS[tj][aj]]
                    ang_i = IDEAL_ANGLE[ai[0]][len(rear_i)]
                    ang_j = IDEAL_ANGLE[aj[0]][len(rear_j)]
                    pairs.append((RFAA_ATOM_SLOT[ti][ai], RFAA_ATOM_SLOT[tj][aj],
                                  rear_i, rear_j, di, ang_i, ang_j))
            if pairs:
                table[(RFAA_TYPE_TO_INT[ti], RFAA_TYPE_TO_INT[tj])] = pairs
    return table


# NOTE on the dedup: the reference checks `atom_pair not in dict` BEFORE the
# donor+acceptor test never records pairs failing that test, so a later
# occurrence of the same name pair that satisfies donor+acceptor still counts.
_SITE_PAIRS = None


def _get_site_pairs():
    global _SITE_PAIRS
    if _SITE_PAIRS is None:
        _SITE_PAIRS = _site_pair_table()
    return _SITE_PAIRS


def hbond_counts(S_rfaa, X_rfaa, params: HBParams = HBParams()):
    """Pairwise H-bond counts [L,L] via ideal-H placement + distance/angle
    filters (reference _compute_hbnets, data/preprocess_dataset.py:227-338),
    vectorized by grouping candidate residue pairs by type pair."""
    L = S_rfaa.shape[0]
    frame = X_rfaa[:, 1, :]
    D_ij = np.linalg.norm(frame[None] - frame[:, None], axis=-1)
    ii, jj = np.nonzero(np.triu(D_ij <= params.D_ij_limit, k=1))
    counts = np.zeros((L, L), np.float32)
    if ii.size == 0:
        return counts

    site_pairs = _get_site_pairs()
    type_pairs = {}
    for p, (i, j) in enumerate(zip(ii, jj)):
        key = (int(S_rfaa[i]), int(S_rfaa[j]))
        if key in site_pairs:
            type_pairs.setdefault(key, []).append(p)

    for key, plist in type_pairs.items():
        pi = ii[plist]
        pj = jj[plist]
        for (slot_i, slot_j, rear_i, rear_j, donor_i, ang_i, ang_j) in site_pairs[key]:
            xi = X_rfaa[pi, slot_i]                      # [P,3] tip atom i
            xj = X_rfaa[pj, slot_j]                      # [P,3] tip atom j
            a_i_vec = np.mean(
                np.stack([xi - X_rfaa[pi, r] for r in rear_i], 1), axis=1)
            a_j_vec = np.mean(
                np.stack([xj - X_rfaa[pj, r] for r in rear_j], 1), axis=1)
            a_i_vec = a_i_vec / (np.linalg.norm(a_i_vec, axis=-1, keepdims=True) + EPS)
            a_j_vec = a_j_vec / (np.linalg.norm(a_j_vec, axis=-1, keepdims=True) + EPS)

            ideal_angle_h = donor_i * ang_i + (1 - donor_i) * ang_j
            xyz_d = donor_i * xi + (1 - donor_i) * xj
            xyz_a = (1 - donor_i) * xi + donor_i * xj
            rd = donor_i * a_i_vec + (1 - donor_i) * a_j_vec
            rd = rd / (np.linalg.norm(rd, axis=-1, keepdims=True) + EPS)
            da_vec = xyz_a - xyz_d
            da_norm = np.linalg.norm(da_vec, axis=-1)
            da_unit = da_vec / (da_norm[..., None] + EPS)
            # ar vector: reference uses (is_donor_i-1)*a_i + (is_donor_j-1)*a_j
            # with is_donor_j = 1-is_donor_i (data/preprocess_dataset.py:292).
            ar = (donor_i - 1) * a_i_vec + ((1 - donor_i) - 1) * a_j_vec
            ar = ar / (np.linalg.norm(ar, axis=-1, keepdims=True) + EPS)

            norm_vec = np.cross(-rd, da_unit)
            norm_unit = norm_vec / (np.linalg.norm(norm_vec, axis=-1, keepdims=True) + EPS)
            perp = np.cross(norm_unit, -rd)
            perp = perp / (np.linalg.norm(perp, axis=-1, keepdims=True) + EPS)

            dh = np.sin(ideal_angle_h) * perp - np.cos(ideal_angle_h) * rd
            dh = dh / (np.linalg.norm(dh, axis=-1, keepdims=True) + EPS)
            ideal_h = xyz_d + dh
            ha_vec = xyz_a - ideal_h
            ha_norm = np.linalg.norm(ha_vec, axis=-1)

            with np.errstate(invalid="ignore"):
                t_rda = np.arccos(np.sum(-rd * da_unit, axis=-1))
                t_dar = np.arccos(np.sum(-da_unit * ar, axis=-1))

            ok = ((ha_norm <= params.hbond_ha_upper)
                  & (da_norm <= params.hbond_da_upper)
                  & (t_rda >= 5 * np.pi / 9)
                  & (t_dar >= 5 * np.pi / 9)).astype(np.float32)
            np.add.at(counts, (pi, pj), ok)
            np.add.at(counts, (pj, pi), ok)
    return counts


# ---------------------------------------------------------------------------
# Base frames + pairwise base parameters + paired bases
# ---------------------------------------------------------------------------

def base_pair_probabilities(S_rfaa, X_rfaa, params: HBParams = HBParams()):
    """[L,L] base-pair probabilities = sigmoid(8*(hbonds-1)) x geometry
    filters (reference _compute_local_base_params / _compute_pairwise_base_params
    / _compute_paired_bases, data/preprocess_dataset.py:340-481)."""
    return _base_pair_geometry(S_rfaa, X_rfaa, params)["bp"]


def _base_pair_geometry(S_rfaa, X_rfaa, params: HBParams = HBParams()):
    """Base frames + pairwise frames + the [L,L] base-pair probability
    matrix; the NA-block intermediates (X_ij/Y_ij, frame centers) feed
    helical_params."""
    L = S_rfaa.shape[0]
    is_dna = (S_rfaa >= RFAA_TYPE_TO_INT["DA"]) & (S_rfaa <= RFAA_TYPE_TO_INT["DT"])
    is_rna = (S_rfaa >= RFAA_TYPE_TO_INT["RA"]) & (S_rfaa <= RFAA_TYPE_TO_INT["RU"])
    is_na = is_dna | is_rna
    n_na = int(is_na.sum())
    empty = {"bp": np.zeros((L, L), np.float32), "is_na": is_na,
             "n_na": n_na, "X_ij": None, "Y_ij": None, "frame_na": None}
    if n_na == 0:
        return empty

    counts = hbond_counts(S_rfaa, X_rfaa, params)
    bp_preds = 1.0 / (1.0 + np.exp(-params.bp_hbond_coeff
                                   * (counts - (params.min_hbonds_for_bp - 1))))

    frame = X_rfaa[:, 1, :]
    D_ij_vec = frame[None] - frame[:, None]
    padded = np.concatenate([frame[:1], frame, frame[-1:]], 0)
    M_i = ((padded[1:-1] - padded[:-2]) + (padded[2:] - padded[1:-1])) / 2

    xyz_na = X_rfaa[is_na]
    seq_na = S_rfaa[is_na]

    ring = np.stack([
        xyz_na[k, [RFAA_ATOM_SLOT[RFAA_TYPES[t]][a] for a in RING_ATOMS]]
        for k, t in enumerate(seq_na)
    ])                                                    # [n,6,3]
    centers = ring.mean(1)
    centered = ring - centers[:, None]
    cov = np.einsum("bij,bik->bjk", centered, centered) / (ring.shape[1] - 1)
    _, eigvecs = np.linalg.eigh(cov)
    N_i = eigvecs[:, :, 0]
    N_i = N_i / np.linalg.norm(N_i, axis=1, keepdims=True)
    # Orient base normals along the backbone 5'->3' direction.
    Z_i = N_i * np.sum(M_i[is_na] * N_i, axis=-1, keepdims=True)
    Z_i = Z_i / (np.linalg.norm(Z_i, axis=-1, keepdims=True) + EPS)

    # Sugar-edge vectors -> in-plane frame.
    edge_X = np.stack([
        xyz_na[k, RFAA_ATOM_SLOT[RFAA_TYPES[t]][VEC_ATOMS[RFAA_TYPES[t]]["S_stop"]]]
        - xyz_na[k, RFAA_ATOM_SLOT[RFAA_TYPES[t]][VEC_ATOMS[RFAA_TYPES[t]]["S_start"]]]
        for k, t in enumerate(seq_na)
    ])
    edge_X = edge_X / (np.linalg.norm(edge_X, axis=-1, keepdims=True) + EPS)
    X_i = np.cross(Z_i, edge_X)
    X_i = X_i / (np.linalg.norm(X_i, axis=-1, keepdims=True) + EPS)

    # NOTE: the reference indexes D_ij_vec with the 0..n_na-1 square block
    # rather than the NA rows (data/preprocess_dataset.py:398) — reproduced
    # verbatim so the produced labels are identical.
    D_ij_vec_na = D_ij_vec[:n_na, :n_na]
    base_D_ij_vec = centers[None] - centers[:, None]

    Z_sum = 0.5 * (Z_i[:, None] + Z_i[None])
    Z_diff = 0.5 * (Z_i[:, None] - Z_i[None])
    antiparallel = (np.linalg.norm(Z_diff, axis=-1)
                    > np.linalg.norm(Z_sum, axis=-1))
    Z_ij = np.where(antiparallel[..., None], Z_diff, Z_sum)
    Z_ij = Z_ij / (np.linalg.norm(Z_ij, axis=-1, keepdims=True) + EPS)

    Y_ij = D_ij_vec_na / (np.linalg.norm(D_ij_vec_na, axis=-1, keepdims=True) + EPS)
    X_ij = np.cross(Z_ij, Y_ij)
    X_ij = X_ij / (np.linalg.norm(X_ij, axis=-1, keepdims=True) + EPS)

    H_ij = np.sum(base_D_ij_vec * Z_ij, axis=-1)

    def proj_angle(v_i, Adir, Bdir, negate_j):
        proj = (np.sum(v_i[:, None, :] * Adir, -1, keepdims=True) * Adir
                + np.sum(v_i[:, None, :] * Bdir, -1, keepdims=True) * Bdir)
        proj = proj / (np.linalg.norm(proj, axis=-1, keepdims=True) + EPS)
        other = -np.swapaxes(proj, 0, 1) if negate_j else np.swapaxes(proj, 0, 1)
        cosang = np.sum(proj * other, axis=-1)
        return cosang

    with np.errstate(invalid="ignore"):
        cos_buckle = np.clip(proj_angle(Z_i, Y_ij, Z_ij, True), -1.0, 1.0)
        B_ij = np.arccos(cos_buckle)
        P_ij = np.arccos(proj_angle(Z_i, Z_ij, X_ij, True))

    H_f = (H_ij >= -params.H_ij_limit) & (H_ij <= params.H_ij_limit)
    B_f = (B_ij <= (np.pi - params.B_ij_limit)) | (B_ij >= params.B_ij_limit)
    P_f = (P_ij <= (np.pi - params.P_ij_limit)) | (P_ij >= params.P_ij_limit)

    geom = np.zeros((L, L), bool)
    geom[np.outer(is_na, is_na)] = (H_f & B_f & P_f).reshape(-1)
    both_na = np.outer(is_na, is_na)
    return {"bp": (both_na * geom * bp_preds).astype(np.float32),
            "is_na": is_na, "n_na": n_na, "X_ij": X_ij, "Y_ij": Y_ij,
            "frame_na": frame[is_na]}


HELICAL_PARAM_NAMES = (
    "tilt", "roll", "twist", "shift", "slide", "rise",
    "inclination", "tip", "helical_twist", "x_disp", "y_disp",
    "helical_rise")


def helical_params(S_rfaa, X_rfaa, params: HBParams = HBParams()):
    """Per-NA-residue doublet-step and local helical parameters, averaged
    over base-paired partner combinations (reference _compute_helical_params,
    data/preprocess_dataset.py:483-631 — gated off by default and marked
    in-progress there; exact same combination-enumeration semantics,
    including the doublet-membership initialization of the averaging
    denominator and consecutive NA-block doublets across chain breaks).

    Returns {name: [n_na] float32} for the 12 parameters in
    HELICAL_PARAM_NAMES. arcsin/arccos arguments are not clamped (matching
    the reference), so NaNs are possible for degenerate geometry.
    """
    g = _base_pair_geometry(S_rfaa, X_rfaa, params)
    n_na = g["n_na"]
    out = {k: np.zeros(n_na, np.float32) for k in HELICAL_PARAM_NAMES}
    if n_na < 2:
        return out
    bp, is_na = g["bp"], g["is_na"]
    X_ij, Y_ij, frame = g["X_ij"], g["Y_ij"], g["frame_na"]
    na_inds = np.where(is_na)[0]
    block_of = {int(gi): k for k, gi in enumerate(na_inds)}
    # NA-block partner lists (ascending, like the reference's row-major
    # nonzero scan).
    partners = [
        [block_of[int(j)] for j in np.where(bp[gi] >= params.bp_val_cutoff)[0]]
        for gi in na_inds
    ]

    # Averaging denominator starts at each residue's doublet-membership
    # count and grows by 1 per (j_1, j_2) combination it participates in.
    avg = np.full(n_na, 2.0, np.float64)
    avg[0] = avg[-1] = 1.0

    combos = [(i1, i1 + 1, j1, j2)
              for i1 in range(n_na - 1)
              for j1 in partners[i1]
              for j2 in partners[i1 + 1]]
    if not combos:
        return out
    I1, I2, J1, J2 = (np.array(c) for c in zip(*combos))
    np.add.at(avg, I1, 1.0)
    np.add.at(avg, I2, 1.0)

    X_1, X_2 = X_ij[I1, J1], X_ij[I2, J2]
    Y_1, Y_2 = Y_ij[I1, J1], Y_ij[I2, J2]
    Xp, Xn = X_2 + X_1, X_2 - X_1
    Yp, Yn = Y_2 + Y_1, Y_2 - Y_1
    M_12 = 0.5 * ((frame[I2] + frame[J2]) - (frame[I1] + frame[J1]))

    def norm(v):
        return np.linalg.norm(v, axis=-1)

    # Zm/Zh carry the reference's sin(angle) magnitude (cross divided by the
    # product of the operand norms, not by its own norm).
    Zm = np.cross(Xp, Yp) / (norm(Xp) * norm(Yp) + EPS)[..., None]
    Zh = np.cross(Xn, Yn) / (norm(Xn) * norm(Yn) + EPS)[..., None]

    def dot(a, b):
        return np.sum(a * b, axis=-1)

    with np.errstate(invalid="ignore"):
        vals = {
            "tilt": -np.arcsin(dot(Zm, X_1)),
            "roll": np.arcsin(dot(Zm, Y_1)),
            "twist": np.arccos(dot(np.cross(X_1, Zm), np.cross(X_2, Zm))),
            "shift": dot(M_12, Xp / (norm(Xp) + EPS)[..., None]),
            "slide": dot(M_12, Yp / (norm(Yp) + EPS)[..., None]),
            "rise": dot(M_12, Zm),
            "inclination": np.arcsin(dot(Zh, X_1)),
            "tip": -np.arcsin(dot(Zh, Y_1)),
            "helical_twist": -np.arccos(dot(np.cross(X_1, Zh),
                                            np.cross(X_2, Zh))),
            "x_disp": dot(M_12, Xn / (norm(Xn) + EPS)[..., None]),
            "y_disp": dot(M_12, Yn / (norm(Yn) + EPS)[..., None]),
            "helical_rise": -dot(M_12, Zh),
        }
    for k, v in vals.items():
        acc = np.zeros(n_na, np.float64)
        np.add.at(acc, I1, v)
        np.add.at(acc, I2, v)
        out[k] = (acc / (avg + EPS)).astype(np.float32)
    return out


def get_base_pair_mask_and_index(S, X, X_m, rna_mask, atom_dict=None,
                                 canonical_pair_ints=None,
                                 na_shared_tokens=True):
    """Base-pair and canonical-base-pair masks/partner indices (reference
    get_base_pair_mask_and_index, data/preprocess_dataset.py:872-950)."""
    if atom_dict is None:
        atom_dict = dict(constants.ATOM_DICT)
    if canonical_pair_ints is None:
        canonical_pair_ints = constants.canonical_base_pair_ints(na_shared_tokens)
    S_rfaa, X_rfaa = convert_mpnn_representation(S, X, X_m, rna_mask, atom_dict,
                                                 na_shared_tokens=na_shared_tokens)
    L = S_rfaa.shape[0]
    is_na = ((S_rfaa >= RFAA_TYPE_TO_INT["DA"]) & (S_rfaa <= RFAA_TYPE_TO_INT["DT"])) | \
            ((S_rfaa >= RFAA_TYPE_TO_INT["RA"]) & (S_rfaa <= RFAA_TYPE_TO_INT["RU"]))
    if is_na.sum() > 0:
        probs = base_pair_probabilities(S_rfaa, X_rfaa)
        binary = (probs > 0.5).astype(np.int32)
        base_pair_mask = (binary.sum(-1) == 1).astype(np.int32)
        base_pair_index = np.argmax(binary, axis=-1).astype(np.int64)
    else:
        base_pair_mask = np.zeros(L, np.int32)
        base_pair_index = np.zeros(L, np.int64)

    base_pair_mask = base_pair_mask * base_pair_mask[base_pair_index]
    base_pair_index = base_pair_index * base_pair_mask

    canonical_mask = base_pair_mask.copy()
    canonical_index = base_pair_index.copy()
    pair_set = set(canonical_pair_ints)
    for i in range(L):
        if base_pair_mask[i] == 1:
            if (int(S[i]), int(S[base_pair_index[i]])) not in pair_set:
                canonical_mask[i] = 0
                canonical_mask[base_pair_index[i]] = 0
    canonical_index = canonical_index * canonical_mask
    return base_pair_mask, base_pair_index, canonical_mask, canonical_index


# ---------------------------------------------------------------------------
# Interface masks
# ---------------------------------------------------------------------------

def get_interface_masks(X, X_m, protein_mask, dna_mask, rna_mask, atom_dict=None,
                        na_ref_atom="C1'", num_neighbors=32,
                        cutoff=INTERFACE_DISTANCE_CUTOFF):
    """Protein-NA interface masks + nearest-protein-side-chain index
    (reference get_interface_masks, data/preprocess_dataset.py:953-1017)."""
    if atom_dict is None:
        atom_dict = dict(constants.ATOM_DICT)
    L, N = X.shape[0], X.shape[1]
    na_mask = dna_mask + rna_mask
    ref_X = X[:, atom_dict["CA"], :] + X[:, atom_dict[na_ref_atom], :]

    # Side-chain atoms: not in any backbone list (empty for the 16-atom frame).
    bb = (set(constants.PROTEIN_BACKBONE_ATOMS) | set(constants.DNA_BACKBONE_ATOMS)
          | set(constants.RNA_BACKBONE_ATOMS))
    side_chain = np.zeros(N, np.int32)
    for a, i in atom_dict.items():
        if a not in bb:
            side_chain[i] = 1
    sc_pair = side_chain[:, None] * side_chain[None, :]

    interface_mask = np.zeros(L, np.int32)
    side_chain_interface_mask = np.zeros(L, np.int32)
    nearest_protein_sc_index = np.zeros(L, np.int64)

    k = min(num_neighbors, L)
    eps = 1e-6
    for i in range(L):
        mask = na_mask if protein_mask[i] == 1 else protein_mask
        D = mask * np.sqrt(np.sum((ref_X - ref_X[i]) ** 2, axis=1) + eps)
        D_adjust = D + (1.0 - mask) * (D.max() + eps)
        neighbors = np.argsort(D_adjust, kind="stable")[:k]

        best_dist = None
        for j in neighbors:
            if not (na_mask[i] == 1 or na_mask[j] == 1):
                continue
            dX = X[i][:, None, :] - X[j][None, :, :]
            dist = np.sqrt(np.sum(dX ** 2, axis=-1))
            pair_m = X_m[i][:, None] * X_m[j][None, :]
            valid = pair_m == 1
            if valid.any():
                if dist[valid].min() < cutoff:
                    if (protein_mask[i] == 1 and na_mask[j] == 1) or \
                       (protein_mask[j] == 1 and na_mask[i] == 1):
                        interface_mask[i] = 1
                        interface_mask[j] = 1
            sc_valid = (pair_m * sc_pair) == 1
            if sc_valid.any():
                min_sc = dist[sc_valid].min()
                if min_sc < cutoff:
                    if (protein_mask[i] == 1 and na_mask[j] == 1) or \
                       (protein_mask[j] == 1 and na_mask[i] == 1):
                        side_chain_interface_mask[i] = 1
                        side_chain_interface_mask[j] = 1
                    if protein_mask[j] == 1 and (best_dist is None or min_sc < best_dist):
                        nearest_protein_sc_index[i] = j
                        best_dist = min_sc
    return interface_mask, side_chain_interface_mask, nearest_protein_sc_index
