"""Vocabulary / token tables of NA-MPNN (the port's own copy).

The same 33-token vocabulary, 6 polymer types, 16-atom backbone frame and
virtual-atom weights as ``na_mpnn_tpu/constants.py``, kept here so that the
PyTorch package imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Residue types (33-token vocabulary)
# ---------------------------------------------------------------------------

PROTEIN_RESTYPES = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "UNK",
]
DNA_RESTYPES = ["DA", "DC", "DG", "DT", "DX"]
RNA_RESTYPES = ["A", "C", "G", "U", "RX"]
UNKNOWN_RESTYPES = ["UNK", "DX", "RX"]

RESTYPES = PROTEIN_RESTYPES + DNA_RESTYPES + RNA_RESTYPES + ["MAS", "PAD"]

NUM_LETTERS = len(RESTYPES)  # 33
VOCAB_SIZE = NUM_LETTERS

RESTYPE_TO_INT = {r: i for i, r in enumerate(RESTYPES)}
INT_TO_RESTYPE = {i: r for i, r in enumerate(RESTYPES)}

RESTYPE_3_TO_1 = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q",
    "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K",
    "MET": "M", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRP": "W",
    "TYR": "Y", "VAL": "V", "UNK": "X",
    # single-letter FASTA alphabet for nucleic acids (reference README.md:80-113)
    "DA": "a", "DC": "c", "DG": "g", "DT": "t", "DX": "x",
    "A": "b", "C": "d", "G": "h", "U": "u", "RX": "y",
    "MAS": "-", "PAD": "+",
}
RESTYPE_1_TO_3 = {v: k for k, v in RESTYPE_3_TO_1.items()}

# One-character alphabet indexed by token int.
ALPHABET = [RESTYPE_3_TO_1[INT_TO_RESTYPE[i]] for i in range(NUM_LETTERS)]


def restype_to_int_table(na_shared_tokens: bool = True) -> dict:
    """Residue-name -> token-int mapping.

    With ``na_shared_tokens`` the RNA letters collapse onto the DNA ints
    (A->DA, C->DC, G->DG, U->DT, RX->DX), which is how both released models
    were trained (reference inference/run.py:113-117).
    """
    table = dict(RESTYPE_TO_INT)
    if na_shared_tokens:
        table["A"] = table["DA"]
        table["C"] = table["DC"]
        table["G"] = table["DG"]
        table["U"] = table["DT"]
        table["RX"] = table["DX"]
    return table


# Mapping from DNA single-letter chars to RNA chars, used when emitting
# sequences for residues known (via O2' presence) to be RNA while the model
# uses shared tokens (reference inference/run.py:119-123).
DNA_CHAR_TO_RNA_CHAR = {
    RESTYPE_3_TO_1["DA"]: RESTYPE_3_TO_1["A"],
    RESTYPE_3_TO_1["DC"]: RESTYPE_3_TO_1["C"],
    RESTYPE_3_TO_1["DG"]: RESTYPE_3_TO_1["G"],
    RESTYPE_3_TO_1["DT"]: RESTYPE_3_TO_1["U"],
    RESTYPE_3_TO_1["DX"]: RESTYPE_3_TO_1["RX"],
}

# ---------------------------------------------------------------------------
# Polymer types
# ---------------------------------------------------------------------------

POLYTYPES = ["PP", "DNA", "RNA", "UNK", "MAS", "PAD"]
POLYTYPE_TO_INT = {p: i for i, p in enumerate(POLYTYPES)}
NUM_POLYTYPES = len(POLYTYPES)

# ---------------------------------------------------------------------------
# Atom frames
# ---------------------------------------------------------------------------

# 16-atom backbone frame: 4 protein + 12 nucleic-acid backbone atoms.
BACKBONE_ATOMS = [
    "N", "CA", "C", "O",
    "OP1", "OP2", "P", "O5'", "C5'", "C4'", "O4'", "C3'", "O3'", "C2'", "O2'", "C1'",
]
ATOM_DICT = {a: i for i, a in enumerate(BACKBONE_ATOMS)}
NUM_BACKBONE_ATOMS = len(BACKBONE_ATOMS)  # 16

# All-atom (65) frame used by the inference parser for side-chain aware work.
ALL_ATOMS = [
    # protein heavy atoms
    "N", "CA", "C", "CB", "O", "CG", "CG1", "CG2", "OG", "OG1", "SG", "CD",
    "CD1", "CD2", "ND1", "ND2", "OD1", "OD2", "SD", "CE", "CE1", "CE2", "CE3",
    "NE", "NE1", "NE2", "OE1", "OE2", "CH2", "NH1", "NH2", "OH", "CZ", "CZ2",
    "CZ3", "NZ", "OXT",
    # nucleic acid atoms
    "OP1", "OP2", "P", "O5'", "C5'", "C4'", "O4'", "C3'", "O3'", "C2'", "O2'",
    "C1'", "N9", "C8", "C7", "N7", "C6", "N6", "O6", "C5", "C4", "N4", "O4",
    "N3", "C2", "N2", "O2", "N1",
]
ALL_ATOM_ORDER = {a: i for i, a in enumerate(ALL_ATOMS)}
NUM_ALL_ATOMS = len(ALL_ATOMS)  # 65

PROTEIN_BACKBONE_ATOMS = ["N", "CA", "C", "O"]
DNA_BACKBONE_ATOMS = ["OP1", "OP2", "P", "O5'", "C5'", "C4'", "O4'", "C3'", "O3'", "C2'", "C1'"]
RNA_BACKBONE_ATOMS = ["OP1", "OP2", "P", "O5'", "C5'", "C4'", "O4'", "C3'", "O3'", "C2'", "O2'", "C1'"]

PROTEIN_BB_IDX = [ATOM_DICT[a] for a in PROTEIN_BACKBONE_ATOMS]
DNA_BB_IDX = [ATOM_DICT[a] for a in DNA_BACKBONE_ATOMS]
RNA_BB_IDX = [ATOM_DICT[a] for a in RNA_BACKBONE_ATOMS]

# Virtual-atom construction weights (reference na_model_utils.py:476,484):
# Cb placed from (N, CA, C); pseudo base-N placed from (O4', C1', C2').
CB_WEIGHTS = (-0.58273431, 0.56802827, -0.54067466)
NA_N_WEIGHTS = (-0.56967352, 0.51055973, -0.53122153)

# ---------------------------------------------------------------------------
# Canonical base pairs
# ---------------------------------------------------------------------------

NA_CANONICAL_BASE_PAIR_RESTYPES = [
    ("DA", "DT"), ("DA", "U"), ("DC", "DG"), ("DC", "G"),
    ("DG", "DC"), ("DG", "C"), ("DT", "DA"), ("DT", "A"),
    ("A", "DT"), ("A", "U"), ("C", "DG"), ("C", "G"),
    ("G", "DC"), ("G", "C"), ("U", "DA"), ("U", "A"),
]


def canonical_base_pair_ints(na_shared_tokens: bool = True) -> list:
    table = restype_to_int_table(na_shared_tokens)
    return [(table[a], table[b]) for a, b in NA_CANONICAL_BASE_PAIR_RESTYPES]


def restype_group_ints(na_shared_tokens: bool = True):
    """(protein_ints, dna_ints, rna_ints, unknown_ints) under the token table."""
    table = restype_to_int_table(na_shared_tokens)
    return (
        [table[r] for r in PROTEIN_RESTYPES],
        [table[r] for r in DNA_RESTYPES],
        [table[r] for r in RNA_RESTYPES],
        [table[r] for r in UNKNOWN_RESTYPES],
    )


def polymer_restype_mask_array(restype_ints, num_letters: int = NUM_LETTERS) -> np.ndarray:
    m = np.zeros([num_letters], dtype=np.float32)
    m[np.asarray(restype_ints)] = 1.0
    return m


# Tokens that never receive loss: UNK / DX / RX / MAS / PAD
# (reference na_run.py:131-136).
def tokens_with_no_loss(na_shared_tokens: bool = True) -> np.ndarray:
    table = restype_to_int_table(na_shared_tokens)
    return np.asarray(
        [table["UNK"], table["DX"], table["RX"], table["MAS"], table["PAD"]],
        dtype=np.int32,
    )


# Chemical element symbols (index 1-based; 0 = unknown), for ligand context
# atoms (reference inference/data_utils.py:100-102).
ELEMENT_LIST = [
    "H", "HE", "LI", "BE", "B", "C", "N", "O", "F", "NE", "NA", "MG", "AL",
    "SI", "P", "S", "CL", "AR", "K", "CA", "SC", "TI", "V", "CR", "MN", "FE",
    "CO", "NI", "CU", "ZN", "GA", "GE", "AS", "SE", "BR", "KR", "RB", "SR",
    "Y", "ZR", "NB", "MB", "TC", "RU", "RH", "PD", "AG", "CD", "IN", "SN",
    "SB", "TE", "I", "XE", "CS", "BA", "LA", "CE", "PR", "ND", "PM", "SM",
    "EU", "GD", "TB", "DY", "HO", "ER", "TM", "YB", "LU", "HF", "TA", "W",
    "RE", "OS", "IR", "PT", "AU", "HG", "TL", "PB", "BI", "PO", "AT", "RN",
    "FR", "RA", "AC", "TH", "PA", "U", "NP", "PU", "AM", "CM", "BK", "CF",
    "ES", "FM", "MD", "NO", "LR", "RF", "DB", "SG", "BH", "HS", "MT", "DS",
    "RG", "CN", "UUT", "FL", "UUP", "LV", "UUS", "UUO",
]
ELEMENT_DICT = {e: i for i, e in enumerate(ELEMENT_LIST, start=1)}
