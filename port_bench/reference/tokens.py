"""Vocabulary, polymer types and the atom frame of NA-MPNN (the published
model's tables, NA-MPNN ``README.md`` and ``inference/data_utils.py``)."""
from __future__ import annotations

PROTEIN = ["ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS",
           "ILE", "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP",
           "TYR", "VAL", "UNK"]
DNA = ["DA", "DC", "DG", "DT", "DX"]
RNA = ["A", "C", "G", "U", "RX"]
TOKENS = PROTEIN + DNA + RNA + ["MAS", "PAD"]          # 33 letters
TOKEN = {r: i for i, r in enumerate(TOKENS)}
NUM_LETTERS = len(TOKENS)
ONE_LETTER = "ARNDCQEGHILKMFPSTWYVX" + "acgtx" + "bdhuy" + "-+"

# Both released models share the nucleic-acid tokens: RNA letters take the
# DNA ints (README: --na_shared_tokens 1).
SHARED = dict(TOKEN, A=TOKEN["DA"], C=TOKEN["DC"], G=TOKEN["DG"],
              U=TOKEN["DT"], RX=TOKEN["DX"])
NO_LOSS = [SHARED[r] for r in ("UNK", "DX", "RX", "MAS", "PAD")]
# letters a sampler never draws
NEVER_SAMPLED = [TOKEN[r] for r in ("UNK", "DX", "RX", "MAS", "PAD")]

POLYTYPES = ["PP", "DNA", "RNA", "UNK", "MAS", "PAD"]

ATOMS = ["N", "CA", "C", "O", "OP1", "OP2", "P", "O5'", "C5'", "C4'", "O4'",
         "C3'", "O3'", "C2'", "O2'", "C1'"]
SLOT = {a: i for i, a in enumerate(ATOMS)}
PROTEIN_BACKBONE = ["N", "CA", "C", "O"]
DNA_BACKBONE = ["OP1", "OP2", "P", "O5'", "C5'", "C4'", "O4'", "C3'", "O3'",
                "C2'", "C1'"]
RNA_BACKBONE = DNA_BACKBONE[:10] + ["O2'", "C1'"]

# virtual atoms: Cb from (N, CA, C), the base N from (O4', C1', C2')
CB_WEIGHTS = (-0.58273431, 0.56802827, -0.54067466)
NA_N_WEIGHTS = (-0.56967352, 0.51055973, -0.53122153)


def group_ints():
    """Token ints of the protein, DNA and RNA letters under shared tokens."""
    return ([SHARED[r] for r in PROTEIN], [SHARED[r] for r in DNA],
            [SHARED[r] for r in RNA])
