"""Model configuration: the same fields and defaults as the JAX package's
``models/config.py::ModelConfig``, with PyTorch kernel choices."""
from __future__ import annotations

import dataclasses

from .. import constants

KERNEL_CHOICES = ("auto", "cuda", "torch")
RBF_MODES = ("classed", "dense")


@dataclasses.dataclass(frozen=True)
class Architecture:
    """What the shared code reads of a model type: ``letters``, the default
    vocabulary and output width; ``edge_pairs``, the atom pairs of an edge's
    RBF block (0: every pair of the atom frame); ``omit``, the letters no
    sampler draws; ``pad_token``, the letter of a training batch's padded
    rows; ``loss``, ``"polymer"`` (``losses.loss_smoothed``: smoothing per
    polymer, PPM labels) or ``"uniform"`` (ProteinMPNN's,
    ``losses.loss_smoothed_uniform``); ``atom_context``, an atom-context
    encoder after the protein encoder (``models/ligand.py``)."""
    letters: int
    edge_pairs: int
    omit: tuple
    pad_token: int
    loss: str
    atom_context: bool


# LigandMPNN's 21 letters (ProteinMPNN's), X for any other residue
LIGAND_ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"
_X = LIGAND_ALPHABET.index("X")
ARCHITECTURES = {
    "na_mpnn": Architecture(
        letters=constants.NUM_LETTERS, edge_pairs=0,
        omit=tuple(constants.RESTYPE_TO_INT[r] for r in ("UNK", "DX", "RX", "MAS", "PAD")),
        pad_token=constants.RESTYPE_TO_INT["PAD"], loss="polymer", atom_context=False),
    # ProteinMPNN's 25 backbone pairs (N, CA, C, O, virtual CB)
    "ligand_mpnn": Architecture(
        letters=len(LIGAND_ALPHABET), edge_pairs=25, omit=(_X,),
        pad_token=_X, loss="uniform", atom_context=True),
}
MODEL_TYPES = tuple(ARCHITECTURES)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of the NA-MPNN network (defaults: the released models).

    ``kernels``: ``auto`` launches the CUDA kernel for CUDA tensors and uses
    the plain PyTorch version for CPU tensors; ``cuda`` requires CUDA tensors;
    ``torch`` always takes the plain versions (for comparisons only).
    """
    node_features: int = 128
    edge_features: int = 128
    hidden_dim: int = 128
    num_encoder_layers: int = 3
    num_decoder_layers: int = 3
    k_neighbors: int = 32
    vocab: int = constants.VOCAB_SIZE          # 33
    num_letters: int = constants.NUM_LETTERS   # 33
    num_rbf: int = 16
    num_positional_embeddings: int = 16
    max_relative_feature: int = 32
    dropout: float = 0.1
    protein_augment_eps: float = 0.0
    dna_augment_eps: float = 0.0
    rna_augment_eps: float = 0.0
    decode_protein_first: bool = False
    na_ref_atom: str = "C1'"
    include_pred_na_N: bool = True
    atom_table: str = "backbone"
    num_polytypes: int = constants.NUM_POLYTYPES  # 6
    compute_dtype: str = "float32"
    kernels: str = "auto"
    rbf_mode: str = "classed"
    gp_knn_key_chunk: int = 0
    gp_rbf_row_chunk: int = 0
    remat: str = "none"
    model_type: str = "na_mpnn"     # a key of ARCHITECTURES
    atom_context_num: int = 25      # LigandMPNN's context atoms a residue

    def __post_init__(self):
        if self.kernels not in KERNEL_CHOICES:
            raise ValueError(f"kernels={self.kernels!r}: choose from "
                             f"{KERNEL_CHOICES}")

    @property
    def atom_dict(self):
        return (constants.ATOM_DICT if self.atom_table == "backbone"
                else constants.ALL_ATOM_ORDER)

    @property
    def total_atoms(self) -> int:
        return len(self.atom_dict) + 1 + (1 if self.include_pred_na_N else 0)

    @property
    def arch(self) -> Architecture:
        return ARCHITECTURES[self.model_type]

    @property
    def edge_in(self) -> int:
        pairs = self.arch.edge_pairs or self.total_atoms ** 2
        return self.num_positional_embeddings + self.num_rbf * pairs

    @property
    def node_in(self) -> int:
        return self.num_polytypes

    @property
    def na_ref_atom_idx(self) -> int:
        return self.atom_dict[self.na_ref_atom]


COMPUTE_DTYPES = ("float32", "bfloat16")


def check_supported(cfg: ModelConfig):
    """Raise for a value outside the choices the JAX package runs. Every
    option of the JAX ``ModelConfig`` is ported: ``remat`` (any value but
    ``"none"`` rematerialises the training layers' tails, ``models/mpnn.py``),
    the graph-parallel chunks (``parallel/graph_parallel.py``) and both atom
    tables with or without the virtual base N (``models/features.py``; as in
    JAX, any ``atom_table`` but ``"backbone"`` is the 65-atom table)."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: choose from "
                         f"{COMPUTE_DTYPES}")
    if cfg.rbf_mode not in RBF_MODES:
        raise ValueError(f"rbf_mode={cfg.rbf_mode!r}: choose from {RBF_MODES}")
    if cfg.model_type not in MODEL_TYPES:
        raise ValueError(f"model_type={cfg.model_type!r}: choose from {MODEL_TYPES}")
    if cfg.arch.atom_context and (cfg.atom_table != "backbone" or not cfg.include_pred_na_N):
        raise ValueError("ligand_mpnn runs on the 18-slot frame: atom_table "
                         "'backbone' with include_pred_na_N")


def ligand_config(**kw) -> ModelConfig:
    """A LigandMPNN configuration (``ligandmpnn_v_32_010_25`` widths: 21
    letters, 25 context atoms; ``kw`` overrides)."""
    letters = ARCHITECTURES["ligand_mpnn"].letters
    return ModelConfig(**{"model_type": "ligand_mpnn", "vocab": letters,
                          "num_letters": letters, **kw})
