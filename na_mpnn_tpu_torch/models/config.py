"""Model configuration: the same fields and defaults as the JAX package's
``models/config.py::ModelConfig``, with PyTorch kernel choices."""
from __future__ import annotations

import dataclasses

from .. import constants

KERNEL_CHOICES = ("auto", "cuda", "torch")
RBF_MODES = ("classed", "dense")


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
    def edge_in(self) -> int:
        return self.num_positional_embeddings + self.num_rbf * self.total_atoms ** 2

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
