"""LigandMPNN's operations and bytes, counted from shapes as ``costs.py``
counts NA-MPNN's: unpadded residues only, node-level products once per
node, a message sum ``sum_k w_k (W3 g_k + b3)`` as ``W3 (sum_k w_k g_k)``,
every input byte read once and every output byte written once.

Per residue the context encoder holds ``M = ATOM_CONTEXT_NUM`` (25) atoms
and ``M^2`` (625) atom pairs. Its layers (``model.context``): ``W_c`` on
the residue, ``W_v`` and ``W_nodes_y`` on each atom, ``W_edges_y`` on each
pair; per round a ``DecLayerJ`` over the pairs (per pair the edge half of
``W1`` and ``W2``, 4 H^2, and 30 H elementwise; per atom the self half of
``W1``, ``W3``, the 4H FFN and two LayerNorms, 20 H^2 + 20 H) and a
``DecLayer`` from the atoms into the residue (per atom 6 H^2 + 30 H over
the 2H-wide edge; per residue 20 H^2 + 20 H); ``V_C`` and its LayerNorm.
The context features (``features.context``): per atom five RBFs, the
element one-hots through ``type_linear`` (147 -> 64), ``node_project_down``
(148 -> H) and ``y_nodes`` (147 -> H); per pair a distance, 16 bins,
``y_edges`` (16 -> H) and a LayerNorm.
"""
from __future__ import annotations

from . import costs


def _dims(cfg):
    return cfg["HIDDEN_DIM"], cfg["ATOM_CONTEXT_NUM"], cfg["NUM_CONTEXT_LAYERS"]


def context_layers_ops(tokens, cfg):
    """Forward operations of the context layers over ``tokens`` residues."""
    H, M, rounds = _dims(cfg)
    R = M * M
    per_round = (R * (4 * H * H + 30 * H) + M * (20 * H * H + 20 * H)
                 + M * (6 * H * H + 30 * H) + 20 * H * H + 20 * H)
    fixed = R * 2 * H * H + M * 4 * H * H + 2 * H * H + 2 * H * H + 10 * H
    return tokens * (rounds * per_round + fixed)


def context_layers_bytes(tokens, cfg, dtype):
    """Bytes of the context layers' forward over ``tokens`` residues: the
    pairs' edges, the atoms' two node tables and the residue's state in,
    the residue's fp32 state out, the weights."""
    H, M, rounds = _dims(cfg)
    e = costs.ESIZE[dtype]
    inputs = e * tokens * (M * M * H + 2 * M * H + H)
    out = 4 * tokens * H
    weights = e * (rounds * (2 * (3 * H * H + 4 * H * H + 2 * 4 * H * H) + H * H)
                   + 5 * H * H)
    return inputs + out + weights


def context_layers_seconds(tokens, cfg):
    """The least time of the context layers' forward over ``tokens``
    residues, at the trunk's precision."""
    dt = "bf16" if cfg["MIXED_PRECISION"] else "fp32"
    return costs.least_seconds(context_layers_ops(tokens, cfg),
                               context_layers_bytes(tokens, cfg, dt), dt)


def context_features_ops(tokens, cfg):
    """Forward operations of the context features over ``tokens`` residues."""
    H, M, _ = _dims(cfg)
    bins = cfg["NUM_RBF"]
    per_atom = (5 * (9 + 6 * bins) + 2 * 147 * 64 + 2 * 148 * H + 2 * 147 * H
                + 2 * 10 * H + 60)
    per_pair = 9 + 6 * bins + 2 * bins * H + 10 * H
    return tokens * (M * per_atom + M * M * per_pair)


def train_flops(tokens, cfg):
    """Model operations of one LigandMPNN training step over ``tokens``
    unpadded residues: the trunk (ProteinMPNN's 25 atom pairs an edge, 21
    letters), the context features and layers; the forward and a backward
    of twice its work."""
    K, H = cfg["NUM_NEIGHBORS"], cfg["HIDDEN_DIM"]
    trunk = (costs.features_flops(tokens, K, H, 25)
             + costs.encoder_flops(tokens, K, H, cfg["NUM_ENCODER_LAYERS"])
             + costs.decoder_flops(tokens, K, H, cfg["NUM_DECODER_LAYERS"],
                                   letters=cfg["NUM_LETTERS"]))
    return 3 * (trunk + context_features_ops(tokens, cfg) + context_layers_ops(tokens, cfg))
