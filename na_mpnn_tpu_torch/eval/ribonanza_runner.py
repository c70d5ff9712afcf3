"""First-party RibonanzaNet runner.

The port's own copy of the JAX package's ``eval/ribonanza_runner.py``.
Equivalent of the reference's shipped runner (reference
evaluation/run_ribonanza_net.py:1-233, itself adapted from the public Kaggle
inference notebooks): loads a site-installed RibonanzaNet, predicts either a
chemical-reactivity profile or a base-pair probability matrix, and — for the
secondary-structure mode — extracts a dot-bracket string with a Hungarian
assignment over the pair probabilities (the reference imports arnie's
`_hungarian`; here the assignment + helix filtering + pseudoknot-layered
bracket emission are implemented natively on scipy, so the extraction stage
has no external dependency and is unit-testable without the model).

Site configuration (the model itself is an external artifact, like every
evaluation binary — SURVEY.md §2.2):
    RIBONANZA_NET_DIR      directory containing Network.py + configs/
    RIBONANZA_NET_WEIGHTS  weights for the reactivity model (RibonanzaNet.pt)
    RIBONANZA_NET_SS_WEIGHTS  weights for the 2D model (RibonanzaNet-SS.pt)

CLI (same contract as the reference runner):
    python -m na_mpnn_tpu_torch.eval.ribonanza_runner <mode> <sequence> <outdir> <batch>
writes <outdir>/output.npy with the result dict.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Tuple

import numpy as np

RNA_RESTYPE_TO_INT = {"A": 0, "C": 1, "G": 2, "U": 3}

# Bracket alphabets per pseudoknot layer (dot-bracket convention used by the
# scoring side, eval/scoring.py base_pairs_and_loops).
_OPEN = "([{<ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_CLOSE = ")]}>abcdefghijklmnopqrstuvwxyz"


# ---------------------------------------------------------------------------
# Native Hungarian secondary-structure extraction
# ---------------------------------------------------------------------------

def mask_diagonal(matrix: np.ndarray, width: int = 4,
                  mask_value: float = 0.0) -> np.ndarray:
    """Zero the |i-j| < width band (reference run_ribonanza_net.py's
    mask_diagonal, vectorized)."""
    matrix = np.array(matrix, copy=True)
    n = matrix.shape[0]
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    matrix[np.abs(i - j) < width] = mask_value
    return matrix


def hungarian_base_pairs(prob: np.ndarray, theta: float = 0.5,
                         min_len_helix: int = 1) -> List[Tuple[int, int]]:
    """Base pairs from a (symmetric) pair-probability matrix via an optimal
    assignment: maximize total paired probability, keep mutual assignments
    with prob >= theta, then drop helices shorter than min_len_helix."""
    from scipy.optimize import linear_sum_assignment

    prob = np.asarray(prob, np.float64)
    n = prob.shape[0]
    # Allow "unpaired" by giving the diagonal a neutral cost of 0.
    cost = -np.array(prob, copy=True)
    np.fill_diagonal(cost, 0.0)
    rows, cols = linear_sum_assignment(cost)
    a = np.empty(n, np.int64)
    a[rows] = cols
    pairs = set()
    for i in range(n):
        j = int(a[i])
        if j != i and int(a[j]) == i and i < j and prob[i, j] >= theta:
            pairs.add((i, j))

    # Helix filtering: consecutive stacked pairs (i,j),(i+1,j-1) form a helix.
    pairs = sorted(pairs)
    helices: List[List[Tuple[int, int]]] = []
    for p in pairs:
        if helices and (p[0] - 1, p[1] + 1) == helices[-1][-1]:
            helices[-1].append(p)
        else:
            helices.append([p])
    kept = [p for h in helices if len(h) >= min_len_helix for p in h]
    return kept


def pairs_to_dot_bracket(pairs: List[Tuple[int, int]], n: int) -> str:
    """Dot-bracket emission with pseudoknot layers: each pair takes the
    lowest bracket level whose existing pairs it does not cross."""
    layers: List[List[Tuple[int, int]]] = []
    assignment = {}
    for (i, j) in sorted(pairs):
        placed = False
        for lvl, layer in enumerate(layers):
            if not any((a < i < b < j) or (i < a < j < b) for a, b in layer):
                layer.append((i, j))
                assignment[(i, j)] = lvl
                placed = True
                break
        if not placed:
            layers.append([(i, j)])
            assignment[(i, j)] = len(layers) - 1
    out = ["."] * n
    for (i, j), lvl in assignment.items():
        out[i] = _OPEN[lvl]
        out[j] = _CLOSE[lvl]
    return "".join(out)


def extract_secondary_structure(prob: np.ndarray, theta: float = 0.5,
                                min_len_helix: int = 1):
    """(dot_bracket, pairs, pair_matrix) from a pair-probability matrix —
    the native replacement for arnie's `_hungarian` stage."""
    masked = mask_diagonal(prob)
    pairs = hungarian_base_pairs(masked, theta=theta,
                                 min_len_helix=min_len_helix)
    n = prob.shape[0]
    ss = pairs_to_dot_bracket(pairs, n)
    mat = np.zeros((n, n))
    for i, j in pairs:
        mat[i, j] = 1.0
    mat = mat + mat.T
    return ss, pairs, mat


# ---------------------------------------------------------------------------
# Model loading (site install) + prediction
# ---------------------------------------------------------------------------

def _sequence_tensor(sequence: str):
    import torch
    for c in sequence:
        if c not in RNA_RESTYPE_TO_INT:
            raise ValueError(f"Invalid RNA sequence: {sequence}")
    return torch.tensor([RNA_RESTYPE_TO_INT[c] for c in sequence]).unsqueeze(0)


def load_model(mode: str):
    """Load the site-installed RibonanzaNet (reference
    run_ribonanza_net.py:199-225)."""
    import torch
    import yaml

    net_dir = os.environ.get("RIBONANZA_NET_DIR")
    if not net_dir or not os.path.isdir(net_dir):
        raise RuntimeError("RIBONANZA_NET_DIR not configured")
    sys.path.insert(0, net_dir)
    from Network import RibonanzaNet  # site module

    class _Config:
        def __init__(self, **entries):
            self.__dict__.update(entries)
            self.entries = entries

    with open(os.path.join(net_dir, "configs", "pairwise.yaml")) as f:
        config = _Config(**yaml.safe_load(f))

    if mode == "reactivity_profile":
        model = RibonanzaNet(config)
        weights = os.environ.get("RIBONANZA_NET_WEIGHTS")
    elif mode == "secondary_structure":
        class FinetunedRibonanzaNet(RibonanzaNet):
            def __init__(self, cfg):
                cfg.dropout = 0.3
                super().__init__(cfg)
                self.dropout = torch.nn.Dropout(0.0)
                self.ct_predictor = torch.nn.Linear(64, 1)

            def forward(self, src):
                _, pairwise = self.get_embeddings(
                    src, torch.ones_like(src).long().to(src.device))
                pairwise = pairwise + pairwise.permute(0, 2, 1, 3)
                return self.ct_predictor(self.dropout(pairwise)).squeeze(-1)

        model = FinetunedRibonanzaNet(config)
        weights = os.environ.get("RIBONANZA_NET_SS_WEIGHTS")
    else:
        raise ValueError(f"Invalid mode: {mode}")
    if not weights or not os.path.exists(weights):
        raise RuntimeError(f"RibonanzaNet weights for {mode} not configured")
    model.load_state_dict(torch.load(weights, map_location="cpu"))
    model.eval()
    return model


def predict_reactivity_profile(sequence: str, model, batch_size: int = 1) -> Dict:
    # The model is deterministic in eval mode (the reference's own loop,
    # run_ribonanza_net.py:119-131, produces batch_size identical samples);
    # compute once and replicate to keep the same output contract.
    import torch
    seq = _sequence_tensor(sequence)
    with torch.no_grad():
        out = model(seq, torch.ones_like(seq)).numpy()
    p2a3 = [out[0, :, 0].tolist()] * batch_size
    pdms = [out[0, :, 1].tolist()] * batch_size
    return {"predicted_2A3_reactivity_profiles": p2a3,
            "predicted_DMS_reactivity_profiles": pdms}


def predict_secondary_structure(sequence: str, model, batch_size: int = 1,
                                theta: float = 0.5,
                                min_len_helix: int = 1) -> Dict:
    # Deterministic in eval mode (the 2D head wraps Dropout(0.0), mirroring
    # the reference run_ribonanza_net.py:78-90,170-181): one inference +
    # one Hungarian extraction, replicated to keep the output contract.
    import torch
    seq = _sequence_tensor(sequence)
    with torch.no_grad():
        logits = model(seq).sigmoid().numpy()[0]
    ss, pairs, mat = extract_secondary_structure(
        logits, theta=theta, min_len_helix=min_len_helix)
    return {"predicted_secondary_structures": [ss] * batch_size,
            "predicted_base_pairs": [pairs] * batch_size,
            "predicted_base_pair_matrix": [mat] * batch_size}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    mode, sequence, output_directory, batch_size = (
        argv[0], argv[1], argv[2], int(argv[3]))
    model = load_model(mode)
    if mode == "reactivity_profile":
        result = predict_reactivity_profile(sequence, model, batch_size)
    else:
        result = predict_secondary_structure(sequence, model, batch_size)
    os.makedirs(output_directory, exist_ok=True)
    np.save(os.path.join(output_directory, "output.npy"),
            np.asarray(result, dtype=object), allow_pickle=True)


if __name__ == "__main__":
    main()
