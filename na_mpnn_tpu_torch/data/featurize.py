"""Inference-side featurisation and scoring helpers (port of the JAX
package's ``data/featurize.py``)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

_BATCH_KEYS = ("S", "mask", "protein_mask", "dna_mask", "rna_mask",
               "rna_mask_for_token_conversion", "R_polymer_type", "X", "X_m",
               "xyz_65", "xyz_65_m")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device that is missing is an error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    return device


def renumber_duplicate_resnums(R_idx: np.ndarray) -> np.ndarray:
    """Offset duplicated consecutive residue numbers so R_idx is usable as a
    relative-position signal."""
    out = []
    count = 0
    prev = -100000
    for r in list(np.asarray(R_idx)):
        if prev == r:
            count += 1
        out.append(int(r) + count)
        prev = r
    return np.array(out, dtype=np.asarray(R_idx).dtype)


def featurize_inference(parsed: Dict, chain_mask: np.ndarray, pad_to: int = 0,
                        device="cuda", as_numpy: bool = False) -> Dict:
    """Parsed structure -> model batch of ``[1, ...]`` tensors on ``device``
    (with ``as_numpy``: host-side numpy arrays, for callers that stack many
    structures before one copy to the device).

    ``pad_to > L`` pads every per-residue array to that length with inert
    rows (mask 0, a fresh chain label, strictly increasing R_idx); padded
    rows never enter the kNN graph or a score, and callers truncate outputs
    back to L."""
    L = len(parsed["S"])
    pad = max(int(pad_to) - L, 0)

    def padded(a, fill=0):
        a = np.asarray(a)
        if pad == 0:
            return a
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths, constant_values=fill)

    R_idx = renumber_duplicate_resnums(parsed["R_idx"])
    if pad:
        tail = R_idx[-1] + 1 + np.arange(pad, dtype=R_idx.dtype)
        R_idx = np.concatenate([R_idx, tail])
    chain_labels = np.asarray(parsed["chain_labels"])
    chain_labels = padded(chain_labels,
                          fill=int(chain_labels.max()) + 1 if pad else 0)

    arrays = {"R_idx": R_idx, "R_idx_original": padded(parsed["R_idx"]),
              "chain_labels": chain_labels}
    for k in _BATCH_KEYS:
        arrays[k] = padded(parsed[k])
    arrays["chain_mask"] = padded(chain_mask)
    batch = {k: np.ascontiguousarray(a)[None] for k, a in arrays.items()}
    if as_numpy:
        return batch
    device = resolve_device(device)
    return {k: torch.from_numpy(a).to(device) for k, a in batch.items()}


def get_seq_rec(S_true, S_pred, mask):
    """Masked sequence recovery per decode sample."""
    match = (S_true == S_pred).to(mask.dtype)
    return (match * mask).sum(-1) / mask.sum(-1)


def get_score(S, log_probs, mask, num_letters):
    """Masked categorical cross-entropy -> (average, per residue)."""
    S_one_hot = F.one_hot(S.long(), num_letters).to(log_probs.dtype)
    loss_per_residue = -(S_one_hot * log_probs).sum(-1)
    average = (loss_per_residue * mask).sum(-1) / (mask.sum(-1) + 1e-8)
    return average, loss_per_residue


def make_pair_bias_ctx(chain_labels: np.ndarray, R_idx: np.ndarray,
                       pair_bias_AA: np.ndarray, device="cuda",
                       as_numpy: bool = False) -> Dict:
    """Adjacency diagonal for the neighbour pair bias: ``u_diag[i] = 1`` iff
    residues i, i+1 are sequence-consecutive on the same chain (with
    ``as_numpy``: numpy arrays on the host)."""
    R_idx = np.asarray(R_idx)
    chain_labels = np.asarray(chain_labels)
    adj = ((R_idx[1:] - R_idx[:-1]) == 1) & (chain_labels[1:] == chain_labels[:-1])
    ctx = {"pair_bias_AA": np.asarray(pair_bias_AA, np.float32),
           "u_diag": adj.astype(np.float32)}
    if as_numpy:
        return ctx
    device = resolve_device(device)
    return {k: torch.as_tensor(v, device=device) for k, v in ctx.items()}
