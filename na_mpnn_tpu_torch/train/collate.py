"""Host-side batch collation: pad per-structure dicts to [B, L_pad, ...]
(the port's numpy copy of the JAX package's ``train/collate.py``).

L is padded up to a bucket size instead of the exact batch max, as the JAX
package does, so that every batch of a bucket has one shape.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import constants

# Default buckets cover the training distribution (BATCH_TOKENS=6000 cap,
# reference design_model.json:21).
DEFAULT_LENGTH_BUCKETS = (64, 128, 256, 384, 512, 768, 1024, 1536, 2048,
                          3072, 4096, 6144)


def bucket_length(L: int, buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS) -> int:
    for b in buckets:
        if L <= b:
            return b
    return int(L)


# Batch-dimension buckets: token packing yields a different structure count
# per batch, and every distinct (B, L) pair is a separate XLA executable —
# bucketing B as well bounds compile count to ~one program per L bucket
# (padded rows are PAD-masked and carry no loss).
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def bucket_batch(B: int, buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS) -> int:
    for b in buckets:
        if B <= b:
            return b
    return int(B)


def collate_batch(structures: List[Dict], pad_to: Optional[int] = None,
                  pad_batch_to: Optional[int] = None,
                  use_buckets: bool = True,
                  pad_token: Optional[int] = None) -> Optional[Dict[str, np.ndarray]]:
    """Pad a list of per-structure dicts into dense [B, L_pad, ...] arrays.

    Each structure dict must carry the loader contract keys (reference
    na_data_utils.load_assembly / load_preprocessed_data): X, X_m, S, R_idx,
    chain_labels, protein/dna/rna masks, R_polymer_type, interface_mask,
    base_pair_{mask,index}, canonical_base_pair_{mask,index}, aligned_ppm,
    ppm_mask. Returns None for an empty list (the reference returns "pass").

    Structures that carry context atoms (``Y [N,3]``, ``Y_t``, ``Y_m [N]``:
    LigandMPNN's inputs) give ``Y [B, N_max, 3]``, ``Y_t``, ``Y_m [B,
    N_max]``, absent atoms zero. ``pad_token`` fills ``S`` of padded rows
    (default NA-MPNN's PAD; LigandMPNN's 21 letters take its X).
    """
    structures = [s for s in structures if isinstance(s, dict)]
    B = len(structures)
    if B == 0:
        return None
    L_max = max(int(s["S"].shape[0]) for s in structures)
    L_pad = pad_to if pad_to is not None else (
        bucket_length(L_max) if use_buckets else L_max)
    B_pad = pad_batch_to if pad_batch_to is not None else B

    # Atom-table width follows the dataset (16-atom backbone or 65-atom
    # "all" table, reference na_run.py:34-41 via ATOMS_TO_LOAD).
    nA = int(structures[0]["X"].shape[1])
    nl = constants.NUM_LETTERS
    pt_pad = constants.POLYTYPE_TO_INT["PAD"]
    rt_pad = constants.RESTYPE_TO_INT["PAD"] if pad_token is None else pad_token

    out = {
        "X": np.zeros([B_pad, L_pad, nA, 3], np.float32),
        "X_m": np.zeros([B_pad, L_pad, nA], np.int32),
        "mask": np.zeros([B_pad, L_pad], np.int32),
        "S": np.full([B_pad, L_pad], rt_pad, np.int64),
        "R_idx": np.full([B_pad, L_pad], -100, np.int32),
        "chain_labels": np.full([B_pad, L_pad], -1, np.int64),
        "protein_mask": np.zeros([B_pad, L_pad], np.int32),
        "dna_mask": np.zeros([B_pad, L_pad], np.int32),
        "rna_mask": np.zeros([B_pad, L_pad], np.int32),
        "R_polymer_type": np.full([B_pad, L_pad], pt_pad, np.int64),
        "interface_mask": np.zeros([B_pad, L_pad], np.int32),
        "base_pair_mask": np.zeros([B_pad, L_pad], np.int32),
        "base_pair_index": np.zeros([B_pad, L_pad], np.int64),
        "canonical_base_pair_mask": np.zeros([B_pad, L_pad], np.int32),
        "canonical_base_pair_index": np.zeros([B_pad, L_pad], np.int64),
        "aligned_ppm": np.zeros([B_pad, L_pad, nl], np.float64),
        "ppm_mask": np.zeros([B_pad, L_pad], np.int32),
    }
    structure_paths, assembly_ids = [], []
    optional = {"interface_mask", "base_pair_mask", "base_pair_index",
                "canonical_base_pair_mask", "canonical_base_pair_index",
                "aligned_ppm", "ppm_mask"}
    for i, s in enumerate(structures):
        L = int(s["S"].shape[0])
        for k in out:
            if k in s:
                out[k][i, :L] = s[k]
            elif k == "mask":
                out["mask"][i, :L] = 1
            elif k not in optional:
                raise KeyError(f"structure missing required key {k}")
        structure_paths.append(s.get("structure_path", ""))
        assembly_ids.append(s.get("assembly_id", ""))
    if "Y" in structures[0]:
        N = max(int(np.shape(s["Y"])[0]) for s in structures)
        out["Y"] = np.zeros([B_pad, N, 3], np.float32)
        out["Y_t"] = np.zeros([B_pad, N], np.int32)
        out["Y_m"] = np.zeros([B_pad, N], np.int32)
        for i, s in enumerate(structures):
            n = int(np.shape(s["Y"])[0])
            for k in ("Y", "Y_t", "Y_m"):
                out[k][i, :n] = s[k]
    out["structure_path"] = structure_paths
    out["assembly_id"] = assembly_ids
    return out


# Padding fill per key (the values collate_batch writes into padded rows);
# used when a collated batch must be re-padded to a longer L after the fact
# (multi-host per-host feed: hosts collate their local slices independently
# and then agree on the global L bucket).
_PAD_FILL = {"S": constants.RESTYPE_TO_INT["PAD"], "R_idx": -100,
             "chain_labels": -1,
             "R_polymer_type": constants.POLYTYPE_TO_INT["PAD"]}


def repad_length(batch: Dict, L_new: int) -> Dict:
    """Pad every [B, L, ...] array of a collated batch out to L_new along
    axis 1, using the same fill values collate_batch uses. No-op if the
    batch is already at L_new."""
    L = int(batch["S"].shape[1])
    if L == L_new:
        return batch
    assert L_new > L, (L, L_new)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray) or v.ndim < 2 or v.shape[1] != L:
            out[k] = v
            continue
        pad = [(0, 0), (0, L_new - L)] + [(0, 0)] * (v.ndim - 2)
        out[k] = np.pad(v, pad, constant_values=_PAD_FILL.get(k, 0))
    return out
