"""Evaluation scoring math: sequences, secondary structure, PPMs, structures.

The port's own copy of the JAX package's ``eval/scoring.py`` (the same
numpy code, so the same results on the same inputs). A pure-Python/numpy port of the reference harness's scoring layer (reference
evaluation/na_eval_utils.py): RNA sequence validity/standardization
(:440-524), dot-bracket base-pair/loop extraction and F1 (:1490-1636),
sequence recovery (:1417-1485), PPM alignment with per-type scores
(:1841-2265), PPM MAE/RMSE/cross-entropy (:2267-2348), and specificity
scoring (:3469-3651). Structure comparison (RMSD/lDDT/GDT) lives in
eval/superimpose.py.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .. import constants
from ..data.dataset import (load_ppms, ppm_alignment_score,
                            ppm_information_content)

# ---------------------------------------------------------------------------
# Constants (reference NAConstants, evaluation/na_eval_utils.py:296-438)
# ---------------------------------------------------------------------------

RNA_RESTYPES = ["A", "C", "G", "U"]
RNA_UNKNOWN = "X"
CHAIN_BREAK = "/"
DSSR_UNKNOWN = "?"
DSSR_CHAIN_BREAK = "&"
DSSR_MODIFIED = [r.lower() for r in RNA_RESTYPES]
NA_MPNN_RNA_TO_RNA = {"b": "A", "d": "C", "h": "G", "u": "U", "y": "X"}

PAIR_SYMBOLS = [("(", ")"), ("[", "]"), ("{", "}"), ("<", ">")] + [
    (chr(ord("A") + i), chr(ord("a") + i)) for i in range(26)
]
OPEN_SYMBOLS = [p[0] for p in PAIR_SYMBOLS]
CLOSE_SYMBOLS = [p[1] for p in PAIR_SYMBOLS]
LOOP_SYMBOLS = [".", ","]
OPEN_TO_CLOSE = {o: c for o, c in PAIR_SYMBOLS}
CLOSE_TO_OPEN = {c: o for o, c in PAIR_SYMBOLS}

MIN_OVERLAP_LENGTH = 5


# ---------------------------------------------------------------------------
# Sequence validity / standardization
# ---------------------------------------------------------------------------

def check_rna_sequence_validity(sequence: str, unknown_residue_allowed: bool,
                                chain_breaks_allowed: bool):
    for c in sequence:
        if c in RNA_RESTYPES:
            continue
        if unknown_residue_allowed and c == RNA_UNKNOWN:
            continue
        if chain_breaks_allowed and c == CHAIN_BREAK:
            continue
        raise ValueError(f"Invalid character in sequence: {c}")


def standardize_rna_sequence(sequence: str, method=None,
                             remove_chain_breaks=False) -> str:
    out = []
    for c in sequence:
        if method == "na_mpnn" and c in NA_MPNN_RNA_TO_RNA:
            out.append(NA_MPNN_RNA_TO_RNA[c])
        elif method == "dssr" and c == DSSR_UNKNOWN:
            out.append(RNA_UNKNOWN)
        elif method == "dssr" and c == DSSR_CHAIN_BREAK:
            out.append(CHAIN_BREAK)
        elif method == "dssr" and c in DSSR_MODIFIED:
            out.append(RNA_UNKNOWN)
        else:
            out.append(c)
    if remove_chain_breaks:
        out = [c for c in out if c != CHAIN_BREAK]
    seq = "".join(out)
    check_rna_sequence_validity(seq, True, True)
    return seq


def standardize_secondary_structure(ss: str, method=None,
                                    replace_unknown_restypes=False,
                                    remove_chain_breaks=False) -> str:
    out = []
    for c in ss:
        if method == "dssr" and replace_unknown_restypes and c == DSSR_UNKNOWN:
            out.append(LOOP_SYMBOLS[0])
        elif method == "dssr" and remove_chain_breaks and c == DSSR_CHAIN_BREAK:
            continue
        else:
            out.append(c)
    ss = "".join(out)
    base_pairs_and_loops(ss)  # validity check
    return ss


# ---------------------------------------------------------------------------
# Sequence recovery
# ---------------------------------------------------------------------------

def calculate_sequence_recovery(reference_sequence: str, subject_sequence: str,
                                chain_breaks_allowed=False,
                                unknown_residue_allowed_in_reference=False) -> Dict:
    if len(subject_sequence) != len(reference_sequence):
        raise ValueError(
            f"Length of subject sequence ({len(subject_sequence)}) must match "
            f"length of reference sequence ({len(reference_sequence)}).")
    check_rna_sequence_validity(subject_sequence, False, chain_breaks_allowed)
    check_rna_sequence_validity(reference_sequence,
                                unknown_residue_allowed_in_reference,
                                chain_breaks_allowed)
    num_correct = num_residues = 0
    for s, r in zip(subject_sequence, reference_sequence):
        if unknown_residue_allowed_in_reference and r == RNA_UNKNOWN:
            continue
        if chain_breaks_allowed and (s == CHAIN_BREAK or r == CHAIN_BREAK):
            if not (s == CHAIN_BREAK and r == CHAIN_BREAK):
                raise ValueError(
                    "Chain breaks must occur at the same position in both sequences.")
            continue
        num_residues += 1
        num_correct += int(s == r)
    if num_residues == 0:
        raise ValueError("Number of residues must be greater than 0.")
    return {"sequence_recovery": num_correct / num_residues}


# ---------------------------------------------------------------------------
# Secondary structure
# ---------------------------------------------------------------------------

def base_pairs_and_loops(ss: str) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Dot-bracket (incl. pseudoknot alphabets) -> (pair index tuples, loop
    indices); also validates the string (reference
    calculate_base_pairs_and_loops_from_secondary_structure)."""
    for c in ss:
        if c not in OPEN_TO_CLOSE and c not in CLOSE_TO_OPEN and c not in LOOP_SYMBOLS:
            raise ValueError(f"Invalid character in secondary structure: {c}")
    n_open = sum(c in OPEN_TO_CLOSE for c in ss)
    n_close = sum(c in CLOSE_TO_OPEN for c in ss)
    if n_open != n_close:
        raise ValueError(
            f"Number of open ({n_open}) and close ({n_close}) symbols must be equal.")
    pairs, loops = [], []
    stacks = {o: [] for o in OPEN_SYMBOLS}
    for i, c in enumerate(ss):
        if c in OPEN_TO_CLOSE:
            stacks[c].append(i)
        elif c in CLOSE_TO_OPEN:
            o = CLOSE_TO_OPEN[c]
            if not stacks[o]:
                raise ValueError(f"No matching open symbol for close symbol at index {i}.")
            pairs.append((stacks[o].pop(), i))
        else:
            loops.append(i)
    for o, idxs in stacks.items():
        if idxs:
            raise ValueError(
                f"No matching close symbol ({OPEN_TO_CLOSE[o]}) for open symbol "
                f"({o}) at indices {idxs}.")
    return pairs, loops


def _f1(tp, fp, fn):
    precision = tp / (tp + fp) if tp + fp else 0
    recall = tp / (tp + fn) if tp + fn else 0
    return 2 * precision * recall / (precision + recall) if precision + recall else 0


def calculate_secondary_structure_stats(reference_ss: str, subject_ss: str) -> Dict:
    if len(subject_ss) != len(reference_ss):
        raise ValueError(
            f"Length of subject secondary structure ({len(subject_ss)}) must "
            f"match length of reference secondary structure ({len(reference_ss)}).")
    sp, sl = base_pairs_and_loops(subject_ss)
    rp, rl = base_pairs_and_loops(reference_ss)
    sp, sl, rp, rl = set(sp), set(sl), set(rp), set(rl)
    return {
        "f1_score_pairs": _f1(len(sp & rp), len(sp - rp), len(rp - sp)),
        "f1_score_loops": _f1(len(sl & rl), len(sl - rl), len(rl - sl)),
    }


def crossed_pair_quality_inputs(ss: str):
    """Crossed (pseudoknotted) pairs of a structure: pairs (i,j),(k,l) with
    i<k<j<l. Used by the OpenKnot-style reactivity scoring."""
    pairs, _ = base_pairs_and_loops(ss)
    crossed = set()
    for a in pairs:
        for b in pairs:
            if a[0] < b[0] < a[1] < b[1]:
                crossed.add(a)
                crossed.add(b)
    return pairs, crossed


def calculate_reactivity_profile_score(reference_ss: str,
                                       reactivity: np.ndarray,
                                       threshold: float = 0.5) -> Dict:
    """Eterna-classic-style + crossed-pair quality scores from a reactivity
    profile (reference calculate_reactivity_profile_score,
    evaluation/na_eval_utils.py:1638-1700; the reference defers to the
    external OpenKnotScorePipeline, unavailable here — this is a
    self-contained implementation of the published scoring rules: paired
    positions should be unreactive, loops reactive; crossed pairs weighted
    separately; openknot = mean of the two, scaled to [0,1])."""
    reactivity = np.asarray(reactivity, np.float64)
    if len(reactivity) != len(reference_ss):
        raise ValueError(
            f"Length of subject reactivity profile ({len(reactivity)}) must match "
            f"length of reference secondary structure ({len(reference_ss)}).")
    pairs, loops = base_pairs_and_loops(reference_ss)
    paired_idx = sorted({i for p in pairs for i in p})
    correct = 0
    total = 0
    for i in paired_idx:
        total += 1
        correct += int(reactivity[i] < threshold)
    for i in loops:
        total += 1
        correct += int(reactivity[i] >= threshold)
    eterna = 100.0 * correct / max(total, 1)

    _, crossed = crossed_pair_quality_inputs(reference_ss)
    crossed_idx = sorted({i for p in crossed for i in p})
    if crossed_idx:
        cq = 100.0 * float(np.mean(reactivity[crossed_idx] < threshold))
    else:
        cq = 100.0
    return {
        "eternafold_class_score": eterna,
        "crossed_pair_quality_score": cq,
        "openknot_score": (0.5 * eterna + 0.5 * cq) / 100,
    }


# ---------------------------------------------------------------------------
# PPM alignment (eval variant with per-type best scores)
# ---------------------------------------------------------------------------

def weighted_align(ppm, S_one_hot_na, S_non_x_mask,
                   min_overlap_length=MIN_OVERLAP_LENGTH):
    """Exhaustive gapless alignment maximizing IC-weighted Pearson score
    (reference evaluation/na_eval_utils.py:2005-2073; same algorithm as the
    training-side NADataset.weighted_align)."""
    max_score = -np.inf
    opt = ([0], [0], [0])
    ppm_len, S_len = ppm.shape[0], S_one_hot_na.shape[0]
    for ppm_start in range(ppm_len):
        for overlap_len in range(ppm_len - ppm_start + 1):
            for S_start in range(S_len - overlap_len + 1):
                sm = S_non_x_mask[S_start:S_start + overlap_len]
                if overlap_len < min_overlap_length or \
                        np.count_nonzero(sm) < min_overlap_length:
                    continue
                pc = ppm[ppm_start:ppm_start + overlap_len][sm]
                sc = S_one_hot_na[S_start:S_start + overlap_len][sm]
                score = ppm_alignment_score(pc, sc)
                if score > max_score:
                    max_score = score
                    opt = ([ppm_start], [S_start], [overlap_len])
                elif score == max_score:
                    opt[0].append(ppm_start)
                    opt[1].append(S_start)
                    opt[2].append(overlap_len)
    return max_score, opt[0], opt[1], opt[2]


def align_ppms(ppms, S, chain_labels, protein_mask, dna_mask, rna_mask,
               restype_to_int=None):
    """Eval-side PPM alignment that also reports the per-polymer-type best
    alignment score and overlap length (reference
    evaluation/na_eval_utils.py:2075-2265)."""
    if restype_to_int is None:
        restype_to_int = constants.restype_to_int_table(True)
    L = S.shape[0]
    nl = constants.NUM_LETTERS
    aligned_ppm = np.zeros((L, nl), np.float64)
    ppm_mask = np.zeros_like(S, np.int32)
    S_one_hot = np.zeros((L, nl), np.float64)
    S_one_hot[np.arange(L), S] = 1

    t = restype_to_int
    score_by_type = {"dna": np.nan, "rna": np.nan}
    length_by_type = {"dna": 0, "rna": 0}
    for ppm, ppm_type in ppms:
        na_cols = ([t["DA"], t["DC"], t["DG"], t["DT"]] if ppm_type == "dna"
                   else [t["A"], t["C"], t["G"], t["U"]])
        S_oh_na = S_one_hot[:, na_cols]
        S_non_x = S_oh_na.sum(-1) > 0

        max_score, opt_p, opt_s, opt_o = -np.inf, [], [], []
        for cl in np.unique(chain_labels):
            idx = np.where(chain_labels == cl)[0]
            start = idx[0]
            if protein_mask[start] == 1:
                continue
            if dna_mask[start] == 1 and ppm_type == "rna":
                continue
            if rna_mask[start] == 1 and ppm_type == "dna":
                continue
            sc, ps, ss_, os_ = weighted_align(ppm, S_oh_na[idx], S_non_x[idx])
            ss_ = [s + start for s in ss_]
            if sc > max_score:
                max_score, opt_p, opt_s, opt_o = sc, list(ps), list(ss_), list(os_)
            elif sc == max_score:
                opt_p.extend(ps)
                opt_s.extend(ss_)
                opt_o.extend(os_)

        if max_score > -np.inf:
            if np.isnan(score_by_type[ppm_type]) or max_score > score_by_type[ppm_type]:
                score_by_type[ppm_type] = max_score
                length_by_type[ppm_type] = max(opt_o) if opt_o else 0
            for p0, s0, olap in zip(opt_p, opt_s, opt_o):
                for j in range(olap):
                    pi, si = p0 + j, s0 + j
                    if ppm_mask[si] == 0:
                        aligned_ppm[si, na_cols] = ppm[pi]
                        ppm_mask[si] = 1
                    else:
                        if S_non_x[si]:
                            new = ppm_alignment_score(ppm[pi][None], S_oh_na[si][None])
                            old = ppm_alignment_score(
                                aligned_ppm[si, na_cols][None], S_oh_na[si][None])
                            if new > old:
                                aligned_ppm[si, na_cols] = ppm[pi]
                        else:
                            new = ppm_information_content(ppm[pi][None])
                            old = ppm_information_content(aligned_ppm[si, na_cols][None])
                            if new > old:
                                aligned_ppm[si, na_cols] = ppm[pi]
    return (aligned_ppm, ppm_mask, score_by_type["dna"], length_by_type["dna"],
            score_by_type["rna"], length_by_type["rna"])


# ---------------------------------------------------------------------------
# PPM metrics
# ---------------------------------------------------------------------------

def calculate_ppm_mean_absolute_error(reference_ppm, subject_ppm) -> Dict:
    if subject_ppm.shape != reference_ppm.shape:
        raise ValueError(
            f"The subject PPM shape ({subject_ppm.shape}) must match the "
            f"reference PPM shape ({reference_ppm.shape}).")
    L = subject_ppm.shape[0]
    return {"mean_absolute_error": (1 / L) * np.sum(np.abs(subject_ppm - reference_ppm))}


def calculate_ppm_root_mean_squared_error(reference_ppm, subject_ppm) -> Dict:
    if subject_ppm.shape != reference_ppm.shape:
        raise ValueError(
            f"The subject PPM shape ({subject_ppm.shape}) must match the "
            f"reference PPM shape ({reference_ppm.shape}).")
    L = subject_ppm.shape[0]
    return {"root_mean_squared_error":
            np.sqrt((1 / L) * np.sum((subject_ppm - reference_ppm) ** 2))}


def calculate_ppm_cross_entropy(reference_ppm, subject_ppm) -> Dict:
    if subject_ppm.shape != reference_ppm.shape:
        raise ValueError(
            f"The subject PPM shape ({subject_ppm.shape}) must match the "
            f"reference PPM shape ({reference_ppm.shape}).")
    L = subject_ppm.shape[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        ce = -(1 / L) * np.sum(reference_ppm * np.log(subject_ppm))
    return {"cross_entropy": ce}


def calculate_ppm_pearson(reference_ppm, subject_ppm) -> Dict:
    """Overall Pearson correlation between PPMs (the specificity headline
    metric in BASELINE.json)."""
    a = np.asarray(reference_ppm, np.float64).reshape(-1)
    b = np.asarray(subject_ppm, np.float64).reshape(-1)
    a = a - a.mean()
    b = b - b.mean()
    den = np.sqrt((a * a).sum() * (b * b).sum())
    return {"pearson": float((a * b).sum() / den) if den > 0 else np.nan}


def score_specificity_arrays(reference_ppms, true_sequence, chain_labels,
                             protein_mask, dna_mask, rna_mask, predicted_ppm,
                             mask) -> Dict:
    """Core of score_specificity_prediction (reference
    evaluation/na_eval_utils.py:3469-3651) on in-memory arrays."""
    aligned_ppm, ppm_mask, sc_dna, len_dna, sc_rna, len_rna = align_ppms(
        reference_ppms, true_sequence, chain_labels, protein_mask, dna_mask,
        rna_mask)
    result = {
        "aligned_ppm": aligned_ppm, "ppm_mask": ppm_mask,
        "alignment_score_dna": sc_dna, "aligned_dna_length": len_dna,
        "alignment_score_rna": sc_rna, "aligned_rna_length": len_rna,
    }
    t = constants.restype_to_int_table(True)
    for kind, kind_mask, cols in [
        ("dna", dna_mask, [t["DA"], t["DC"], t["DG"], t["DT"]]),
        ("rna", rna_mask, [t["A"], t["C"], t["G"], t["U"]]),
    ]:
        pos = (ppm_mask == 1) & (mask == 1) & (kind_mask == 1)
        if np.count_nonzero(pos) == 0:
            result[f"mean_absolute_error_{kind}"] = np.nan
            result[f"root_mean_squared_error_{kind}"] = np.nan
            result[f"cross_entropy_{kind}"] = np.nan
            result[f"pearson_{kind}"] = np.nan
            continue
        ref = aligned_ppm[pos][:, cols]
        sub = np.asarray(predicted_ppm, np.float64)[pos][:, cols]
        result[f"mean_absolute_error_{kind}"] = \
            calculate_ppm_mean_absolute_error(ref, sub)["mean_absolute_error"]
        result[f"root_mean_squared_error_{kind}"] = \
            calculate_ppm_root_mean_squared_error(ref, sub)["root_mean_squared_error"]
        result[f"cross_entropy_{kind}"] = \
            calculate_ppm_cross_entropy(ref, sub)["cross_entropy"]
        result[f"pearson_{kind}"] = calculate_ppm_pearson(ref, sub)["pearson"]
    return result
