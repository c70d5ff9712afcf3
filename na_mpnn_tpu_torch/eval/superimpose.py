"""Structure comparison: Kabsch superposition, RMSD, lDDT, GDT.

The port's own copy of the JAX package's ``eval/superimpose.py``.
Self-contained numpy replacements for the biotite calls in the reference
design-scoring pipeline (reference evaluation/na_eval_utils.py:3119-3340,
biotite.structure.superimpose / rmsd / lddt), since biotite is not available
in this environment. Formulas follow the published definitions (lDDT:
Mariani 2013; GDT_TS: Zemla 2003).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def kabsch_superimpose(fixed: np.ndarray, mobile: np.ndarray):
    """Least-squares superposition of mobile onto fixed ([N,3] each).
    Returns (mobile_transformed, (R, t))."""
    fixed = np.asarray(fixed, np.float64)
    mobile = np.asarray(mobile, np.float64)
    cf = fixed.mean(0)
    cm = mobile.mean(0)
    H = (mobile - cm).T @ (fixed - cf)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = cf - R @ cm
    return (mobile @ R.T + t), (R, t)


def rmsd(a: np.ndarray, b: np.ndarray) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def superimposed_rmsd(fixed: np.ndarray, mobile: np.ndarray) -> float:
    moved, _ = kabsch_superimpose(fixed, mobile)
    return rmsd(fixed, moved)


def lddt(reference: np.ndarray, subject: np.ndarray,
         inclusion_radius: float = 15.0,
         thresholds=(0.5, 1.0, 2.0, 4.0)) -> float:
    """Superposition-free lDDT over representative atoms ([N,3] each):
    fraction of reference pairwise distances (within the inclusion radius)
    preserved within each threshold, averaged over thresholds."""
    ref = np.asarray(reference, np.float64)
    sub = np.asarray(subject, np.float64)
    dr = np.linalg.norm(ref[:, None] - ref[None], axis=-1)
    ds = np.linalg.norm(sub[:, None] - sub[None], axis=-1)
    n = ref.shape[0]
    mask = (dr < inclusion_radius) & ~np.eye(n, dtype=bool)
    if not mask.any():
        return float("nan")
    diff = np.abs(dr - ds)[mask]
    return float(np.mean([(diff < t).mean() for t in thresholds]))


def gdt(reference: np.ndarray, subject: np.ndarray,
        thresholds=(1.0, 2.0, 4.0, 8.0)) -> float:
    """GDT_TS on superimposed coordinates: mean fraction of atoms within the
    distance thresholds after global superposition."""
    moved, _ = kabsch_superimpose(reference, subject)
    d = np.linalg.norm(np.asarray(reference, np.float64) - moved, axis=-1)
    return float(np.mean([(d < t).mean() for t in thresholds]))


def load_atom_coords(structure_path: str, atom_name: str = "C1'") -> np.ndarray:
    """All coordinates of `atom_name` from a PDB or mmCIF file, in file
    order ([N,3]). Minimal text parse standing in for
    biotite.structure.io.load_structure (reference
    evaluation/na_eval_utils.py:3152-3157)."""
    import gzip
    opener = gzip.open if structure_path.endswith(".gz") else open
    path = structure_path
    is_cif = path.endswith(".cif") or path.endswith(".cif.gz")
    coords = []
    with opener(path, "rt") as f:
        if is_cif:
            header: list = []
            in_loop = False
            idx = {}
            for line in f:
                s = line.strip()
                if s.startswith("_atom_site."):
                    header.append(s.split(".", 1)[1])
                    in_loop = True
                    idx = {name: i for i, name in enumerate(header)}
                    continue
                if in_loop:
                    if s.startswith(("_", "loop_", "#")) or not s:
                        in_loop = False
                        header = []
                        continue
                    parts = s.split()
                    if len(parts) < len(idx):
                        continue
                    nm = parts[idx.get("label_atom_id", 3)].strip('"')
                    if nm == atom_name:
                        coords.append([float(parts[idx["Cartn_x"]]),
                                       float(parts[idx["Cartn_y"]]),
                                       float(parts[idx["Cartn_z"]])])
        else:
            for line in f:
                if line.startswith(("ATOM", "HETATM")):
                    if line[12:16].strip() == atom_name:
                        coords.append([float(line[30:38]), float(line[38:46]),
                                       float(line[46:54])])
    return np.asarray(coords, np.float64).reshape(-1, 3)


def structure_comparison_metrics(reference_coords: np.ndarray,
                                 subject_coords: np.ndarray) -> Dict:
    """The C1' metrics reported by the design-scoring pipeline (reference
    evaluation/na_eval_utils.py:3227-3335)."""
    return {
        "c1_prime_rmsd": superimposed_rmsd(reference_coords, subject_coords),
        "c1_prime_lddt": lddt(reference_coords, subject_coords),
        "c1_prime_gddt": gdt(reference_coords, subject_coords),
    }
