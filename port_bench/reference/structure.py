"""Structures as the reference reads them: the backbone atoms of each
polymer residue of a PDB file, in the 16-slot frame, with the masks, chain
labels, residue numbers and native tokens the model takes.

A residue is one with a CA (protein) or C1' (nucleic acid) atom, in file
order; a residue is protein, DNA or RNA by the completeness of that
polymer's backbone (RNA has every DNA backbone atom, so it is taken out of
DNA). Chains are numbered in order of first appearance.
"""
from __future__ import annotations

import numpy as np

from . import tokens as T

_NUCLEIC = set(T.DNA + T.RNA)


def read_pdb(path: str) -> dict:
    """The model's inputs of one PDB file as numpy arrays ``[L, ...]``."""
    residues, index = [], {}
    atoms = []
    with open(path) as f:
        for line in f:
            if not line.startswith(("ATOM", "HETATM")):
                continue
            name, resname = line[12:16].strip(), line[17:20].strip()
            key = (line[21], int(line[22:26]), line[26].strip())
            xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            atoms.append((key, name, resname, xyz))
            protein, nucleic = resname in T.PROTEIN, resname in _NUCLEIC
            if ((protein and name == "CA") or (nucleic and name == "C1'")) \
                    and key not in index:
                index[key] = len(residues)
                residues.append((key, resname))
    L = len(residues)
    X = np.zeros((L, len(T.ATOMS), 3), np.float32)
    X_m = np.zeros((L, len(T.ATOMS)), np.int32)
    for key, name, resname, xyz in atoms:
        i = index.get(key)
        if i is not None and name in T.SLOT and (resname in T.PROTEIN
                                                  or resname in _NUCLEIC):
            X[i, T.SLOT[name]] = xyz
            X_m[i, T.SLOT[name]] = 1

    def complete(names):
        return X_m[:, [T.SLOT[a] for a in names]].all(-1).astype(np.int32)

    protein = complete(T.PROTEIN_BACKBONE)
    rna = complete(T.RNA_BACKBONE)
    dna = complete(T.DNA_BACKBONE) - rna
    chains = {}
    for (chain, _, _), _ in residues:
        chains.setdefault(chain, len(chains))
    S = np.array([T.SHARED.get(r, T.SHARED["UNK"]) for _, r in residues],
                 np.int64)
    polytype = np.where(protein == 1, 0, np.where(dna == 1, 1,
                                                  np.where(rna == 1, 2, 3)))
    return {
        "X": X, "X_m": X_m, "S": S,
        "mask": protein + dna + rna,
        "protein_mask": protein, "dna_mask": dna, "rna_mask": rna,
        "R_idx": np.array([k[1] for k, _ in residues], np.int64),
        "chain_labels": np.array([chains[k[0]] for k, _ in residues], np.int64),
        "chain_letters": [k[0] for k, _ in residues],
        "R_polymer_type": polytype.astype(np.int64),
    }
