"""A parsed structure as LigandMPNN reads it (``models/ligand.py``): the
protein residues are the designed tokens, every other heavy atom is context.

``ligand_view(path, parsed)`` keeps the rows of ``parse_pdb``'s output that
are protein residues with a complete backbone (N, CA, C, O), gives them
LigandMPNN's 21-letter tokens (``ACDEFGHIKLMNPQRSTVWYX``; a residue name
outside the twenty is X), and collects the context atoms ``Y [N,3]``,
``Y_t [N]`` (atomic number), ``Y_m [N]`` in file order: every atom of the
file (of ``chains``, where given) that is not of a protein residue and not
of a water, with a known element other than hydrogen. Ligands, metals and
DNA/RNA residues are context alike; hydrogens and waters are dropped, as
LigandMPNN drops them. A structure with no context atom gets one absent
atom (``Y_m = 0``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import constants
from .pdb import (PROTEIN_RESNAMES, WATER_RESNAMES, read_cif_atoms,
                  read_pdb_atoms)

_ROW_KEYS = ("X", "X_m", "R_idx", "chain_labels", "xyz_65", "xyz_65_m")


def context_atoms(path: str, chains: Optional[List[str]] = None):
    """(the context atoms' records, ``Y``, ``Y_t``, ``Y_m``) of a PDB or
    mmCIF file (see the module's docstring)."""
    low = path.lower()
    if low.endswith((".cif", ".cif.gz", ".mmcif", ".mmcif.gz")):
        atoms = read_cif_atoms(path)
    else:
        atoms = read_pdb_atoms(path)
    kept = []
    for a in atoms:
        if chains and a.chain not in chains:
            continue
        if a.resname in PROTEIN_RESNAMES or a.resname in WATER_RESNAMES:
            continue
        z = constants.ELEMENT_DICT.get(a.element, 0)
        if z > 1:
            kept.append((a, z))
    if not kept:
        return [], np.zeros([1, 3], np.float32), np.zeros([1], np.int32), \
            np.zeros([1], np.int32)
    Y = np.asarray([a.xyz for a, _ in kept], np.float32)
    Y_t = np.asarray([z for _, z in kept], np.int32)
    return [a for a, _ in kept], Y, Y_t, np.ones_like(Y_t)


def ligand_view(path: str, parsed: Dict, chains: Optional[List[str]] = None) -> Dict:
    """``parsed`` (``parse_pdb(path, chains)``) cut to its complete protein
    residues, with LigandMPNN's tokens and the context atoms; the keys the
    CLI reads, the nucleic-acid residues' backbone written back with the
    other context atoms."""
    from ..models.ligand import RESTYPE_TO_INT, UNKNOWN

    rows = np.nonzero(np.asarray(parsed["protein_mask"]) == 1)[0]
    if rows.size == 0:
        raise ValueError(f"{path}: no protein residue with N, CA, C and O")
    view = {k: np.asarray(parsed[k])[rows] for k in _ROW_KEYS}
    n = rows.size
    resnames = [parsed["resnames"][i] for i in rows]
    chain_letters = [parsed["chain_letters"][i] for i in rows]
    ones, zeros = np.ones(n, np.int32), np.zeros(n, np.int32)
    view.update(
        S=np.asarray([RESTYPE_TO_INT.get(r, UNKNOWN) for r in resnames], np.int32),
        mask=ones, protein_mask=ones, dna_mask=zeros, rna_mask=zeros,
        rna_mask_for_token_conversion=zeros,
        R_polymer_type=np.full(n, constants.POLYTYPE_TO_INT["PP"], np.int64),
        resnames=resnames, chain_letters=chain_letters,
        icodes=[parsed["icodes"][i] for i in rows],
        backbone_atoms=[parsed["backbone_atoms"][i] for i in rows],
        na_chain_letters=[], water_atoms=parsed["water_atoms"])
    view["chain_list"] = sorted(set(chain_letters))
    view["mask_c"] = [np.array([c == cl for cl in chain_letters], bool)
                      for c in view["chain_list"]]
    others = [a for i, res in enumerate(parsed["backbone_atoms"])
              if parsed["protein_mask"][i] != 1 for a in res]
    view["other_atoms"] = others + list(parsed["other_atoms"])
    _, view["Y"], view["Y_t"], view["Y_m"] = context_atoms(path, chains)
    return view
