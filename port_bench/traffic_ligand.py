"""Training traffic of LigandMPNN cells: protein complexes with context
atoms, as per-structure arrays (``traffic.arrays``' keys for the protein
residues, plus ``Y [N,3]``, ``Y_t [N]``, ``Y_m [N]``), packed to the token
budget by the training loader's rule (``traffic.pack``).

A mix (``traffic/<name>.json``, ``"driver": "ligand_train"``) gives the
protein's ``length`` distribution (residues, the tokens) and its
``protein_chains``, the ``ligand_atoms`` range of the one small molecule
every structure carries and its ``ligand_elements`` (weights by element),
the ``dna_bp`` range of the duplex that even structures carry as context,
``batch_tokens``, ``batches`` and ``check_steps``. As in ``traffic.py`` a
seed moves coordinates, letters and order, never how much work there is:
lengths sit at fixed quantiles, atom and base-pair counts step by the
structure's index.

Geometry: residues on ``traffic``'s random walk of 4 A steps, N, CA, C, O
1.2 A about each centre; the ligand a chain of 1.5 A bonds starting 5 A
off a residue's centre (at the protein's surface); the duplex along a
line through a point 11 A off another residue's centre, 3.4 A rise and 36
degrees twist a base pair, 20 heavy atoms a nucleotide (1 P, 6 O, 4 N, 9
C) spread 2.5 A about a point 6 A off the axis.
"""
from __future__ import annotations

import numpy as np

from . import traffic
from .reference import tokens as T

NUCLEOTIDE = [15] + [8] * 6 + [7] * 4 + [6] * 9     # atomic numbers, 20 atoms
_GOLDEN = 0.6180339887


def _step(index, lo, hi):
    """A whole number in [lo, hi] stepped by the structure's index."""
    return int(lo + round((hi - lo) * ((index * _GOLDEN) % 1.0)))


def structures(mix: dict, n: int):
    """``n`` structures: (protein chains as ``traffic`` chains, ligand atom
    count, base pairs of the duplex, 0 on odd indices)."""
    out = []
    poly = {"kind": "protein", "chains": mix["protein_chains"]}
    for j in range(n):
        L = traffic.quantile_length(mix["length"], (j + 0.5) / n)
        chains = traffic._polymer_chains(poly, L, j)
        chains = [(traffic.CHAIN_IDS[k], kind, m) for k, (kind, m) in enumerate(chains)]
        bp = _step(j, *mix["dna_bp"]) if j % 2 == 0 else 0
        out.append((chains, _step(j + 7, *mix["ligand_atoms"]), bp))
    return out


def training_pool(mix: dict):
    """(structures, batches): the fewest structures whose packing by their
    residues gives at least ``batches`` batches, and the packing."""
    n = mix["batches"]
    while True:
        pool = structures(mix, n)
        batches = traffic.pack([sum(c[2] for c in s[0]) for s in pool], mix["batch_tokens"])
        if len(batches) >= mix["batches"]:
            return pool, batches
        n += max(1, n // 8)


def _unit(rng, n=None):
    v = rng.standard_normal((3,) if n is None else (n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def arrays(structure, mix: dict, seed: int, index: int) -> dict:
    """One structure as the loader's per-residue arrays of its protein and
    its context atoms."""
    chains, n_lig, bp = structure
    rng = traffic.rng_for(seed, 8, index)
    residues = traffic._walk(chains, rng)
    L = len(residues)
    X = np.zeros((L, len(T.ATOMS), 3), np.float32)
    X_m = np.zeros((L, len(T.ATOMS)), np.int32)
    centres = np.stack([r[3] for r in residues])
    for i, (_, _, _, centre, jitter) in enumerate(residues):
        X[i, :4] = centre + jitter[:4]
        X_m[i, :4] = 1
    elements = sorted(mix["ligand_elements"])
    weights = np.array([mix["ligand_elements"][e] for e in elements], np.float64)
    z = {"C": 6, "N": 7, "O": 8, "F": 9, "P": 15, "S": 16, "CL": 17, "BR": 35, "I": 53}
    lig = [centres[rng.integers(L)] + 5.0 * _unit(rng)]
    for _ in range(n_lig - 1):
        lig.append(lig[-1] + 1.5 * _unit(rng))
    Y = [np.stack(lig)]
    Y_t = [np.array([z[e] for e in rng.choice(elements, n_lig, p=weights / weights.sum())])]
    if bp:
        origin = centres[rng.integers(L)] + 11.0 * _unit(rng)
        axis = _unit(rng)
        u = np.cross(axis, _unit(rng))
        u /= np.linalg.norm(u)
        w = np.cross(axis, u)
        for k in range(bp):
            for strand in (0.0, np.pi):
                a = np.deg2rad(36.0) * k + strand
                site = origin + 3.4 * k * axis + 6.0 * (np.cos(a) * u + np.sin(a) * w)
                Y.append(site + 2.5 * rng.standard_normal((len(NUCLEOTIDE), 3)) / np.sqrt(3))
                Y_t.append(np.array(NUCLEOTIDE))
    Y = np.concatenate(Y).astype(np.float32)
    Y_t = np.concatenate(Y_t).astype(np.int32)
    zeros = np.zeros(L, np.int32)
    return {
        "X": X, "X_m": X_m, "S": rng.integers(0, 20, size=L).astype(np.int64),
        "mask": np.ones(L, np.int32),
        "R_idx": np.array([r[2] for r in residues], np.int32),
        "chain_labels": np.array([r[0] for r in residues], np.int64),
        "protein_mask": np.ones(L, np.int32), "dna_mask": zeros, "rna_mask": zeros,
        "R_polymer_type": np.zeros(L, np.int64),
        "Y": Y, "Y_t": Y_t, "Y_m": np.ones(len(Y_t), np.int32),
    }
