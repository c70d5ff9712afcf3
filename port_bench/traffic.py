"""The one traffic generator: every mix is a data file of parameters under
``traffic/`` (``<name>.json``) that this module reads.

A seed changes which coordinates, letters and order the structures get,
never how much work they are: lengths sit at fixed quantiles of each
polymer's length distribution and compositions follow the structure's
index, so every seed draws the same multiset of sizes, in another order.

Structures are lists of chains ``(chain_id, kind, length)``, kind one of
protein, dna, rna. ``write_pdb`` writes one as a PDB file (backbone atoms
around a random walk of 4 A steps; the benchmark's copy of the smoke
test's synthetic structure); ``arrays`` gives the same kind of structure as
the per-residue arrays a training loader yields.
"""
from __future__ import annotations

import json
import math
import os
import statistics

import numpy as np

from .reference import tokens as T

HERE = os.path.dirname(os.path.abspath(__file__))
CHAIN_IDS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
ATOMS = {"protein": T.PROTEIN_BACKBONE, "dna": T.DNA_BACKBONE,
         "rna": T.RNA_BACKBONE}
RESNAMES = {"protein": T.PROTEIN[:20], "dna": T.DNA[:4], "rna": T.RNA[:4]}


def load(name: str) -> dict:
    """The parameters of mix ``name`` (``traffic/<name>.json``)."""
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """A numpy generator keyed by the run's seed (any whole number) and
    ``keys``."""
    return np.random.default_rng([abs(int(seed)) % 2 ** 63, *keys])


def quantile_length(dist: dict, q: float) -> int:
    """The ``q`` quantile of a length distribution: ``uniform`` or
    ``loguniform`` over [lo, hi], or ``lognormal`` (median, sigma) clipped to
    [lo, hi]."""
    lo, hi = dist["lo"], dist["hi"]
    if dist["dist"] == "uniform":
        x = lo + q * (hi - lo)
    elif dist["dist"] == "loguniform":
        x = lo * (hi / lo) ** q
    elif dist["dist"] == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * statistics.NormalDist().inv_cdf(q))
    else:
        raise ValueError(f"length distribution {dist['dist']!r}")
    return int(round(min(max(x, lo), hi)))


def _polymer_chains(poly: dict, length: int, index: int):
    """The chains of one polymer entry of a structure: ``chains`` [lo, hi]
    chains (by the structure's index), each of ``length`` residues where
    ``each`` (a duplex), else the length split between them."""
    lo, hi = poly.get("chains", [1, 1])
    n = lo + index % (hi - lo + 1)
    if poly.get("each"):
        return [(poly["kind"], length)] * n
    return [(poly["kind"], length // n + (1 if i < length % n else 0))
            for i in range(n)]


def structure_pool(mix: dict, seed: int):
    """The requests of a serving mix: ``rounds`` rounds of the structures of
    ``round`` (groups of ``count`` structures, each of the group's
    polymers). A polymer either names its chains' ``lengths`` (a published
    structure's) or draws them: its lengths over all rounds are then the
    midpoints of equal-probability strata, each round taking one from each
    stratum, so rounds weigh alike; every seed gets the same structures'
    sizes. Returns a
    list of structures (chain lists), round after round, the rounds and the
    structures of each in the seed's order."""
    rounds = mix["rounds"]
    per_round = [[] for _ in range(rounds)]
    for g, group in enumerate(mix["round"]):
        c = group["count"]
        n = c * rounds
        lengths = []
        for p, poly in enumerate(group["polymers"]):
            if "lengths" in poly:       # a published structure's own chains
                lengths.append(None)
                continue
            # which stratum each round takes is fixed, not drawn from the seed
            rng = np.random.default_rng([g, p])
            stratum = np.stack([rng.permutation(rounds) for _ in range(c)])
            lengths.append([[quantile_length(poly["length"],
                                              (i * rounds + stratum[i, r] + 0.5) / n)
                             for i in range(c)] for r in range(rounds)])
        for r in range(rounds):
            for i in range(c):
                chains = []
                for p, poly in enumerate(group["polymers"]):
                    if "lengths" in poly:
                        chains += [(poly["kind"], n) for n in poly["lengths"]]
                    else:
                        chains += _polymer_chains(poly, lengths[p][r][i], r * c + i)
                per_round[r].append(
                    [(CHAIN_IDS[k], kind, n_res) for k, (kind, n_res) in enumerate(chains)])
    out = []
    for r in rng_for(seed, 1).permutation(rounds):
        structures = per_round[r]
        for i in rng_for(seed, 2, int(r)).permutation(len(structures)):
            out.append(structures[i])
    return out


def _walk(chains, rng):
    """Per residue: (chain index, kind, residue number, centre, atom
    offsets), the centres on one random walk of 4 A steps."""
    n = sum(c[2] for c in chains)
    steps = rng.standard_normal((n, 3))
    centres = np.cumsum(4.0 * steps / np.linalg.norm(steps, axis=1, keepdims=True), 0)
    jitter = rng.standard_normal((n, 13, 3)) * 1.2
    out, i = [], 0
    for c, (_, kind, length) in enumerate(chains):
        for r in range(length):
            out.append((c, kind, r + 1, centres[i], jitter[i]))
            i += 1
    return out


def write_pdb(path: str, chains, seed: int, index: int) -> int:
    """Write structure ``chains`` as a PDB file: every backbone atom of its
    polymer (O2' on RNA) 1.2 A about each residue's centre, residue names
    drawn from the polymer's letters. Returns the residue count."""
    rng = rng_for(seed, 3, index)
    lines, serial = [], 1
    residues = _walk(chains, rng)
    letters = rng.integers(0, 20, size=len(residues))
    for i, (c, kind, num, centre, jitter) in enumerate(residues):
        resname = RESNAMES[kind][letters[i] % len(RESNAMES[kind])]
        for a, atom in enumerate(ATOMS[kind]):
            xyz = centre + jitter[a]
            nm = atom if len(atom) == 4 else " " + atom
            element = atom.strip("'0123456789")[0]
            lines.append(
                f"ATOM  {serial:>5} {nm:<4} {resname:>3} {chains[c][0]}{num:>4}    "
                f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00 10.00          "
                f"{element:>2}")
            serial += 1
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(residues)


def arrays(chains, seed: int, index: int) -> dict:
    """Structure ``chains`` as per-residue arrays (the keys a training
    loader yields: ``X [L,16,3]``, ``X_m``, ``S``, ``R_idx``,
    ``chain_labels``, the polymer masks, ``R_polymer_type``, ``mask``)."""
    rng = rng_for(seed, 4, index)
    residues = _walk(chains, rng)
    L = len(residues)
    X = np.zeros((L, len(T.ATOMS), 3), np.float32)
    X_m = np.zeros((L, len(T.ATOMS)), np.int32)
    kinds = np.array([r[1] for r in residues])
    letters = rng.integers(0, 20, size=L)
    S = np.zeros(L, np.int64)
    for i, (c, kind, num, centre, jitter) in enumerate(residues):
        slots = [T.SLOT[a] for a in ATOMS[kind]]
        X[i, slots] = centre + jitter[:len(slots)]
        X_m[i, slots] = 1
        S[i] = T.SHARED[RESNAMES[kind][letters[i] % len(RESNAMES[kind])]]
    masks = {k: (kinds == k).astype(np.int32) for k in ("protein", "dna", "rna")}
    return {
        "X": X, "X_m": X_m, "S": S, "mask": np.ones(L, np.int32),
        "R_idx": np.array([r[2] for r in residues], np.int32),
        "chain_labels": np.array([r[0] for r in residues], np.int64),
        "protein_mask": masks["protein"], "dna_mask": masks["dna"],
        "rna_mask": masks["rna"],
        "R_polymer_type": (masks["dna"] * 1 + masks["rna"] * 2).astype(np.int64),
    }


def training_structures(mix: dict, n: int):
    """``n`` protein-nucleic-acid complexes: total lengths at the midpoints of
    n equal-probability strata of ``length``, a nucleic-acid share of each
    that steps through [lo, hi] by the structure's index (a DNA duplex on
    even indices, one RNA chain on odd), the protein in ``protein_chains``
    chains."""
    lo, hi = mix["na_share"]
    out = []
    for j in range(n):
        L = quantile_length(mix["length"], (j + 0.5) / n)
        na = max(2, int(round(L * (lo + (hi - lo) * ((j * 0.6180339887) % 1.0)))))
        na_chains = [("dna", na // 2), ("dna", na - na // 2)] if j % 2 == 0 else [("rna", na)]
        poly = {"kind": "protein", "chains": mix["protein_chains"]}
        chains = _polymer_chains(poly, L - na, j) + na_chains
        out.append([(CHAIN_IDS[k], kind, m) for k, (kind, m) in enumerate(chains)])
    return out


def pack(lengths, max_tokens):
    """Greedy packing by sorted length: a batch takes structures while its
    size times its longest stays within ``max_tokens`` (the training
    loader's rule). Returns lists of indices."""
    batches, cur = [], []
    for i in np.argsort(lengths, kind="stable"):
        if lengths[i] > max_tokens:
            continue
        if lengths[i] * (len(cur) + 1) <= max_tokens:
            cur.append(int(i))
        else:
            batches.append(cur)
            cur = [int(i)]
    if cur:
        batches.append(cur)
    return batches


def training_pool(mix: dict):
    """(structures, batches): the fewest structures whose packing gives at
    least ``batches`` batches, and the packing."""
    n = mix["batches"]
    while True:
        structures = training_structures(mix, n)
        lengths = [sum(c[2] for c in s) for s in structures]
        batches = pack(lengths, mix["batch_tokens"])
        if len(batches) >= mix["batches"]:
            return structures, batches
        n += max(1, n // 8)
