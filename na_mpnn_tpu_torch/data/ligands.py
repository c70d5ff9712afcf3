"""Ligand residue library: chem_comp parsing, leaving groups, automorphisms,
topology and molecule features (the port's own copy of the JAX package's
``data/ligands.py``, on numpy).

Every property comes from the chem_comp mmCIF tables (or SDF records):

* atoms: element, formal charge, stereo flag, leaving flag, pdbx_align,
  ideal coordinates            (chem_comp_atom)
* bonds: order, aromaticity    (chem_comp_bond)
* leaving groups: a neighbour flagged pdbx_leaving_atom_flag=Y plus
  everything its removal disconnects, by reachability over the bond graph
* automorphisms: element-, charge- and bond-preserving automorphisms of the
  heavy-atom graph, kept to the columns with alternative mappings and to
  the mappings that touch no leaving atom
* chirals: atoms with an R/S pdbx_stereo_config
* planars: atoms of aromatic or double bonds with 3+ heavy neighbours
* topology and featurisation: ``get_topology`` (bonds, lengths, angles,
  dihedrals, planars, chirals), ``MolFeaturizer`` (1D / 2D features,
  hydrogen reduction), ``parse_sdf`` for SDF input

networkx is imported only inside the functions that need it (leaving
groups, automorphisms, ``build_residue``, ``features_2d``): the rest runs
without it.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LigAtom = collections.namedtuple(
    "LigAtom", ["name", "element", "charge", "leaving", "leaving_group",
                "parent", "align", "stereo", "aromatic", "xyz"])
LigBond = collections.namedtuple(
    "LigBond", ["a", "b", "order", "aromatic", "in_ring"])
LigandResidue = collections.namedtuple(
    "LigandResidue", ["name", "atoms", "bonds", "automorphisms", "chirals",
                      "planars"])

_BOND_ORDER = {"SING": 1, "DOUB": 2, "TRIP": 3, "QUAD": 4, "AROM": 1}


def parse_chem_comp_cif(path: str) -> Dict:
    """Parse one PDB chemical-component definition (chem_comp_atom +
    chem_comp_bond tables) — role of reference ParsePDBLigand
    (cifutils.py:77-119), without the pdbx reader dependency."""
    from .cif import read_cif

    tables = read_cif(path)
    cca = tables.get("chem_comp_atom")
    if cca is None:
        raise ValueError(f"no chem_comp_atom table in {path}")

    def col(table, key, k, default=None):
        v = table.get(k, key, default)
        return v

    atoms = []
    for k in range(len(cca)):
        xyz = []
        for c in ("model_Cartn_x", "model_Cartn_y", "model_Cartn_z"):
            v = col(cca, c, k, "?")
            xyz.append(float(v) if v not in ("?", ".", None) else np.nan)
        charge = col(cca, "charge", k, "0")
        atoms.append({
            "atom_id": col(cca, "atom_id", k).strip('"'),
            "symbol": (col(cca, "type_symbol", k) or "").upper(),
            "leaving": col(cca, "pdbx_leaving_atom_flag", k, "N") == "Y",
            "align": int(col(cca, "pdbx_align", k, "0") or 0),
            "charge": int(charge) if charge not in ("?", ".", None) else 0,
            "stereo": col(cca, "pdbx_stereo_config", k, "N") or "N",
            "aromatic": col(cca, "pdbx_aromatic_flag", k, "N") == "Y",
            "xyz": xyz,
        })

    bonds = []
    ccb = tables.get("chem_comp_bond")
    if ccb is not None:
        for k in range(len(ccb)):
            order_raw = (col(ccb, "value_order", k, "SING") or "SING").upper()
            bonds.append({
                "a": col(ccb, "atom_id_1", k).strip('"'),
                "b": col(ccb, "atom_id_2", k).strip('"'),
                "order": _BOND_ORDER.get(order_raw, 1),
                "aromatic": col(ccb, "pdbx_aromatic_flag", k, "N") == "Y",
            })

    comp = tables.get("chem_comp")
    name = comp.get(0, "id", "") if comp is not None else \
        os.path.splitext(os.path.basename(path))[0].upper()
    return {"name": name, "atoms": atoms, "bonds": bonds}


def leaving_group_of(aname: str, G) -> List[str]:
    """Atoms removed with `aname`'s leaving neighbors: each leaving neighbor
    plus any component it disconnects (reference getLeavingAtoms2,
    cifutils.py:171-189)."""
    import networkx as nx

    if G.nodes[aname]["leaving"]:
        return []
    group = set()
    for m in G.neighbors(aname):
        if not G.nodes[m]["leaving"]:
            continue
        group.add(m)
        H = G.subgraph(set(G.nodes) - {m})
        ccs = list(nx.connected_components(H))
        if len(ccs) > 1:
            for cc in ccs:
                if aname not in cc:
                    group.update(cc)
    return sorted(group)


def find_automorphisms(atom_ids: Sequence[str], elements: Sequence[str],
                       bonds: Sequence[Tuple[str, str]],
                       leaving: Optional[Sequence[bool]] = None,
                       max_count: int = 1000,
                       charges: Optional[Sequence[int]] = None,
                       bond_orders: Optional[Sequence[int]] = None) -> List[List[str]]:
    """Chemically-valid automorphisms of the heavy-atom graph, as rows of
    atom names: mappings must preserve element, formal charge, adjacency,
    and bond order (OpenBabel's symmetry classes carry the same invariants;
    reference FindAutomorphisms, obutils.py:15-87). Only columns with
    alternative mappings are retained, and — like the reference
    (cifutils.py:262-270) — every row whose retained columns contain a
    leaving atom is dropped, including the identity row."""
    import networkx as nx
    from networkx.algorithms import isomorphism

    elem = dict(zip(atom_ids, elements))
    chg = dict(zip(atom_ids, charges)) if charges is not None else {}
    heavy = [a for a in atom_ids if elem[a].upper() not in ("H", "D")]
    hset = set(heavy)
    G = nx.Graph()
    G.add_nodes_from((a, {"el": elem[a].upper(), "q": chg.get(a, 0)})
                     for a in heavy)
    orders = list(bond_orders) if bond_orders is not None else [1] * len(bonds)
    G.add_edges_from((a, b, {"o": o}) for (a, b), o in zip(bonds, orders)
                     if a in hset and b in hset)

    gm = isomorphism.GraphMatcher(
        G, G, node_match=lambda x, y: x["el"] == y["el"] and x["q"] == y["q"],
        edge_match=lambda x, y: x["o"] == y["o"])
    autos = []
    for mapping in gm.isomorphisms_iter():
        autos.append([mapping[a] for a in heavy])
        if len(autos) >= max_count:
            break
    if not autos:
        return []
    # Put the identity first (GraphMatcher yields it in arbitrary position).
    autos.sort(key=lambda row: row != list(heavy))
    A = np.array(autos)

    # Retain only columns that actually permute.
    varies = (A[:1] != A).any(axis=0)
    A = A[:, varies]
    if A.shape[1] == 0:
        return []

    # Drop mappings involving leaving atoms.
    if leaving is not None and A.shape[0] > 1:
        is_leaving = dict(zip(atom_ids, leaving))
        keep = [not any(is_leaving.get(a, False) for a in row) for row in A]
        A = A[np.asarray(keep, bool)]
    return A.tolist()


def build_residue(raw: Dict) -> LigandResidue:
    """chem_comp dict -> LigandResidue with leaving groups, automorphisms,
    chirals, planars (role of reference parseLigand, cifutils.py:191-293)."""
    import networkx as nx

    atoms_raw = raw["atoms"]
    bonds_raw = raw["bonds"]
    elem = {a["atom_id"]: a["symbol"] for a in atoms_raw}

    G = nx.Graph()
    G.add_nodes_from((a["atom_id"], {"leaving": a["leaving"]})
                     for a in atoms_raw)
    G.add_edges_from((b["a"], b["b"]) for b in bonds_raw)

    neighbors = {a["atom_id"]: list(G.neighbors(a["atom_id"]))
                 if a["atom_id"] in G else [] for a in atoms_raw}

    atoms = {}
    for a in atoms_raw:
        # parent = (last) heavy neighbor, matching the reference's loop
        # semantics (cifutils.py:222-226).
        parent = None
        for nb in neighbors[a["atom_id"]]:
            if elem.get(nb, "").upper() not in ("H", "D"):
                parent = nb
        atoms[a["atom_id"]] = LigAtom(
            name=a["atom_id"], element=a["symbol"], charge=a["charge"],
            leaving=a["leaving"],
            leaving_group=leaving_group_of(a["atom_id"], G)
            if a["atom_id"] in G else [],
            parent=parent, align=a["align"], stereo=a["stereo"],
            aromatic=a["aromatic"], xyz=a["xyz"])

    ring_nodes = set()
    for cycle in nx.cycle_basis(G):
        ring_nodes.update(cycle)
    bonds = [LigBond(a=b["a"], b=b["b"], order=b["order"],
                     aromatic=b["aromatic"],
                     in_ring=b["a"] in ring_nodes and b["b"] in ring_nodes)
             for b in bonds_raw]

    # Aromatic bonds compare equal regardless of their Kekulé order so ring
    # flips (PHE/TYR CD1<->CD2) are valid automorphisms, as OpenBabel's
    # aromatic perception makes them for the reference; quasi-symmetric
    # groups with genuinely different orders (ASP OD1=O vs OD2-O) still
    # don't permute (the reference leaves those asymmetric too,
    # obutils.py:14 TODO).
    autos = find_automorphisms(
        [a["atom_id"] for a in atoms_raw],
        [a["symbol"] for a in atoms_raw],
        [(b["a"], b["b"]) for b in bonds_raw],
        [a["leaving"] for a in atoms_raw],
        charges=[a["charge"] for a in atoms_raw],
        bond_orders=[("ar" if b["aromatic"] else b["order"])
                     for b in bonds_raw])

    chirals = [a["atom_id"] for a in atoms_raw if a["stereo"] in ("R", "S")]
    heavy_deg = {a: sum(1 for nb in neighbors[a]
                        if elem.get(nb, "").upper() not in ("H", "D"))
                 for a in elem}
    planar_atoms = set()
    for b in bonds_raw:
        if b["aromatic"] or b["order"] == 2:
            for end in (b["a"], b["b"]):
                if heavy_deg.get(end, 0) >= 3:
                    planar_atoms.add(end)
    return LigandResidue(name=raw["name"], atoms=atoms, bonds=bonds,
                         automorphisms=autos, chirals=chirals,
                         planars=sorted(planar_atoms))


class ResidueLibrary:
    """Lazy residue library (role of reference CIFParser.mols + getRes,
    cifutils.py:126-160): entries come from a directory of chem_comp .cif
    files and/or a precompiled JSON(.gz) of parse_chem_comp_cif outputs;
    residues are built on first access and cached."""

    def __init__(self, cif_dir: Optional[str] = None,
                 json_path: Optional[str] = None,
                 skip_res: Sequence[str] = ()):
        self._raw: Dict[str, Dict] = {}
        self._built: Dict[str, LigandResidue] = {}
        self._cif_paths: Dict[str, str] = {}
        skip = set(skip_res)
        if json_path:
            opener = gzip.open if json_path.endswith(".gz") else open
            with opener(json_path, "rt") as f:
                for name, raw in json.load(f).items():
                    if name not in skip:
                        self._raw[name] = raw
        if cif_dir:
            for p in glob.glob(os.path.join(cif_dir, "*.cif")):
                name = os.path.splitext(os.path.basename(p))[0].upper()
                if name not in skip:
                    self._cif_paths[name] = p

    STANDARD_LIBRARY_PATH = os.path.join(os.path.dirname(__file__),
                                         "residue_library.json.gz")

    @classmethod
    def standard(cls, **kwargs) -> "ResidueLibrary":
        """The packaged standard-residue library: 20 amino acids + 8
        nucleotides and the common modified residues, prebuilt by
        scripts/build_residue_library.py (role of the reference's shipped
        ligands.json.gz, cifutils.py:130); the port's copy of the JAX
        package's file, byte for byte."""
        return cls(json_path=cls.STANDARD_LIBRARY_PATH, **kwargs)

    def __contains__(self, resname: str) -> bool:
        return resname in self._raw or resname in self._cif_paths

    def get(self, resname: str) -> Optional[LigandResidue]:
        if resname in self._built:
            return self._built[resname]
        raw = self._raw.get(resname)
        if raw is None and resname in self._cif_paths:
            raw = parse_chem_comp_cif(self._cif_paths[resname])
        if raw is None:
            return None
        res = build_residue(raw)
        self._built[resname] = res
        return res

    def save_json(self, path: str):
        """Precompile the raw entries (reference ligands.json.gz analog)."""
        raw = dict(self._raw)
        for name, p in self._cif_paths.items():
            if name not in raw:
                raw[name] = parse_chem_comp_cif(p)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt") as f:
            json.dump(raw, f)


# ---------------------------------------------------------------------------
# Molecule topology + featurization (reference obutils.py:159-413:
# GetTopology, ReduceHydrogens, GetFeatures1D/2D, OBMolFeaturizer).
# The reference derives these through OpenBabel perception on an OBMol; here
# they are derived from the same underlying chemistry carried by chem_comp /
# SDF tables (elements, charges, bond orders, aromatic flags, coordinates),
# so no chemistry toolkit is required at runtime.
# ---------------------------------------------------------------------------

_ELEMENTS = (
    "H HE LI BE B C N O F NE NA MG AL SI P S CL AR K CA SC TI V CR MN FE CO "
    "NI CU ZN GA GE AS SE BR KR RB SR Y ZR NB MO TC RU RH PD AG CD IN SN SB "
    "TE I XE CS BA LA CE PR ND PM SM EU GD TB DY HO ER TM YB LU HF TA W RE "
    "OS IR PT AU HG TL PB BI PO AT RN FR RA AC TH PA U NP PU AM CM BK CF ES "
    "FM MD NO LR RF DB SG BH HS MT DS RG CN NH FL MC LV TS OG").split()
ATOMIC_NUM = {el: i + 1 for i, el in enumerate(_ELEMENTS)}
ATOMIC_NUM["D"] = 1  # deuterium

# Single-bond covalent radii (Angstrom, Pyykko & Atsumi 2009) for the
# elements that occur in PDB ligands — the GetEquibLength fallback when a
# residue entry carries no usable coordinates.
_COVALENT_RADIUS = {
    "H": 0.32, "B": 0.85, "C": 0.75, "N": 0.71, "O": 0.63, "F": 0.64,
    "NA": 1.55, "MG": 1.39, "SI": 1.16, "P": 1.11, "S": 1.03, "CL": 0.99,
    "K": 1.96, "CA": 1.71, "MN": 1.19, "FE": 1.16, "CO": 1.11, "NI": 1.10,
    "CU": 1.12, "ZN": 1.18, "SE": 1.16, "BR": 1.14, "I": 1.33,
}
# Multiplicative bond-order correction to the radii sum (double/triple bonds
# are ~0.87x / ~0.78x the single-bond length for first-row elements).
_ORDER_SCALE = {1: 1.0, 2: 0.87, 3: 0.78, 4: 0.78}

# Aufbau shell filling order — the electron-configuration embedding the
# reference featurizer loads from its elements.txt data file
# (obutils.py:260-274); derived here instead of shipped.
_SPDF = [("1s", 2), ("2s", 2), ("2p", 6), ("3s", 2), ("3p", 6),
         ("4s", 2), ("3d", 10), ("4p", 6), ("5s", 2), ("4d", 10),
         ("5p", 6), ("6s", 2), ("4f", 14), ("5d", 10), ("6p", 6),
         ("7s", 2), ("5f", 14), ("6d", 10), ("7p", 6)]


def electron_configuration(atomic_num: int) -> np.ndarray:
    """Aufbau-order shell occupancy as a flat 0/1 vector over the 118 spdf
    slots (role of the reference's econf table, obutils.py:260-274)."""
    out = []
    left = atomic_num
    for _, cap in _SPDF:
        n = min(left, cap)
        out.extend([1] * n + [0] * (cap - n))
        left -= n
    return np.asarray(out, np.float32)


def _mol_arrays(raw: Dict):
    """Common index-space views of a raw molecule dict: names, elements,
    0-based bond index pairs, orders, aromatic flags, coords [L,3]."""
    atoms = raw["atoms"]
    names = [a["atom_id"] for a in atoms]
    index = {n: i for i, n in enumerate(names)}
    elements = [a["symbol"].upper() for a in atoms]
    bonds = np.asarray([(index[b["a"]], index[b["b"]]) for b in raw["bonds"]],
                       np.int64).reshape(-1, 2)
    orders = np.asarray([b["order"] for b in raw["bonds"]], np.int64)
    arom = np.asarray([b["aromatic"] for b in raw["bonds"]], bool)
    # JSON-roundtripped entries carry null for unknown coordinates.
    xyz = np.asarray([[np.nan if c is None else c for c in a["xyz"]]
                      for a in atoms], np.float64).reshape(-1, 3)
    return names, elements, bonds, orders, arom, xyz


def _adjacency(n: int, bonds: np.ndarray) -> List[List[int]]:
    adj: List[List[int]] = [[] for _ in range(n)]
    for a, b in bonds:
        adj[a].append(int(b))
        adj[b].append(int(a))
    return adj


def hybridization(raw: Dict) -> np.ndarray:
    """Per-atom hybridization 0/1/2/3 (role of OBAtom.GetHyb): sp for a
    triple bond or cumulated doubles, sp2 for aromatic/one double, sp3 for
    other bonded heavy atoms, 0 for hydrogens and unbonded atoms."""
    names, elements, bonds, orders, arom, _ = _mol_arrays(raw)
    n = len(names)
    n_double = np.zeros(n, np.int64)
    n_triple = np.zeros(n, np.int64)
    is_arom = np.zeros(n, bool)
    bonded = np.zeros(n, bool)
    for (a, b), o, ar in zip(bonds, orders, arom):
        bonded[a] = bonded[b] = True
        if ar:
            is_arom[a] = is_arom[b] = True
        elif o == 2:
            n_double[a] += 1
            n_double[b] += 1
        elif o >= 3:
            n_triple[a] += 1
            n_triple[b] += 1
    hyb = np.full(n, 3, np.int64)
    hyb[is_arom | (n_double == 1)] = 2
    hyb[(n_triple > 0) | (n_double >= 2)] = 1
    hyb[~bonded] = 0
    hyb[np.asarray([e in ("H", "D") for e in elements])] = 0
    return hyb


def chiral_quadruples(raw: Dict) -> np.ndarray:
    """Oriented chiral quadruples [N,4] of atom indices: column 0 the
    stereocenter, columns 1-3 substituents ordered so the triple product of
    the three center->substituent vectors is positive (the invariant the
    reference states for GetChirals, obutils.py:89-135). Stereocenters come
    from pdbx_stereo_config (chem_comp) or coordinates+graph (SDF); every
    3-subset of the heavy substituents is emitted, oriented with the entry's
    ideal coordinates."""
    import itertools

    import torch

    from ..utils.geometry import triple_prod

    names, elements, bonds, _, _, xyz = _mol_arrays(raw)
    adj = _adjacency(len(names), bonds)
    heavy = [e not in ("H", "D") for e in elements]
    quads = []
    for c, a in enumerate(raw["atoms"]):
        if a.get("stereo", "N") not in ("R", "S"):
            continue
        nbrs = [j for j in adj[c] if heavy[j]]
        if len(nbrs) < 3 or not np.isfinite(xyz[c]).all():
            continue
        for trip in itertools.combinations(nbrs, 3):
            if not np.isfinite(xyz[list(trip)]).all():
                continue
            i, j, k = trip
            v = xyz[[i, j, k]] - xyz[c]
            # float32, as the JAX package's triple product takes these
            # float64 vectors, so a near-zero product has JAX's sign
            v = torch.from_numpy(v.astype(np.float32))
            if float(triple_prod(v[0], v[1], v[2])) < 0:
                i, j = j, i
            quads.append((c, i, j, k))
    return np.asarray(quads, np.int64).reshape(-1, 4)


def planar_quadruples(raw: Dict) -> np.ndarray:
    """sp2 centers with exactly 3 bonded neighbors as [N,4] index rows
    (center, n1, n2, n3) — role of GetPlanars (obutils.py:139-155), heavy
    rows only."""
    names, elements, bonds, _, _, _ = _mol_arrays(raw)
    adj = _adjacency(len(names), bonds)
    hyb = hybridization(raw)
    heavy = [e not in ("H", "D") for e in elements]
    rows = []
    for c in range(len(names)):
        if hyb[c] == 2 and len(adj[c]) == 3 and heavy[c] \
                and all(heavy[j] for j in adj[c]):
            rows.append((c, *sorted(adj[c])))
    return np.asarray(rows, np.int64).reshape(-1, 4)


def get_topology(raw: Dict) -> Dict[str, np.ndarray]:
    """Full bonded topology (role of GetTopology, obutils.py:159-173):

    * bonds   [Nb,2]  atom-index pairs
    * bondlen [Nb]    equilibrium lengths — measured from the entry's ideal
                      coordinates when finite, else covalent-radii sum scaled
                      by bond order (role of OBBond.GetEquibLength)
    * angles  [Na,3]  (center, i, j) for every bonded i-center-j pair
    * dihedrals [Nd,4] (a,b,c,d) over every bonded 4-atom path
    * planars [Np,4]  sp2 centers + their 3 neighbors
    * chirals [Nc,4]  oriented stereocenter quadruples
    """
    import itertools

    names, elements, bonds, orders, _, xyz = _mol_arrays(raw)
    n = len(names)
    adj = _adjacency(n, bonds)

    bondlen = np.zeros(len(bonds), np.float64)
    for i, ((a, b), o) in enumerate(zip(bonds, orders)):
        if np.isfinite(xyz[a]).all() and np.isfinite(xyz[b]).all():
            bondlen[i] = float(np.linalg.norm(xyz[a] - xyz[b]))
        else:
            ra = _COVALENT_RADIUS.get(elements[a], 0.75)
            rb = _COVALENT_RADIUS.get(elements[b], 0.75)
            bondlen[i] = (ra + rb) * _ORDER_SCALE.get(int(o), 1.0)

    angles = [(c, i, j) for c in range(n)
              for i, j in itertools.combinations(sorted(adj[c]), 2)]
    dihedrals = []
    for b, c in bonds:
        for a in adj[b]:
            if a == c:
                continue
            for d in adj[c]:
                if d == b or d == a:
                    continue
                dihedrals.append((a, int(b), int(c), d))

    return {
        "bonds": bonds,
        "bondlen": bondlen,
        "angles": np.asarray(angles, np.int64).reshape(-1, 3),
        "dihedrals": np.asarray(dihedrals, np.int64).reshape(-1, 4),
        "planars": planar_quadruples(raw),
        "chirals": chiral_quadruples(raw),
    }


def parse_sdf(text_or_path: str) -> List[Dict]:
    """Minimal MDL SDF/MOL (V2000) reader producing the same raw-molecule
    dicts as parse_chem_comp_cif, so every topology/featurizer entry point
    runs on SDF input too (the reference featurizes OBMols read from SDF).
    Handles the atom/bond blocks, `M  CHG` lines, and multi-record files."""
    if os.path.exists(text_or_path):
        with open(text_or_path) as f:
            text = f.read()
    else:
        text = text_or_path
    mols = []
    for record in text.split("$$$$"):
        lines = record.strip("\n").splitlines()
        if len(lines) < 4:
            continue
        counts = lines[3]
        try:
            na, nb = int(counts[0:3]), int(counts[3:6])
        except ValueError:
            continue
        atoms = []
        for k in range(na):
            ln = lines[4 + k]
            atoms.append({
                "atom_id": f"{ln[31:34].strip().upper()}{k + 1}",
                "symbol": ln[31:34].strip().upper(),
                "charge": 0, "leaving": False, "align": 0, "stereo": "N",
                "aromatic": False,
                "xyz": [float(ln[0:10]), float(ln[10:20]), float(ln[20:30])],
            })
        bonds = []
        for k in range(nb):
            ln = lines[4 + na + k]
            a, b = int(ln[0:3]) - 1, int(ln[3:6]) - 1
            order = int(ln[6:9])
            bonds.append({"a": atoms[a]["atom_id"], "b": atoms[b]["atom_id"],
                          "order": min(order, 3) if order != 4 else 1,
                          "aromatic": order == 4})
        for ln in lines[4 + na + nb:]:
            if ln.startswith("M  CHG"):
                vals = ln.split()[3:]
                for idx, q in zip(vals[0::2], vals[1::2]):
                    atoms[int(idx) - 1]["charge"] = int(q)
            elif ln.startswith("M  END"):
                break
        mols.append({"name": lines[0].strip() or "MOL",
                     "atoms": atoms, "bonds": bonds})
    return mols


class MolFeaturizer:
    """Molecule featurizer (reference OBMolFeaturizer, obutils.py:243-413):
    raw 1D atom features, one-hot 2D pair features, and hydrogen reduction.
    Operates on raw molecule dicts from parse_chem_comp_cif / parse_sdf /
    ResidueLibrary entries."""

    def __init__(self, maxpath: int = 8, maxcharge: int = 6,
                 maxhyb: int = 24, maxhydr: int = 12):
        self.maxpath = maxpath
        self.maxcharge = maxcharge
        self.maxhyb = maxhyb
        self.maxhydr = maxhydr
        self.dims1d = (118, maxcharge * 2, maxhydr, maxhyb + 1)
        self.dims2d = (2, 2, 4, maxpath + 1)

    def num_features_1d(self) -> int:
        return sum(self.dims1d)

    def num_features_2d(self) -> int:
        return sum(self.dims2d)

    def features_1d(self, raw: Dict) -> np.ndarray:
        """[L,4] int: atomic number, formal charge, explicit-hydrogen count,
        hybridization (reference GetFeatures1D, obutils.py:194-204)."""
        names, elements, bonds, _, _, _ = _mol_arrays(raw)
        adj = _adjacency(len(names), bonds)
        hyb = hybridization(raw)
        rows = []
        for i, a in enumerate(raw["atoms"]):
            nh = sum(1 for j in adj[i] if elements[j] in ("H", "D"))
            rows.append((ATOMIC_NUM.get(elements[i], 0), a.get("charge", 0),
                         nh, int(hyb[i])))
        return np.asarray(rows, np.int64)

    def features_2d(self, raw: Dict, one_hot: bool = True) -> np.ndarray:
        """[L,L,4] int (aromatic, in-ring, bond order, bond separation) or
        its one-hot expansion [L,L,sum(dims2d)] (reference GetFeatures2D,
        obutils.py:208-239 / 316-351). Separation is the shortest bonded
        path, 0 beyond maxpath (as in the reference's cutoff BFS)."""
        names, elements, bonds, orders, arom, _ = _mol_arrays(raw)
        n = len(names)
        f2d = np.zeros((n, n, 4), np.int64)

        # A bond is in a ring iff it lies on a cycle, i.e. is not a bridge.
        import networkx as nx
        G = nx.Graph()
        G.add_nodes_from(range(n))
        G.add_edges_from((int(a), int(b)) for a, b in bonds)
        bridges = {frozenset(e) for e in nx.bridges(G)}

        for (a, b), o, ar in zip(bonds, orders, arom):
            in_ring = frozenset((int(a), int(b))) not in bridges
            vals = (int(ar), int(in_ring), min(int(o), 3))
            f2d[a, b, :3] = vals
            f2d[b, a, :3] = vals

        for i, lengths in nx.all_pairs_shortest_path_length(
                G, cutoff=self.maxpath):
            for j, d in lengths.items():
                f2d[i, j, 3] = d

        if not one_hot:
            return f2d
        out = np.zeros((n, n, self.num_features_2d()), np.float32)
        off = 0
        for c, dim in enumerate(self.dims2d):
            idx = np.clip(f2d[:, :, c], 0, dim - 1)
            out[np.arange(n)[:, None], np.arange(n)[None, :], off + idx] = 1.0
            off += dim
        return out

    def embed_features_1d(self, raw: Dict) -> np.ndarray:
        """One-hot/thermometer 1D embedding [L,num_features_1d()]: electron
        configuration + signed-charge thermometer + hydrogen-count
        thermometer + hybridization one-hot (the reference's embedding
        branch, obutils.py:283-303, with econf derived by Aufbau filling
        instead of a data file)."""
        f1d = self.features_1d(raw)
        rows = []
        for z, q, nh, hyb in f1d:
            econf = electron_configuration(int(z))
            charge = np.zeros(2 * self.maxcharge, np.float32)
            q = int(np.clip(q, -self.maxcharge, self.maxcharge))
            if q < 0:
                charge[:abs(q)] = 1.0
            elif q > 0:
                charge[self.maxcharge:self.maxcharge + q] = 1.0
            hydr = np.zeros(self.maxhydr, np.float32)
            hydr[:min(int(nh), self.maxhydr)] = 1.0
            hybv = np.zeros(self.maxhyb + 1, np.float32)
            if hyb < self.maxhyb:
                hybv[hyb] = 1.0
            rows.append(np.concatenate([econf, charge, hydr, hybv]))
        return np.stack(rows) if rows else \
            np.zeros((0, self.num_features_1d()), np.float32)

    def reduce_hydrogens(self, raw: Dict, f1d: Optional[np.ndarray] = None,
                         f2d: Optional[np.ndarray] = None,
                         rng: Optional[np.random.Generator] = None) -> Dict:
        """Fold hydrogens onto their heavy atom (reference ReduceHydrogens,
        obutils.py:177-190 / 364-413):

        xyz [Lheavy, maxhydr+1, 3] (heavy atom then its hydrogens, NaN
        padded), f1d/f2d restricted to heavy rows, ijk [L,3] mapping
        (heavy index, slot, full index), observed [L] and heavy [L] masks.
        Hydrogen slot order is deterministic (graph order) unless an `rng`
        is passed — the reference shuffles unconditionally as a training
        augmentation."""
        names, elements, bonds, _, _, xyz_full = _mol_arrays(raw)
        n = len(names)
        adj = _adjacency(n, bonds)
        heavy_mask = np.asarray([e not in ("H", "D") for e in elements])
        heavy_idx = np.flatnonzero(heavy_mask)

        ijk = []
        xyz = np.full((len(heavy_idx), self.maxhydr + 1, 3), np.nan)
        observed = np.zeros(n, bool)
        for i, a in enumerate(heavy_idx):
            xyz[i, 0] = xyz_full[a]
            observed[a] = True
            ijk.append((i, 0, int(a)))
            hydr = [j for j in adj[a] if elements[j] in ("H", "D")]
            if rng is not None:
                rng.shuffle(hydr)
            for j, h in enumerate(hydr[:self.maxhydr]):
                xyz[i, j + 1] = xyz_full[h]
                observed[h] = True
                ijk.append((i, j + 1, int(h)))
        ijk.sort(key=lambda t: t[2])

        out = {"xyz": xyz, "ijk": np.asarray(ijk, np.int64).reshape(-1, 3),
               "observed": observed, "heavy": heavy_mask}
        if f1d is not None:
            out["f1d"] = f1d[heavy_mask]
        if f2d is not None:
            out["f2d"] = f2d[heavy_mask][:, heavy_mask]
        return out
