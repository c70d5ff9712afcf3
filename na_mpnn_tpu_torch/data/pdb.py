"""PDB and mmCIF structure parsing for inference (the port's own copy of
the JAX package's ``data/pdb.py`` on its pure-Python readers).

* residues are those with a CA (protein resnames) or C1' (nucleic resnames)
  atom, in file order;
* coordinates go into a 65-atom table (``xyz_65``) and the 16-atom backbone
  frame (``X``);
* polymer masks derive from backbone-atom completeness (RNA subtracted from
  DNA, since RNA has every DNA backbone atom);
* ``rna_mask_for_token_conversion`` marks residues with an O2' atom;
* non-polymer heavy atoms become ligand context (Y / Y_t / Y_m).

PDB records are read by the native (C++) tokenizer,
``native/na_parse.cc`` through ``data/native_loader.py``, where its library
builds; the pure-Python reader here is its semantic reference and serves
where it does not. mmCIF inputs (``.cif``, ``.mmcif``, gzipped or not) are
read from their ``atom_site`` table with the same filtering as PDB records.
"""
from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import constants

# Residue-name classification: the same sets as the JAX package's
# data/pdb.py (a reconstruction of ProDy's protein / nucleic / water
# flags). Residues outside them (e.g. HYP, PSU, 5MC) are not polymer
# residues at inference: their heavy atoms become ligand context.
PROTEIN_RESNAMES = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    # ProDy nonstdAA
    "ASX", "GLX", "CSO", "HIP", "HSD", "HSE", "HSP", "MSE", "SEC", "SEP",
    "TPO", "PTR", "XLE", "XAA", "UNK", "PYL",
}
NUCLEIC_RESNAMES = {
    # nucleotides / deoxynucleotides
    "DA", "DC", "DG", "DT", "DU", "DI", "A", "C", "G", "T", "U", "I",
    # nucleobases
    "GUN", "ADE", "CYT", "THY", "URA",
    # nucleoside phosphates
    "AMP", "ADP", "ATP", "CMP", "CDP", "CTP", "GMP", "GDP", "GTP",
    "TMP", "TDP", "TTP", "UMP", "UDP", "UTP",
}
WATER_RESNAMES = {"HOH", "DOD", "WAT", "TIP", "TIP2", "TIP3", "TIP4", "H2O",
                  "OH2"}


@dataclasses.dataclass
class PDBAtom:
    record: str
    serial: int
    name: str
    altloc: str
    resname: str
    chain: str
    resnum: int
    icode: str
    xyz: np.ndarray
    occupancy: float
    bfactor: float
    element: str
    line: str


def _parse_atom_line(line: str) -> Optional[PDBAtom]:
    try:
        name = line[12:16].strip()
        altloc = line[16]
        resname = line[17:20].strip()
        chain = line[21]
        resnum = int(line[22:26])
        icode = line[26].strip()
        xyz = np.array([float(line[30:38]), float(line[38:46]), float(line[46:54])],
                       dtype=np.float32)
        occ_str = line[54:60].strip()
        occ = float(occ_str) if occ_str else 1.0
        bf_str = line[60:66].strip()
        bf = float(bf_str) if bf_str else 0.0
        element = line[76:78].strip().upper() if len(line) >= 78 else ""
        if not element:
            # Fall back on the atom-name convention: first alpha character.
            for ch in line[12:16]:
                if ch.isalpha():
                    element = ch.upper()
                    break
        serial_str = line[6:11].strip()
        serial = int(serial_str) if serial_str else 0
        return PDBAtom(line[:6].strip(), serial, name, altloc, resname, chain,
                       resnum, icode, xyz, occ, bf, element, line.rstrip("\n"))
    except (ValueError, IndexError):
        return None


def read_pdb_atoms(path: str, first_model_only: bool = True,
                   use_native: bool = True) -> List[PDBAtom]:
    """Read ATOM/HETATM records (altloc ' ' or 'A', occupancy > 0), of the
    first model only unless ``first_model_only`` is false.

    With ``use_native`` the native tokenizer reads them where its library
    builds (``PDBAtom.line`` is then empty); the pure-Python reader below is
    its semantic reference and the fallback, also where the native reader
    raises on a file (one it cannot open, or a non-ASCII byte in a text
    column), so that such a file reads, or fails, as the Python reader
    has it."""
    if use_native:
        from .native_loader import native_available, read_pdb_atoms_native
        if native_available():
            try:
                return read_pdb_atoms_native(path, first_model_only)
            except (OSError, ValueError):
                pass
    opener = gzip.open if path.endswith(".gz") else open
    atoms = []
    with opener(path, "rt") as f:
        for line in f:
            rec = line[:6]
            if rec.startswith("ENDMDL") and first_model_only and atoms:
                break
            if not (rec.startswith("ATOM") or rec.startswith("HETATM")):
                continue
            a = _parse_atom_line(line)
            if a is None:
                continue
            if a.altloc not in (" ", "A"):
                continue
            if a.occupancy <= 0:
                continue
            atoms.append(a)
    return atoms


def read_cif_atoms(path: str, first_model_only: bool = True) -> List[PDBAtom]:
    """ATOM/HETATM records from an mmCIF ``atom_site`` table, filtered as
    ``read_pdb_atoms`` filters (altloc ' '/'A', occupancy > 0, first model
    only). Author numbering and chain IDs win over the label scheme; a null
    token ('.' or '?') falls back to the other scheme."""
    from .cif import _float_or, read_cif

    tables = read_cif(path)
    if "atom_site" not in tables:
        raise ValueError(f"{path}: no atom_site category — not a structure "
                         "mmCIF (chemical-component or truncated file?)")
    at = tables["atom_site"]
    g = at.index.get
    cols = {k: g(v) for k, v in [
        ("group", "group_PDB"), ("symbol", "type_symbol"),
        ("atm", "label_atom_id"), ("res", "label_comp_id"),
        ("chain_auth", "auth_asym_id"), ("chain", "label_asym_id"),
        ("num_auth", "auth_seq_id"), ("num", "label_seq_id"),
        ("icode", "pdbx_PDB_ins_code"), ("alt", "label_alt_id"),
        ("x", "Cartn_x"), ("y", "Cartn_y"), ("z", "Cartn_z"),
        ("occ", "occupancy"), ("bfac", "B_iso_or_equiv"),
        ("model", "pdbx_PDB_model_num"),
    ]}

    def field(row, key, default=""):
        return row[cols[key]] if cols[key] is not None else default

    def token(row, key):
        """The field, with the null markers '.' and '?' read as ''."""
        v = field(row, key)
        return "" if v in (".", "?") else v

    atoms: List[PDBAtom] = []
    first_model = None
    for row in at.rows:
        if cols["model"] is not None:
            m = row[cols["model"]]
            if first_model is None:
                first_model = m
            elif first_model_only and m != first_model:
                break  # models are contiguous, like ENDMDL in PDB files
        alt = field(row, "alt", ".")
        if alt not in (".", "?", "", "A"):
            continue
        occ = _float_or(field(row, "occ", None), 1.0)
        if occ <= 0:
            continue
        num = token(row, "num_auth") or token(row, "num")
        try:
            resnum = int(num)
        except (TypeError, ValueError):
            continue  # no usable numbering in either scheme
        name = field(row, "atm").strip('"')
        icode = token(row, "icode")
        element = token(row, "symbol").upper()
        if not element:
            element = next((c.upper() for c in name if c.isalpha()), "")
        try:
            xyz = np.array([float(field(row, "x")), float(field(row, "y")),
                            float(field(row, "z"))], dtype=np.float32)
        except (TypeError, ValueError):
            continue
        atoms.append(PDBAtom(
            field(row, "group", "ATOM"), len(atoms) + 1, name,
            "A" if alt == "A" else " ", field(row, "res"),
            token(row, "chain_auth") or token(row, "chain") or "A",
            resnum, icode,
            xyz, occ, _float_or(field(row, "bfac", None), 0.0), element, ""))
    return atoms


def _res_key(a: PDBAtom) -> Tuple[str, int, str]:
    return (a.chain, a.resnum, a.icode)


def parse_pdb(
    input_path: str,
    chains: Optional[List[str]] = None,
    parse_na_only: bool = False,
    na_shared_tokens: bool = True,
    load_residues_with_missing_atoms: bool = False,
) -> Dict:
    """Parse a PDB (or, by its extension, an mmCIF file) into the inference
    feature contract.

    Returns a dict of numpy arrays mirroring the reference parse_PDB output
    (reference inference/data_utils.py:360-405) plus the raw backbone /
    ligand atom records for the PDB writer.
    """
    low = input_path.lower()
    if low.endswith((".cif", ".cif.gz", ".mmcif", ".mmcif.gz")):
        atoms = read_cif_atoms(input_path)
    else:
        atoms = read_pdb_atoms(input_path)
    # Chain indices enumerate chains by first appearance in the FULL file —
    # they keep their values under chain subsetting, as ProDy chindices do
    # (the reference's chain_labels are getChindices of a selection).
    chain_to_idx: Dict[str, int] = {}
    for a in atoms:
        if a.chain not in chain_to_idx:
            chain_to_idx[a.chain] = len(chain_to_idx)
    if chains:
        atoms = [a for a in atoms if a.chain in chains]

    def is_protein(a): return a.resname in PROTEIN_RESNAMES
    def is_nucleic(a): return a.resname in NUCLEIC_RESNAMES
    def is_water(a): return a.resname in WATER_RESNAMES

    if parse_na_only:
        atoms = [a for a in atoms if is_nucleic(a)]

    macro_atoms = [a for a in atoms if is_protein(a) or is_nucleic(a)]
    other_atoms = [a for a in atoms
                   if not (is_protein(a) or is_nucleic(a) or is_water(a))]
    water_atoms = [a for a in atoms if is_water(a)]

    # Residue list: reference atoms (CA for protein, C1' for nucleic) in file
    # order define the residue index space.
    ref_keys: List[Tuple[str, int, str]] = []
    ref_meta = []  # (chain, resnum, icode, resname)
    seen = set()
    for a in macro_atoms:
        if (is_protein(a) and a.name == "CA") or (is_nucleic(a) and a.name == "C1'"):
            k = _res_key(a)
            if k in seen:
                continue
            seen.add(k)
            ref_keys.append(k)
            ref_meta.append((a.chain, a.resnum, a.icode, a.resname))
    ref_index = {k: i for i, k in enumerate(ref_keys)}
    L = len(ref_keys)
    if L == 0:
        raise ValueError(f"{input_path}: no protein/nucleic residues found")

    # Inference parses the backbone only: the 65-wide table holds the 16-atom
    # backbone ordering in its leading columns, as the reference's
    # backbone-mode atom_order does (inference/data_utils.py:154-165).
    atom_order = {a: i for i, a in enumerate(constants.BACKBONE_ATOMS)}
    xyz_65 = np.zeros([L, constants.NUM_ALL_ATOMS, 3], np.float32)
    xyz_65_m = np.zeros([L, constants.NUM_ALL_ATOMS], np.int32)
    backbone_atoms: List[List[PDBAtom]] = [[] for _ in range(L)]
    bb_names = set(constants.BACKBONE_ATOMS)
    for a in macro_atoms:
        i = ref_index.get(_res_key(a))
        if i is None:
            continue
        j = atom_order.get(a.name)
        if j is not None:
            xyz_65[i, j] = a.xyz
            xyz_65_m[i, j] = 1
        if a.name in bb_names and ((is_protein(a) and a.name in constants.PROTEIN_BACKBONE_ATOMS)
                                   or (is_nucleic(a) and a.name in constants.RNA_BACKBONE_ATOMS)):
            backbone_atoms[i].append(a)

    bb_idx = [atom_order[a] for a in constants.BACKBONE_ATOMS]
    X = xyz_65[:, bb_idx]
    X_m = xyz_65_m[:, bb_idx]

    chain_letters = [m[0] for m in ref_meta]
    resnums = np.array([m[1] for m in ref_meta], np.int32)
    icodes = [m[2] for m in ref_meta]
    resnames = [m[3] for m in ref_meta]

    chain_labels = np.array([chain_to_idx[c] for c in chain_letters], np.int32)

    protein_bb65 = [atom_order[a] for a in constants.PROTEIN_BACKBONE_ATOMS]
    dna_bb65 = [atom_order[a] for a in constants.DNA_BACKBONE_ATOMS]
    rna_bb65 = [atom_order[a] for a in constants.RNA_BACKBONE_ATOMS]

    if load_residues_with_missing_atoms:
        protein_mask = np.array([r in constants.PROTEIN_RESTYPES for r in resnames], np.int32)
        dna_mask = np.array([r in constants.DNA_RESTYPES for r in resnames], np.int32)
        rna_mask = np.array([r in constants.RNA_RESTYPES for r in resnames], np.int32)
    else:
        protein_mask = np.prod(xyz_65_m[:, protein_bb65], axis=-1).astype(np.int32)
        rna_mask = np.prod(xyz_65_m[:, rna_bb65], axis=-1).astype(np.int32)
        # RNA has every DNA backbone atom, so subtract (reference
        # inference/data_utils.py:314-318).
        dna_mask = (np.prod(xyz_65_m[:, dna_bb65], axis=-1).astype(np.int32) - rna_mask)

    rna_mask_for_token_conversion = xyz_65_m[:, atom_order["O2'"]].astype(np.int32)
    mask = protein_mask + dna_mask + rna_mask

    pt = constants.POLYTYPE_TO_INT
    R_polymer_type = (protein_mask * pt["PP"] + dna_mask * pt["DNA"]
                      + rna_mask * pt["RNA"]
                      + (1 - protein_mask - dna_mask - rna_mask) * pt["UNK"]).astype(np.int64)

    table = constants.restype_to_int_table(na_shared_tokens)
    S = np.zeros(L, np.int32)
    for i, rn in enumerate(resnames):
        if protein_mask[i] == 1:
            unk = "UNK"
        elif dna_mask[i] == 1:
            unk = "DX"
        elif rna_mask[i] == 1:
            unk = "RX"
        else:
            unk = "UNK"
        S[i] = table.get(rn, table[unk])

    # Ligand / context atoms: non-polymer, non-water heavy atoms.
    if other_atoms:
        Y = np.stack([a.xyz for a in other_atoms]).astype(np.float32)
        Y_t = np.array([constants.ELEMENT_DICT.get(a.element, 0) for a in other_atoms],
                       np.int32)
        keep = (Y_t != 1) & (Y_t != 0)
        Y, Y_t = Y[keep], Y_t[keep]
        Y_m = np.ones_like(Y_t)
        other_atoms = [a for a, k in zip(other_atoms, keep) if k]
        if Y.shape[0] == 0:
            Y = np.zeros([1, 3], np.float32)
            Y_t = np.zeros([1], np.int32)
            Y_m = np.zeros([1], np.int32)
    else:
        Y = np.zeros([1, 3], np.float32)
        Y_t = np.zeros([1], np.int32)
        Y_m = np.zeros([1], np.int32)

    na_chain_letters = [chain_letters[i] for i in range(L)
                        if dna_mask[i] or rna_mask[i]]

    chain_list = sorted(set(chain_letters))
    mask_c = [np.array([c == cl for cl in chain_letters], bool) for c in chain_list]

    return {
        "X": X, "X_m": X_m, "mask": mask,
        "Y": Y, "Y_t": Y_t, "Y_m": Y_m,
        "R_idx": resnums, "chain_labels": chain_labels,
        "chain_letters": chain_letters, "na_chain_letters": na_chain_letters,
        "protein_mask": protein_mask, "dna_mask": dna_mask, "rna_mask": rna_mask,
        "rna_mask_for_token_conversion": rna_mask_for_token_conversion,
        "R_polymer_type": R_polymer_type, "S": S,
        "xyz_65": xyz_65, "xyz_65_m": xyz_65_m,
        "mask_c": mask_c, "chain_list": chain_list,
        "icodes": icodes, "resnames": resnames,
        "backbone_atoms": backbone_atoms, "other_atoms": other_atoms,
        "water_atoms": water_atoms,
    }


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _format_atom_line(a: PDBAtom, resname: str, bfactor: float, serial: int) -> str:
    name = a.name
    if len(name) < 4 and len(a.element) < 2:
        name = " " + name
    # PDB format has a single chain column; multi-char mmCIF chain IDs are
    # truncated to their first character here (the FASTA/npz outputs keep
    # the full ID).
    return (f"{a.record:<6}{serial:>5} {name:<4}{a.altloc if a.altloc != ' ' else ' '}"
            f"{resname:>3} {(a.chain + ' ')[:1]}{a.resnum:>4}{a.icode if a.icode else ' '}   "
            f"{a.xyz[0]:8.3f}{a.xyz[1]:8.3f}{a.xyz[2]:8.3f}{a.occupancy:6.2f}"
            f"{bfactor:6.2f}          {a.element:>2}")


# ``_format_atom_line`` for every atom of a structure in one ``%``: the
# same fields and widths (``%-6s`` is ``:<6``, ``%4s`` ``:>4``, ``%8.3f``
# ``:8.3f``), the residue name and the B-factor passed as strings.
_ATOM_LINE = "%-6s%5d %-4s%s%3s %s%4s%s   %8.3f%8.3f%8.3f%6.2f%6s          %2s\n"
_NAME_SLOT, _BF_SLOT = "\x01" * 3, "\x02" * 6


def _atom_lines(atoms, first_serial, resnames, bfactors) -> str:
    """The lines of ``atoms`` (serials from ``first_serial``), atom ``j``
    named ``resnames[j]`` with the B-factor string ``bfactors[j]``."""
    # flat floats: a list a row would hand the garbage collector a
    # thousand containers a structure (a collection more a request)
    xyz = np.asarray([a.xyz for a in atoms]).reshape(-1).tolist()
    fields = []
    for j, a in enumerate(atoms):
        name = a.name
        if len(name) < 4 and len(a.element) < 2:
            name = " " + name
        fields += (a.record, first_serial + j, name, a.altloc, resnames[j],
                   (a.chain + " ")[:1], a.resnum, a.icode if a.icode else " ",
                   xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2], a.occupancy,
                   bfactors[j], a.element)
    return (_ATOM_LINE * len(atoms)) % tuple(fields)


def _per_atom_text(parsed: Dict, new_resnames: List[str], bfactors) -> str:
    lines = []
    serial = 1
    for i, res_atoms in enumerate(parsed["backbone_atoms"]):
        for a in res_atoms:
            lines.append(_format_atom_line(a, new_resnames[i], float(bfactors[i]), serial))
            serial += 1
    for a in parsed["other_atoms"]:
        lines.append(_format_atom_line(a, a.resname, 0.0, serial))
        serial += 1
    lines.append("TER")
    lines.append("END")
    return "\n".join(lines) + "\n"


class BackboneTemplate:
    """The backbone PDB of one parsed structure with two columns left open
    on each backbone atom line: the residue name (``:>3``) and the B-factor
    (``:6.2f``), the only ones that differ between the samples of a
    structure. Every other column, and the context atoms (``other_atoms``,
    their own residue names, B-factor 0.00) with ``TER`` and ``END``, is
    formatted once here, in one pass over the atoms; ``render`` formats a
    sample's names and B-factors once per residue and writes them into a
    copy of the template's bytes at their offsets.

    Where a sample's name or B-factor is wider than its column, or a field
    of the structure is not ASCII or holds the template's marker bytes
    (``_NAME_SLOT``, ``_BF_SLOT``), ``render`` formats every line as
    ``_format_atom_line`` does. Either way the text is the per-atom
    writer's."""

    def __init__(self, parsed: Dict):
        self.parsed = parsed
        self.n_res = len(parsed["backbone_atoms"])
        atoms = [a for res in parsed["backbone_atoms"] for a in res]
        line_res = np.repeat(np.arange(self.n_res),
                             [len(res) for res in parsed["backbone_atoms"]])
        others = parsed["other_atoms"]
        n = len(atoms)
        text = (_atom_lines(atoms, 1, [_NAME_SLOT] * n, [_BF_SLOT] * n)
                + _atom_lines(others, n + 1, [a.resname for a in others],
                              [f"{0.0:6.2f}"] * len(others))
                + "TER\nEND\n")
        self._bytes = None
        if text.isascii():
            buf = np.frombuffer(text.encode("ascii"), np.uint8)
            name_at, bf_at = np.flatnonzero(buf == 1), np.flatnonzero(buf == 2)
            if name_at.size == 3 * n and bf_at.size == 6 * n:    # no field holds a marker
                self._bytes = buf
                self._name_at, self._bf_at = name_at, bf_at
                self._name_from = (3 * line_res[:, None] + np.arange(3)).ravel()
                self._bf_from = (6 * line_res[:, None] + np.arange(6)).ravel()

    def render(self, new_resnames: List[str], bfactors) -> str:
        """The file's text with residue ``i`` named ``new_resnames[i]`` and
        given the B-factor ``bfactors[i]`` on each of its atom lines."""
        n = self.n_res
        if self._bytes is not None:
            names = ("%3s" * n) % tuple(new_resnames[:n])
            bfs = ("%6.2f" * n) % tuple(np.asarray(bfactors)[:n].tolist())
            if names.isascii() and len(names) == 3 * n and len(bfs) == 6 * n:
                out = self._bytes.copy()
                out[self._name_at] = np.frombuffer(names.encode("ascii"),
                                                   np.uint8)[self._name_from]
                out[self._bf_at] = np.frombuffer(bfs.encode("ascii"),
                                                 np.uint8)[self._bf_from]
                return out.tobytes().decode("ascii")
        return _per_atom_text(self.parsed, new_resnames, bfactors)

    def write(self, path: str, new_resnames: List[str], bfactors):
        with open(path, "w") as f:
            f.write(self.render(new_resnames, bfactors))


def write_backbone_pdb(path: str, parsed: Dict, new_resnames: List[str],
                       bfactors: np.ndarray):
    """Write the backbone with redesigned residue names and per-residue
    confidence B-factors, then the ligand context atoms (reference
    inference/run.py:475-491). For many samples of one structure, build
    its ``BackboneTemplate`` once and ``write`` each."""
    BackboneTemplate(parsed).write(path, new_resnames, bfactors)
