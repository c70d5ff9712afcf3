"""A minimal mmCIF reader and the training-side structure parsers (the
port's own copy of the JAX package's ``data/cif.py``):

* the first data block's categories as tables (``read_cif``);
  ``data/pdb.py::read_cif_atoms`` reads ``atom_site`` through it;
* polymer chains keyed by label_asym_id with entity-poly types, atoms keyed
  ``(chain_id, label_seq_id_str, res_name, atom_name)`` with xyz/occ
  (``CIFParser``, the ``Chain`` / ``Atom`` contract), and ``PDBParser`` for
  PDB files (chain type from residue names, identity assembly);
* biological assemblies ``{assembly_id: [(chain_id, xform4x4), ...]}`` from
  pdbx_struct_assembly_gen x pdbx_struct_oper_list, composite "(A)(B)"
  operator products included;
* NMR model selection (first model, or random with randomize_nmr_model) and
  metadata (method / deposition date / resolution);
* PDB-format writers of parsed chains (``save_chain``, ``save_all``).

``CIFParser(residue_library=...)`` takes a ``data/ligands.py::
ResidueLibrary`` (``ResidueLibrary.standard()`` is the packaged one) for
chem_comp-level detail of non-polymer residues: bonds, automorphisms,
leaving groups.
"""
from __future__ import annotations

import collections
import gzip
import itertools
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

Atom = collections.namedtuple("Atom", ["name", "xyz", "occ", "bfac"])
Chain = collections.namedtuple("Chain", ["id", "type", "atoms", "sequence"])


def _float_or(token: Optional[str], default: float) -> float:
    try:
        return float(token)
    except (TypeError, ValueError):
        return default


def _tokenize_line(line: str) -> List[str]:
    tokens = []
    i, n = 0, len(line)
    while i < n:
        ch = line[i]
        if ch in " \t":
            i += 1
            continue
        if ch == "#":
            break
        if ch in "'\"":
            j = i + 1
            while j < n:
                if line[j] == ch and (j + 1 >= n or line[j + 1] in " \t"):
                    break
                j += 1
            tokens.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            tokens.append(line[i:j])
            i = j
    return tokens


class CifTable:
    """A single category's rows as a list of dicts-by-index."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.index = {c: i for i, c in enumerate(columns)}
        self.rows: List[List[str]] = []

    def get(self, row: int, column: str, default: Optional[str] = None) -> Optional[str]:
        i = self.index.get(column)
        if i is None:
            return default
        return self.rows[row][i]

    def column(self, column: str) -> Optional[List[str]]:
        i = self.index.get(column)
        if i is None:
            return None
        return [r[i] for r in self.rows]

    def __len__(self):
        return len(self.rows)


def read_cif(path: str) -> Dict[str, CifTable]:
    """Parse the first data block of an mmCIF file into category tables."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.read().split("\n")

    tables: Dict[str, CifTable] = {}
    i, n = 0, len(lines)

    def read_value(i) -> Tuple[str, int]:
        """Read one (possibly multi-line ;-delimited) value starting at lines[i]."""
        if lines[i].startswith(";"):
            parts = [lines[i][1:]]
            i += 1
            while i < n and not lines[i].startswith(";"):
                parts.append(lines[i])
                i += 1
            return "\n".join(parts), i + 1
        toks = _tokenize_line(lines[i])
        return (toks[0] if toks else ""), i + 1

    while i < n:
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        if line.startswith("data_"):
            if tables:
                break  # only the first data block
            i += 1
            continue
        if line.startswith("loop_"):
            i += 1
            columns = []
            while i < n and lines[i].strip().startswith("_"):
                columns.append(lines[i].strip().split()[0])
                i += 1
            if not columns:
                continue
            category = columns[0].split(".")[0][1:]
            names = [c.split(".", 1)[1] if "." in c else c for c in columns]
            table = tables.setdefault(category, CifTable(names))
            ncol = len(names)
            buf: List[str] = []
            while i < n:
                s = lines[i]
                st = s.strip()
                if not st:
                    i += 1
                    continue
                if st.startswith(("loop_", "_", "#", "data_")) and not buf:
                    break
                if s.startswith(";"):
                    val, i = read_value(i)
                    buf.append(val)
                else:
                    buf.extend(_tokenize_line(s))
                    i += 1
                while len(buf) >= ncol:
                    table.rows.append(buf[:ncol])
                    buf = buf[ncol:]
            continue
        if line.startswith("_"):
            key = line.split()[0]
            category = key.split(".")[0][1:]
            name = key.split(".", 1)[1] if "." in key else key
            rest = line[len(key):].strip()
            if rest:
                val = _tokenize_line(rest)[0]
                i += 1
            else:
                val, i = read_value(i + 1)
            table = tables.get(category)
            if table is None or name not in table.index:
                if table is None:
                    table = tables[category] = CifTable([name])
                    table.rows.append([val])
                else:
                    for r in table.rows:
                        r.append(val)
                    table.columns.append(name)
                    table.index[name] = len(table.columns) - 1
            continue
        i += 1
    return tables


# ---------------------------------------------------------------------------
# Assembly parsing
# ---------------------------------------------------------------------------

def parse_operation_expression(expression: str) -> List[str]:
    """Expand one oper_expression group — '1-4' / '1,2,5' / 'P,X0' — into the
    list of operation ids (semantics of reference cifutils.py:296-313;
    ranges are numeric, other tokens are literal ids)."""
    out: List[str] = []
    for token in expression.strip("() ").split(","):
        token = token.strip()
        m = re.fullmatch(r"(\d+)-(\d+)", token)
        if m:
            lo, hi = int(m.group(1)), int(m.group(2))
            out += [str(v) for v in range(lo, hi + 1)]
        elif token:
            out.append(token)
    return out


def parse_assemblies(tables: Dict[str, CifTable]) -> Dict[str, List]:
    """{assembly_id: [(chain_id, xform[4,4]), ...]}
    (reference cifutils.py:316-377)."""
    gen = tables.get("pdbx_struct_assembly_gen")
    oper = tables.get("pdbx_struct_oper_list")
    if gen is None or oper is None or tables.get("pdbx_struct_assembly") is None:
        return {}

    opers = {}
    for k in range(len(oper)):
        m = np.eye(4)
        for a in range(3):
            m[a, 3] = float(oper.get(k, f"vector[{a+1}]"))
            for b in range(3):
                m[a, b] = float(oper.get(k, f"matrix[{a+1}][{b+1}]"))
        opers[oper.get(k, "id")] = m

    out: Dict[str, List] = {}
    for k in range(len(gen)):
        aid = gen.get(k, "assembly_id")
        expr = gen.get(k, "oper_expression")
        groups = [parse_operation_expression(e)
                  for e in re.split(r"\(|\)", expr) if e]
        chains = gen.get(k, "asym_id_list").split(",")
        # Composite operator product over every group: '(X0)(1-60)' etc.
        # The reference handles <=2 groups (cifutils.py:345-362); arbitrary
        # depth is the same left-to-right matrix product.
        xforms = [np.eye(4)]
        for group in groups:
            xforms = [x @ opers[o] for x in xforms for o in group]
        out.setdefault(aid, []).extend(itertools.product(chains, xforms))
    return out


# ---------------------------------------------------------------------------
# PDB-format writers (role of reference CIFParser.save / save_all,
# cifutils.py:821-880): ATOM/HETATM records per chain, CONECT records for
# covalent links, TER between chains.
# ---------------------------------------------------------------------------

def _guess_element(atom_name: str) -> str:
    for ch in atom_name:
        if ch.isalpha():
            return ch.upper()
    return "X"


def _write_chain_atoms(f, chain, chain_label, acount, a2i):
    hetero = "nonpoly" in chain.type
    for key, a in chain.atoms.items():
        if a.occ <= 0:
            continue
        _, num, res_name, atom_name = key
        try:
            resnum = int(num)
        except (TypeError, ValueError):
            resnum = 0
        f.write("%-6s%5d %-4s %3s%2s%4d    %8.3f%8.3f%8.3f%6.2f%6.2f"
                "          %2s\n" % (
                    "HETATM" if hetero else "ATOM", acount, atom_name[:4],
                    res_name[:3], chain_label[:2], resnum,
                    a.xyz[0], a.xyz[1], a.xyz[2], a.occ, a.bfac,
                    _guess_element(atom_name)))
        a2i[key] = acount
        acount += 1
    return acount


def save_chain(chain: "Chain", filename: str):
    """Write one chain as PDB-format records (reference CIFParser.save)."""
    with open(filename, "w") as f:
        _write_chain_atoms(f, chain, chain.id, 1, {})
        f.write("END\n")


def save_all(chains: Dict[str, "Chain"], covale, filename: str):
    """Write every chain + CONECT records for covalent links (reference
    CIFParser.save_all). `covale` is the parse() output: pairs of
    (chain_id, seq_num, res_name, atom_name) keys."""
    with open(filename, "w") as f:
        acount = 1
        a2i: Dict = {}
        for chain_id, chain in chains.items():
            acount = _write_chain_atoms(f, chain, chain_id, acount, a2i)
            f.write("TER\n")
        for key_a, key_b in covale:
            ia, ib = a2i.get(tuple(key_a)), a2i.get(tuple(key_b))
            if ia is not None and ib is not None:
                f.write("%-6s%5d%5d\n" % ("CONECT", ia, ib))
        f.write("END\n")


# ---------------------------------------------------------------------------
# Parsers with the reference Chain contract
# ---------------------------------------------------------------------------

class CIFParser:
    """mmCIF -> (chains, asmb, covale, meta); training-side parser
    (role of reference cifutils.CIFParser.parse, cifutils.py:380-817)."""

    POLYMER_TYPES = {
        "polypeptide(L)", "polydeoxyribonucleotide", "polyribonucleotide",
        "polydeoxyribonucleotide/polyribonucleotide hybrid",
    }

    def __init__(self, skip_res=(), randomize_nmr_model=False, rng=None,
                 residue_library=None):
        self.skip_res = set(skip_res)
        self.randomize_nmr_model = randomize_nmr_model
        self._rng = rng  # None -> np.random (kept picklable for loader workers)
        # Optional ligands.ResidueLibrary giving chem_comp-level detail
        # (bonds, automorphisms, leaving groups) for non-polymer residues.
        self.library = residue_library

    def ligand_residues(self, chains) -> Dict:
        """{(chain_id, seq_num, res_name): LigandResidue} for every
        non-polymer residue with a library entry."""
        if self.library is None:
            return {}
        out = {}
        for chid, chain in chains.items():
            if chain.type != "nonpoly":
                continue
            seen = set()
            for (cid, num, res_name, _atom) in chain.atoms:
                if (num, res_name) in seen:
                    continue
                seen.add((num, res_name))
                entry = self.library.get(res_name)
                if entry is not None:
                    out[(chid, num, res_name)] = entry
        return out

    @property
    def rng(self):
        return self._rng if self._rng is not None else np.random

    def parse(self, filename: str):
        tables = read_cif(filename)
        atom_site = tables["atom_site"]

        # entity -> polymer type
        entity_type: Dict[str, str] = {}
        ep = tables.get("entity_poly")
        entity_seq: Dict[str, str] = {}
        if ep is not None:
            for k in range(len(ep)):
                eid = ep.get(k, "entity_id")
                entity_type[eid] = ep.get(k, "type")
                seq = ep.get(k, "pdbx_seq_one_letter_code_can", "")
                entity_seq[eid] = (seq or "").replace("\n", "")

        # label_asym_id -> entity_id (polymer chains)
        chain_entity: Dict[str, str] = {}
        pss = tables.get("pdbx_poly_seq_scheme")
        if pss is not None:
            for k in range(len(pss)):
                chain_entity[pss.get(k, "asym_id")] = pss.get(k, "entity_id")

        # NMR model selection
        col = atom_site.column("pdbx_PDB_model_num")
        model_to_load = None
        if col is not None:
            last = col[-1]
            if last.isnumeric() and int(last) > 1:
                exptl = tables.get("exptl")
                method = exptl.get(0, "method", "") if exptl is not None else ""
                if self.randomize_nmr_model and "NMR" in (method or ""):
                    model_to_load = str(self.rng.randint(int(last)) + 1)
                else:
                    model_to_load = col[0]

        get = atom_site.index.get
        cols = {k: get(v) for k, v in [
            ("group", "group_PDB"), ("symbol", "type_symbol"),
            ("atm", "label_atom_id"), ("res", "label_comp_id"),
            ("chid", "label_asym_id"), ("num", "label_seq_id"),
            ("num_auth", "auth_seq_id"), ("alt", "label_alt_id"),
            ("x", "Cartn_x"), ("y", "Cartn_y"), ("z", "Cartn_z"),
            ("occ", "occupancy"), ("bfac", "B_iso_or_equiv"),
            ("model", "pdbx_PDB_model_num"),
        ]}

        chain_atoms: Dict[str, Dict] = {}
        chain_res_names: Dict[str, Dict[str, str]] = {}
        for row in atom_site.rows:
            if cols["model"] is not None and model_to_load is not None \
                    and row[cols["model"]] != model_to_load:
                continue
            symbol = row[cols["symbol"]] if cols["symbol"] is not None else ""
            if symbol in ("H", "D"):
                continue
            res_name = row[cols["res"]]
            if res_name in self.skip_res:
                continue
            chid = row[cols["chid"]]
            num = row[cols["num"]]
            if chid in chain_entity:
                if num == ".":
                    continue  # mis-assigned ligand on a polymer chain
            else:
                num = row[cols["num_auth"]]
            alt = row[cols["alt"]] if cols["alt"] is not None else "."
            if alt not in (".", "?", "A", ""):
                continue
            # occupancy / B-factor may be '?' or '.' in real entries
            occ = _float_or(row[cols["occ"]], 1.0) \
                if cols["occ"] is not None else 1.0
            bfac = _float_or(row[cols["bfac"]], 0.0) \
                if cols["bfac"] is not None else 0.0
            atom_name = row[cols["atm"]].strip('"')
            key = (chid, num, res_name, atom_name)
            atoms = chain_atoms.setdefault(chid, {})
            prev = atoms.get(key)
            if prev is None or occ > prev.occ:
                atoms[key] = Atom(
                    name=key,
                    xyz=[float(row[cols["x"]]), float(row[cols["y"]]),
                         float(row[cols["z"]])],
                    occ=occ, bfac=bfac)
            chain_res_names.setdefault(chid, {})[num] = res_name

        chains: Dict[str, Chain] = {}
        for chid, atoms in chain_atoms.items():
            eid = chain_entity.get(chid)
            ctype = entity_type.get(eid, "nonpoly") if eid else "nonpoly"
            chains[chid] = Chain(id=chid, type=ctype, atoms=atoms,
                                 sequence=entity_seq.get(eid))

        asmb = parse_assemblies(tables)
        asmb = {k: [vi for vi in v if vi[0] in chains]
                for k, v in asmb.items()}
        if not asmb:
            asmb = {"1": [(c, np.eye(4)) for c in chains]}

        covale = []
        sc = tables.get("struct_conn")
        if sc is not None:
            for k in range(len(sc)):
                if sc.get(k, "conn_type_id") != "covale":
                    continue
                covale.append((
                    (sc.get(k, "ptnr1_label_asym_id"), sc.get(k, "ptnr1_label_seq_id"),
                     sc.get(k, "ptnr1_label_comp_id"), sc.get(k, "ptnr1_label_atom_id")),
                    (sc.get(k, "ptnr2_label_asym_id"), sc.get(k, "ptnr2_label_seq_id"),
                     sc.get(k, "ptnr2_label_comp_id"), sc.get(k, "ptnr2_label_atom_id")),
                ))

        res = None
        refine = tables.get("refine")
        if refine is not None:
            try:
                res = float(refine.get(0, "ls_d_res_high"))
            except (TypeError, ValueError):
                res = None
        if res is None and tables.get("em_3d_reconstruction") is not None:
            try:
                res = float(tables["em_3d_reconstruction"].get(0, "resolution"))
            except (TypeError, ValueError):
                res = None
        exptl = tables.get("exptl")
        status = tables.get("pdbx_database_status")
        meta = {
            "method": (exptl.get(0, "method", "") or "").replace(" ", "_")
            if exptl is not None else "",
            "date": status.get(0, "recvd_initial_deposition_date", "")
            if status is not None else "",
            "resolution": res,
        }
        return chains, asmb, covale, meta


class PDBParser:
    """Training-side PDB parser with the reference Chain contract
    (role of reference pdbutils.PDBParser, pdbutils.py:25-222):
    chain type inferred from residue names; identity assembly."""

    def parse(self, filename: str):
        from .pdb import read_pdb_atoms
        from .. import constants

        raw = read_pdb_atoms(filename)
        chains: Dict[str, Chain] = {}
        by_chain: Dict[str, List] = {}
        for a in raw:
            by_chain.setdefault(a.chain, []).append(a)

        for letter, atoms in by_chain.items():
            resnames = {a.resname for a in atoms}
            is_p = any(r in constants.PROTEIN_RESTYPES for r in resnames)
            is_d = any(r in constants.DNA_RESTYPES for r in resnames)
            is_r = any(r in constants.RNA_RESTYPES for r in resnames)
            if is_p and not is_d and not is_r:
                ctype = "polypeptide(L)"
            elif not is_p and is_d and not is_r:
                ctype = "polydeoxyribonucleotide"
            elif not is_p and not is_d and is_r:
                ctype = "polyribonucleotide"
            elif not is_p and is_d and is_r:
                ctype = "polydeoxyribonucleotide/polyribonucleotide hybrid"
            else:
                raise ValueError(
                    "Chain has a combination of residue types not supported.")

            atom_dict = {}
            seq_by_res: Dict[str, str] = {}
            for a in atoms:
                key = (letter, str(a.resnum), a.resname, a.name)
                atom_dict[key] = Atom(name=key, xyz=list(a.xyz), occ=a.occupancy,
                                      bfac=a.bfactor)
                seq_by_res.setdefault(str(a.resnum), a.resname)
            # crude 1-letter sequence (non-polymer-unique mapping, as in
            # pdbutils.py:103-137) — used only for clustering CSVs.
            seq_chars = []
            for rn in seq_by_res.values():
                one = constants.RESTYPE_3_TO_1.get(rn, "X").upper()
                seq_chars.append(one if one.isalpha() or one in "-+" else "X")
            chains[letter] = Chain(id=letter, type=ctype, atoms=atom_dict,
                                   sequence="".join(seq_chars))

        asmb = {"1": [(letter, np.eye(4)) for letter in chains]}
        return chains, asmb, None, None


def make_parsers(skip_res=(), randomize_nmr_model=False):
    return (CIFParser(skip_res=skip_res, randomize_nmr_model=randomize_nmr_model),
            PDBParser())
