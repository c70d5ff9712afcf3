"""Evaluation-set preparation: dataset CSVs -> evaluation CSVs + PDB dirs.

Script equivalent of the reference's `evaluation/prepare_evaluation_sets.ipynb`
(the notebook that builds design_valid / design_test /
design_rna_monomer_test / design_pseudoknot_test / specificity_{valid,test}
from the curated dataset CSVs): exclusive-cluster subsetting, assembly-length
filtering, RNA-monomer / PPM subsetting, pseudoknot cluster expansion,
RNA-Solo path substitution, and structure conversion to per-entry PDB files.

Structure conversion uses this framework's parsers + PDB writers
(data/cif.py) in place of the reference's biotite load/save; entries that
fail to convert are dropped, like the notebook's bare try/except.

The port's own copy of the JAX package's ``eval/prepare_sets.py``, on rows:
where the JAX function takes or returns a ``pandas.DataFrame``, this one
takes and returns a list of row dicts (as ``csv.DictReader`` gives them),
and the CSVs are read and written with ``csv``.
"""
from __future__ import annotations

import ast
import glob
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..data.dataset import read_csv_rows, write_csv_rows

# The ten pseudoknot anchor structures the reference expands into the
# design_pseudoknot_test set (prepare_evaluation_sets.ipynb).
PSEUDOKNOT_PDB_IDS = ["7kd1", "3q3z", "4plx", "2m8k", "4oqu",
                      "7kga", "1drz", "7qr4", "2miy", "4znp"]


def read_cluster_ids_text_file(path: str) -> set:
    """One cluster id per line (reference na_eval_utils
    read_cluster_ids_text_file)."""
    with open(path) as f:
        return {line.strip() for line in f if line.strip()}


def _with_ids(rows, ids):
    """Copies of the rows whose id is in ``ids``, in order."""
    return [dict(r) for r in rows if r["id"] in ids]


def _all_in(cluster_ids: str, allowed: set) -> bool:
    return all(c in allowed for c in ast.literal_eval(cluster_ids))


def get_exclusive_cluster_subset(dataset_df, cluster_ids_column_name: str,
                                 dataset_cluster_ids: set):
    """Rows whose EVERY cluster id (a stringified list column) falls in the
    given split's cluster set — no cluster leakage across splits."""
    return [dict(r) for r in dataset_df
            if _all_in(r[cluster_ids_column_name], dataset_cluster_ids)]


def get_length_subset(dataset_df, max_length: int, min_length: int):
    """Rows where at least one assembly's macromolecule length is inside
    [min_length, max_length] (reads the preprocessed asmb_lengths .npy)."""
    valid = set()
    for row in dataset_df:
        lengths = np.load(row["asmb_lengths_path"], allow_pickle=True).item()
        for (macro_L, _p, _d, _r) in lengths.values():
            if min_length <= macro_L <= max_length:
                valid.add(row["id"])
                break
    return _with_ids(dataset_df, valid)


def _chain_type_counts(sequences_path: str) -> Dict[str, int]:
    counts = {"polypeptide(L)": 0, "polydeoxyribonucleotide": 0,
              "polyribonucleotide": 0,
              "polydeoxyribonucleotide/polyribonucleotide hybrid": 0}
    for row in read_csv_rows(sequences_path)[0]:
        if row["chain_type"] in counts:
            counts[row["chain_type"]] += 1
    return counts


def get_rna_monomer_subset(dataset_df):
    """Rows that are single-chain RNA (exactly one polyribonucleotide chain,
    nothing else; reads the preprocessed sequences CSVs)."""
    keep = set()
    for row in dataset_df:
        c = _chain_type_counts(row["sequences_path"])
        if (c["polyribonucleotide"] == 1 and c["polypeptide(L)"] == 0
                and c["polydeoxyribonucleotide"] == 0
                and c["polydeoxyribonucleotide/polyribonucleotide hybrid"] == 0):
            keep.add(row["id"])
    return _with_ids(dataset_df, keep)


def get_ppm_subset(dataset_df):
    """Rows with a non-empty ppm_paths list-string."""
    return [dict(r) for r in dataset_df
            if len(ast.literal_eval(r["ppm_paths"])) > 0]


def get_entries_in_same_clusters_as_specified_entries(
        dataset_df, entry_ids: Iterable[str], cluster_ids_column_name: str):
    """Expand a seed id list to every row whose clusters all fall in the
    seeds' cluster set (the pseudoknot-set construction)."""
    seed_clusters = set()
    for entry_id in entry_ids:
        rows = [r for r in dataset_df if r["id"] == entry_id]
        if len(rows) == 0:
            # Fail loudly like the reference notebook (iloc[0] on an empty
            # frame): a missing anchor must not silently shrink the set.
            raise KeyError(f"seed entry {entry_id!r} not in the dataset")
        seed_clusters.update(
            ast.literal_eval(rows[0][cluster_ids_column_name]))
    return get_exclusive_cluster_subset(dataset_df, cluster_ids_column_name,
                                        seed_clusters)


def get_polymer_type_statistics(dataset_df) -> Dict[str, int]:
    """Entry counts by polymer composition (DNA / RNA / hybrid x protein),
    from the *_chain_cluster_ids_chain_types columns."""
    kinds = {k: 0 for k in ["dna", "rna", "dna_rna_hybrid", "protein_dna",
                            "protein_rna", "protein_dna_rna_hybrid"]}
    DNA = "polydeoxyribonucleotide"
    RNA = "polyribonucleotide"
    HYB = "polydeoxyribonucleotide/polyribonucleotide hybrid"
    for row in dataset_df:
        na_types = ast.literal_eval(
            row["nucleic_acid_chain_cluster_ids_chain_types"])
        p_types = ast.literal_eval(
            row["protein_chain_cluster_ids_chain_types"])
        has_p, has_d = len(p_types) > 0, DNA in na_types
        has_r, has_h = RNA in na_types, HYB in na_types
        if has_p and has_d and not has_r and not has_h:
            kinds["protein_dna"] += 1
        elif has_p and has_r and not has_d and not has_h:
            kinds["protein_rna"] += 1
        elif has_p and has_h and not has_d and not has_r:
            kinds["protein_dna_rna_hybrid"] += 1
        elif has_d and not has_p and not has_r and not has_h:
            kinds["dna"] += 1
        elif has_r and not has_p and not has_d and not has_h:
            kinds["rna"] += 1
        elif has_h and not has_p and not has_d and not has_r:
            kinds["dna_rna_hybrid"] += 1
    kinds["total"] = len(dataset_df)
    return kinds


def get_ppm_statistics(dataset_df) -> Dict[str, int]:
    """Entry counts with PPMs, split crystal (rcsb_cif_na) vs distillation."""
    out = {"total": len(dataset_df), "ppm": 0, "ppm_from_crystal": 0,
           "ppm_from_distillation": 0}
    for row in dataset_df:
        if len(ast.literal_eval(row["ppm_paths"])) == 0:
            continue
        out["ppm"] += 1
        if row["dataset_name"] == "rcsb_cif_na":
            out["ppm_from_crystal"] += 1
        elif row["dataset_name"] in ("rf2na_distillation_cis_bp",
                                     "rf2na_distillation_transfac"):
            out["ppm_from_distillation"] += 1
    return out


def _rna_solo_id(path: str) -> str:
    basename = os.path.basename(path)
    if basename.startswith("PDB_0000"):
        return basename.split("PDB_0000")[1].split("_")[0].lower()
    return basename.split("_")[0].lower()


def load_rna_solo_paths(rfam_pdb_directory: str,
                        bgsu_pdb_directory: str) -> Dict[str, List[str]]:
    """{pdb_id: [pdb paths]} from the RFAM + BGSU RNA-Solo trees; RFAM
    preferred, except 1vc5/4znp where BGSU comes first (the reference flips
    those two because of broken RFAM files)."""
    def collect(directory):
        by_id: Dict[str, List[str]] = {}
        for p in sorted(glob.glob(os.path.join(directory, "*", "*.pdb"))):
            by_id.setdefault(_rna_solo_id(p), []).append(p)
        return by_id

    rfam, bgsu = collect(rfam_pdb_directory), collect(bgsu_pdb_directory)
    out: Dict[str, List[str]] = {}
    for pdb_id in set(rfam) | set(bgsu):
        first, second = (bgsu, rfam) if pdb_id in ("1vc5", "4znp") \
            else (rfam, bgsu)
        out[pdb_id] = first.get(pdb_id, []) + second.get(pdb_id, [])
    return out


def convert_structures(dataset_df, pdb_output_directory: str,
                       use_rna_solo: bool = False,
                       pdb_id_to_rna_solo_paths: Optional[Dict] = None):
    """Write each entry's structure as <id>.pdb under pdb_output_directory
    (parse with this framework's CIF/PDB parsers, write with the PDB-format
    save_all writer — the role biotite load/save plays in the notebook).
    Returns the subset rows with structure_path pointing at the copies
    plus original/copied bookkeeping columns; unconvertible entries drop."""
    from ..data.cif import make_parsers, save_all

    if use_rna_solo:
        assert pdb_id_to_rna_solo_paths is not None
    os.makedirs(pdb_output_directory, exist_ok=True)
    cif_parser, pdb_parser = make_parsers()

    converted, dest_paths, copied_paths = set(), {}, {}
    for row in dataset_df:
        if use_rna_solo:
            solo = pdb_id_to_rna_solo_paths.get(row["id"], [])
            if not solo:
                continue
            src = solo[0]
        else:
            src = row["structure_path"]
        dst = os.path.join(pdb_output_directory, f"{row['id']}.pdb")
        try:
            name = src[:-3] if src.endswith(".gz") else src
            parser = cif_parser if name.endswith(".cif") else pdb_parser
            chains, _asmb, covale, _meta = parser.parse(src)
            if not chains:
                raise ValueError("no chains parsed")
            save_all(chains, covale or [], dst)
        except Exception:  # noqa: BLE001 — skip-and-continue, like the notebook
            continue
        converted.add(row["id"])
        dest_paths[row["id"]] = dst
        copied_paths[row["id"]] = src

    out = _with_ids(dataset_df, converted)
    for r in out:
        r["original_structure_path"] = r["structure_path"]
        r["copied_structure_path"] = copied_paths[r["id"]]
        r["structure_path"] = dest_paths[r["id"]]
    return out


def _write_converted(path: str, rows, columns):
    """The converted rows as a CSV: the input's columns, then the two
    bookkeeping columns ``convert_structures`` adds."""
    write_csv_rows(path, rows, columns + ["original_structure_path",
                                          "copied_structure_path"])


def prepare_design_set(dataset_csv: str, cluster_ids_path: str,
                       pdb_output_directory: str, csv_output_path: str,
                       subset: str = "full",
                       max_length: int = 1000, min_length: int = 20,
                       rna_solo_paths: Optional[Dict] = None,
                       pseudoknot_ids: Sequence[str] = tuple(PSEUDOKNOT_PDB_IDS)):
    """One design evaluation set end-to-end (the notebook's per-set cells):
    subset = "full" | "rna_monomer" | "pseudoknot". RNA-monomer and
    pseudoknot sets substitute RNA-Solo structures when provided."""
    df, columns = read_csv_rows(dataset_csv)
    df = get_exclusive_cluster_subset(
        df, "nucleic_acid_chain_cluster_ids",
        read_cluster_ids_text_file(cluster_ids_path))
    if subset == "rna_monomer":
        df = get_rna_monomer_subset(df)
    elif subset == "pseudoknot":
        df = get_entries_in_same_clusters_as_specified_entries(
            df, pseudoknot_ids, "nucleic_acid_chain_cluster_ids")
    df = get_length_subset(df, max_length=max_length, min_length=min_length)
    df = convert_structures(
        df, pdb_output_directory,
        use_rna_solo=subset in ("rna_monomer", "pseudoknot")
        and rna_solo_paths is not None,
        pdb_id_to_rna_solo_paths=rna_solo_paths)
    _write_converted(csv_output_path, df, columns)
    return df


def prepare_specificity_set(dataset_csv: str, cluster_ids_path: str,
                            pdb_output_directory: str, csv_output_path: str,
                            max_length: int = 1000, min_length: int = 20):
    """One specificity evaluation set end-to-end: exclusive protein-cluster
    subset -> PPM subset -> length subset -> structure conversion."""
    df, columns = read_csv_rows(dataset_csv)
    df = get_exclusive_cluster_subset(
        df, "protein_chain_cluster_ids",
        read_cluster_ids_text_file(cluster_ids_path))
    df = get_ppm_subset(df)
    df = get_length_subset(df, max_length=max_length, min_length=min_length)
    df = convert_structures(df, pdb_output_directory)
    _write_converted(csv_output_path, df, columns)
    return df
