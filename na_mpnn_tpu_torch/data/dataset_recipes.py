"""Per-source dataset CSV recipes.

Script-form port of the reference's make_dataset_csv notebooks
(reference data/datasets/{rcsb_cif_na,rf2na_distillation_cis_bp,
rf2na_distillation_transfac}/make_dataset_csv.ipynb). Each recipe turns a
source-specific inventory into the common training-CSV contract:

    preprocessing_input.csv:  id, structure_path, date, dataset_name [, keys]
    preprocessing_output.csv: + per-attribute *_path columns pointing at the
        offline preprocessor's side files, + ppm_paths (list of experimental
        PPM CSVs per structure)

plus the PPM-library converters for the four public motif formats the
reference consumes (JASPAR PCMs, HOCOMOCO v11 PCMs, cis-BP PPM text files,
TRANSFAC matrix.dat).

The port's own copy of the JAX package's ``data/dataset_recipes.py``, on
rows: where the JAX function takes or returns a ``pandas.DataFrame``, this
one takes and returns a list of row dicts (as ``csv.DictReader`` gives
them; numeric fields may be strings, empty for a missing value), and the
CSVs are read and written with ``csv``.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .dataset import read_csv_rows, write_csv_rows

NA_TYPES = ("polydeoxyribonucleotide/polyribonucleotide hybrid",
            "polydeoxyribonucleotide", "polyribonucleotide")
BASES = ["A", "C", "G", "T"]


# ---------------------------------------------------------------------------
# PPM-library converters (reference load_ppm_from_raw_pcm / load_raw_ppm /
# preprocess_ppms cells). All return [L, 4] float64 arrays in ACGT order,
# rows normalized to 1.
# ---------------------------------------------------------------------------

def _normalize_counts(counts: np.ndarray) -> np.ndarray:
    counts = np.asarray(counts, np.float64)
    s = counts.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    return counts / s


def load_ppm_jaspar(text: str) -> np.ndarray:
    """JASPAR PCM: '>MA0004.1 NAME' header then per-base rows
    'A  [ 4 19 0 ... ]'."""
    rows = {}
    for line in text.strip().splitlines():
        line = line.strip()
        if not line or line.startswith(">"):
            continue
        base = line[0].upper()
        body = line[1:].replace("[", " ").replace("]", " ")
        rows[base] = [float(v) for v in body.split()]
    counts = np.stack([rows[b] for b in BASES], axis=1)
    return _normalize_counts(counts)


def load_ppm_hocomoco(text: str) -> np.ndarray:
    """HOCOMOCO v11 PCM: '>MOTIF' header then one whitespace-separated
    A C G T count row per position."""
    rows = []
    for line in text.strip().splitlines():
        line = line.strip()
        if not line or line.startswith(">"):
            continue
        rows.append([float(v) for v in line.split()[:4]])
    return _normalize_counts(np.asarray(rows))


def load_ppm_cisbp(text: str) -> np.ndarray:
    """cis-BP PPM text: preamble then a 'Pos\\tA\\tC\\tG\\tT' table
    (reference load_raw_ppm, rf2na_distillation_cis_bp notebook)."""
    table_text = "position" + text.split("Pos")[-1]
    lines = [ln for ln in table_text.splitlines() if ln.strip()]
    header = lines[0].split("\t")
    cols = [header.index(b) for b in BASES]
    counts = [[float(ln.split("\t")[c]) for c in cols] for ln in lines[1:]]
    return _normalize_counts(np.asarray(counts, np.float64).reshape(-1, 4))


def _write_ppm_csv(path: str, ppm: np.ndarray):
    write_csv_rows(path, [dict(zip(BASES, map(float, row))) for row in ppm], BASES)


def parse_transfac_matrices(text: str) -> Dict[str, np.ndarray]:
    """TRANSFAC matrix.dat: '//'-separated entries with 'AC  <id>' accession
    and 'P0  A C G T' count tables (reference preprocess_ppms,
    rf2na_distillation_transfac notebook). Returns {matrix_id: ppm}."""
    out: Dict[str, np.ndarray] = {}
    for entry in text.strip().split("//"):
        entry = entry.strip()
        if not entry:
            continue
        matrix_id = None
        rows: List[List[float]] = []
        reading = False
        for line in entry.splitlines():
            line = line.rstrip()
            if line.startswith("AC"):
                matrix_id = line.split(None, 1)[1].strip()
            elif line.startswith("P0"):
                reading = True
            elif reading and line[:2].strip().isdigit():
                parts = line.split()
                rows.append([float(v) for v in parts[1:5]])
            elif reading and not line[:2].strip().isdigit():
                reading = False
        if matrix_id and rows:
            out[matrix_id] = _normalize_counts(np.asarray(rows))
    return out


def preprocess_ppm_directory(raw_dir: str, out_dir: str, fmt: str):
    """Convert every raw motif file in raw_dir into a normalized ACGT CSV in
    out_dir (the reference's preprocess_pcms_into_ppms / preprocess_ppms)."""
    loader = {"jaspar": load_ppm_jaspar, "hocomoco": load_ppm_hocomoco,
              "cisbp": load_ppm_cisbp}[fmt]
    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(raw_dir)):
        path = os.path.join(raw_dir, name)
        if not os.path.isfile(path):
            continue
        try:
            ppm = loader(open(path).read())
        except (ValueError, KeyError, IndexError):
            continue
        out = os.path.join(out_dir, os.path.splitext(name)[0] + ".csv")
        _write_ppm_csv(out, ppm)


def preprocess_transfac_ppms(matrix_dat_path: str, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    for matrix_id, ppm in parse_transfac_matrices(
            open(matrix_dat_path).read()).items():
        _write_ppm_csv(os.path.join(out_dir, matrix_id + ".csv"), ppm)


# ---------------------------------------------------------------------------
# Source filters + input CSVs
# ---------------------------------------------------------------------------

def _number(v) -> float:
    """A numeric field as a float; NaN where it is missing."""
    if v is None or (isinstance(v, str) and not v.strip()):
        return math.nan
    return float(v)


def _listify(v):
    if isinstance(v, str):
        return v.strip("[]").replace("'", "").split(", ") if v.strip("[]") else []
    return v or []


def sequence_x_filter(seqs: Sequence[str], max_x: int = 20) -> bool:
    """Drop structures dominated by unknown residues (reference seq_filter:
    allow when the longest chain is short, else reject if X is the most
    common letter with count > max_x)."""
    seqs = [s for s in seqs if isinstance(s, str)]
    if not seqs:
        return True
    if max(len(s) for s in seqs) <= max_x:
        return True
    import collections
    top = collections.Counter("".join(seqs)).most_common(1)[0]
    return not (top[0] == "X" and top[1] > max_x)


def make_rcsb_cif_na_input(scan_df, structure_directory: str,
                           min_heavy: int = 100, min_coverage: float = 0.9,
                           max_resolution: float = 3.5):
    """RCSB NA subset recipe (rcsb_cif_na notebook): heavy-atom / coverage /
    unknown-sequence / resolution filters + must contain a nucleic chain."""
    out = []
    for row in scan_df:
        resolution = _number(row["resolution"])
        if not (_number(row["num_heavy"]) >= min_heavy
                and _number(row["coverage"]) >= min_coverage
                and sequence_x_filter(_listify(row["poly_sequence"]))
                and (resolution <= max_resolution or math.isnan(resolution))
                and any(t in NA_TYPES for t in _listify(row["poly_type"]))):
            continue
        sid = row["label"]
        out.append({"id": sid,
                    "structure_path": (structure_directory + os.sep + sid[1:3]
                                       + os.sep + sid + ".cif.gz"),
                    "date": row["date"], "dataset_name": "rcsb_cif_na"})
    return out


def make_distillation_input(df, structure_directory: str, dataset_name: str,
                            id_column: str, max_i_pae: float = 6.0,
                            min_plddt: float = 0.85,
                            path_fn=None):
    """Distillation-set recipe (rf2na_distillation_* notebooks): AF-confidence
    filters + synthetic 1970 date. `path_fn(row) -> structure_path` defaults
    to <dir>/<id[:2]>/<id>.pdb."""
    if path_fn is None:
        def path_fn(row):
            return os.path.join(structure_directory, row["id"][:2],
                                row["id"] + ".pdb")
    out = []
    for row in df:
        if not (_number(row["i_pae"]) <= max_i_pae
                and _number(row["plddt"]) >= min_plddt):
            continue
        row = {**row, "dataset_name": dataset_name, "date": "1970-01-01"}
        kept = {"id": row["id"], "structure_path": path_fn(row),
                "date": row["date"], "dataset_name": dataset_name}
        if id_column and id_column in row:
            kept[id_column] = row[id_column]
        out.append(kept)
    return out


# ---------------------------------------------------------------------------
# Post-preprocessing assembly (shared by every recipe)
# ---------------------------------------------------------------------------

def drop_failed_preprocessing(df, preprocessed_data_directory: str):
    """Remove rows whose id appears in the preprocessor's bad/ directory;
    returns (rows, {reason: count})."""
    failed_dir = os.path.join(preprocessed_data_directory, "bad")
    failed, reasons = [], {}
    if os.path.isdir(failed_dir):
        for name in os.listdir(failed_dir):
            sid = os.path.splitext(name)[0]
            failed.append(sid)
            reason = open(os.path.join(failed_dir, name)).read()
            reasons[reason] = reasons.get(reason, 0) + 1
    failed = set(failed)
    return [dict(r) for r in df if r["id"] not in failed], reasons


def attach_preprocessed_paths(df, preprocessed_data_directory: str):
    """Add one <attribute>_path column per preprocessor side-file directory
    (the eight .npy dirs + sequences CSVs)."""
    for attr in sorted(os.listdir(preprocessed_data_directory)):
        attr_dir = os.path.join(preprocessed_data_directory, attr)
        if attr == "bad" or not os.path.isdir(attr_dir):
            continue
        ext = ".csv" if attr == "sequences" else ".npy"
        for row in df:
            p = os.path.join(attr_dir, str(row["id"]) + ext)
            if not os.path.exists(p):
                raise FileNotFoundError(p)
            row[attr + "_path"] = p
    return df


def attach_ppm_paths(df, id_to_ppm_paths: Dict[str, List[List[str]]],
                     key_column: str = "id", drop_key: bool = False):
    """ppm_paths column from an id->paths mapping (the last stage of every
    specificity recipe)."""
    out = []
    for row in df:
        row = {**row, "ppm_paths": id_to_ppm_paths.get(row[key_column], [])}
        if drop_key and key_column != "id":
            del row[key_column]
        out.append(row)
    return out


def build_preprocessing_output(input_csv: str, preprocessed_data_directory: str,
                               output_csv: str,
                               id_to_ppm_paths: Optional[Dict] = None,
                               key_column: str = "id"):
    """input CSV + preprocessor outputs -> preprocessing_output.csv (the
    common tail of every make_dataset_csv notebook)."""
    df, columns = read_csv_rows(input_csv)
    df, reasons = drop_failed_preprocessing(df, preprocessed_data_directory)
    df = attach_preprocessed_paths(df, preprocessed_data_directory)
    if id_to_ppm_paths is not None:
        df = attach_ppm_paths(df, id_to_ppm_paths, key_column,
                              drop_key=key_column != "id")
    write_csv_rows(output_csv, df, list(df[0]) if df else columns)
    return df, reasons
