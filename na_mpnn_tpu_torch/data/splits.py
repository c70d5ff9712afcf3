"""Released data-split readers and writers.

The port's own copy of the JAX package's ``data/splits.py``, on rows: where
the JAX function takes a ``pandas.DataFrame``, this one takes a list of
row dicts (as ``csv.DictReader`` gives them) and returns one.

The reference releases its train/valid/test splits as JSON under ``splits/``
(format documented in reference splits/README.md:1-17):

* design splits: a list of PDB IDs;
* specificity splits: a list of [PDB ID, [PPM ID, ...]] pairs;
* eval subsets: same shapes, smaller.

The writer half mirrors the reference's release pipeline
(``splits/prepare_splits_for_release.ipynb``): dataset CSVs -> split JSONs,
incl. the TRANSFAC removal (licensing), the evaluation-subset intersection,
and the (PPM source, PPM id) encoding for specificity entries.
"""
from __future__ import annotations

import json
import os
import shutil
from ast import literal_eval
from typing import Dict, List, Tuple


def load_design_split(path: str) -> List[str]:
    """Design split JSON -> list of PDB IDs."""
    data = json.load(open(path))
    if not isinstance(data, list) or (data and not isinstance(data[0], str)):
        raise ValueError(f"{path}: not a design split (expected a list of PDB IDs)")
    return data


def load_specificity_split(path: str) -> List[Tuple[str, List[str]]]:
    """Specificity split JSON -> list of (PDB ID, [PPM IDs])."""
    data = json.load(open(path))
    out = []
    for entry in data:
        if isinstance(entry, str):
            out.append((entry, []))
        else:
            pdb_id, ppm_ids = entry[0], entry[1]
            out.append((str(pdb_id), list(ppm_ids)))
    return out


def filter_dataframe_by_split(rows, split_ids, id_column: str = "structure_path"):
    """The rows of a dataset CSV whose structure a split names; IDs are
    matched against the basename stem of id_column."""
    ids = set(s.lower() for s in split_ids)

    def stem(p):
        name = os.path.basename(str(p))
        for ext in (".gz", ".cif", ".pdb"):
            if name.endswith(ext):
                name = name[: -len(ext)]
        if name.startswith("pdb"):
            name = name[3:]
        return name.lower()

    return [r for r in rows if stem(r[id_column]) in ids]


# ---------------------------------------------------------------------------
# Release writers (reference splits/prepare_splits_for_release.ipynb)
# ---------------------------------------------------------------------------

def subset_df_to_remove_transfac(rows):
    """Drop TRANSFAC-derived rows — the reference may not redistribute them
    (reference splits/README.md 'Disclaimer on TRANSFAC Data')."""
    return [dict(r) for r in rows
            if r["dataset_name"] != "rf2na_distillation_transfac"]


def subset_evaluation_set_to_outputs(rows, output_rows):
    """Keep only entries that produced evaluation outputs (the released
    evaluation_* splits are intersected with the summary-plot CSVs)."""
    produced = {r["structure_path"] for r in output_rows}
    return [dict(r) for r in rows if r["structure_path"] in produced]


def ppm_source_from_path(ppm_path: str, dataset_name: str) -> str:
    """PPM database attribution from the file path + dataset source.
    TRANSFAC rows raise (like the reference) — they are licensed and must be
    removed with subset_df_to_remove_transfac before release, never
    re-attributed."""
    if dataset_name == "rf2na_distillation_cis_bp":
        return "CIS-BP"
    if dataset_name == "rcsb_cif_na":
        if "jaspar" in ppm_path:
            return "JASPAR"
        if "H11MO" in ppm_path:
            return "HOCOMOCO"
        raise ValueError(f"Unknown PPM source for path {ppm_path}")
    raise ValueError(f"Unknown PPM source for path {ppm_path}")


def prepare_save_info_for_specificity(rows) -> List[Tuple[str, list]]:
    """Dataset CSV rows -> released specificity entries
    (id, [[(PPM source, PPM id), ...], ...]); each inner list is an
    experimentally-equivalent PPM group."""
    save_info = []
    for row in rows:
        ppm_ids = []
        for group in literal_eval(row["ppm_paths"]):
            ppm_ids.append(tuple(
                (ppm_source_from_path(p, row["dataset_name"]),
                 os.path.splitext(os.path.basename(p))[0])
                for p in group))
        save_info.append((row["id"], ppm_ids))
    return save_info


def write_design_split(path: str, rows):
    """Dataset CSV rows -> design split JSON (a plain id list)."""
    with open(path, "w") as f:
        json.dump([r["id"] for r in rows], f, indent=4)


def write_specificity_split(path: str, rows):
    """Dataset CSV rows -> specificity split JSON ((id, PPM-ids) pairs);
    TRANSFAC rows removed first."""
    with open(path, "w") as f:
        json.dump(prepare_save_info_for_specificity(
            subset_df_to_remove_transfac(rows)), f, indent=4)


def copy_distillation_structures(rows, dest_dir: str) -> List[str]:
    """Copy CIS-BP distillation structures into the release folder
    (the reference's cis_bp_test_distillation_structures/)."""
    os.makedirs(dest_dir, exist_ok=True)
    out = []
    for row in rows:
        if row["dataset_name"] == "rf2na_distillation_cis_bp":
            dst = os.path.join(dest_dir,
                               os.path.basename(row["structure_path"]))
            shutil.copyfile(row["structure_path"], dst)
            out.append(dst)
    return out


def available_reference_splits(splits_dir: str) -> Dict[str, str]:
    """Map split name -> path for every JSON in a splits directory."""
    out = {}
    if os.path.isdir(splits_dir):
        for f in sorted(os.listdir(splits_dir)):
            if f.endswith(".json"):
                out[os.path.splitext(f)[0]] = os.path.join(splits_dir, f)
    return out
