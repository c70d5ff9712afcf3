"""Offline preprocessing CLI: structures -> per-assembly label side files
(the port of the JAX package's ``cli/preprocess.py``; numpy only, the CSV
read with ``csv``).

Shards a CSV of structures (a ``structure_path`` column) across array tasks
by (index+1) % modulo == remainder and writes the JAX package's output tree
(sequences/, asmb_lengths/, asmb_*_masks/, ... , bad/).

Usage: python -m na_mpnn_tpu_torch.cli.preprocess input.csv outdir modulo \
           remainder [config.json]
"""
from __future__ import annotations

import csv
import json
import os
import sys

import numpy as np


DEFAULT_PARAMS = {
    "BATCH_TOKENS": 6000,
    "NUM_NEIGHBORS": 32,
    "ATOMS_TO_LOAD": "all",
    "EXCLUDE_RES": ["HOH", "NA", "CL", "K", "BR"],
    "RANDOMIZE_NMR_MODEL": 0,
    "PARSE_PROTEIN": 1, "PARSE_DNA": 1, "PARSE_RNA": 1,
    "PARSE_RNA_AS_DNA": 0, "NA_SHARED_TOKENS": 1,
    "PROTEIN_BACKBONE_OCC_CUTOFF": 0.8, "PROTEIN_SIDE_CHAIN_OCC_CUTOFF": 0.5,
    "DNA_BACKBONE_OCC_CUTOFF": 0.8, "DNA_SIDE_CHAIN_OCC_CUTOFF": 0.5,
    "RNA_BACKBONE_OCC_CUTOFF": 0.8, "RNA_SIDE_CHAIN_OCC_CUTOFF": 0.5,
    "CROP_LARGE_STRUCTURES": 0, "NA_REF_ATOM": "C1'",
}

SIDE_FILE_DIRS = [
    "sequences", "asmb_lengths", "asmb_interface_masks",
    "asmb_side_chain_interface_masks", "asmb_nearest_protein_side_chain_index",
    "asmb_base_pair_masks", "asmb_base_pair_index",
    "asmb_canonical_base_pair_masks", "asmb_canonical_base_pair_index", "bad",
]


def preprocess_structure(dataset, example, params):
    """Process one structure -> dict of per-assembly label dicts, or an error
    string (reference data/preprocess_dataset.py:1078-1134)."""
    from ..data.preprocess import (get_base_pair_mask_and_index,
                                   get_interface_masks)

    assemblies, chain_sequences = dataset.load_for_structure_preprocessing(example)
    if assemblies is None or len(assemblies) == 0:
        return "cifutils_failed_to_load_assemblies", None

    out = {k: {} for k in ["lengths", "interface", "sc_interface", "nearest_sc",
                           "bp_mask", "bp_index", "cbp_mask", "cbp_index"]}
    missing_na = 0
    for assembly_id, d in assemblies:
        if d["dna_L"] == 0 and d["rna_L"] == 0:
            missing_na += 1
            continue
        L = d["S"].shape[0]
        if L > params["BATCH_TOKENS"]:
            bp_mask = np.zeros(L, np.int32)
            bp_index = np.zeros(L, np.int64)
            cbp_mask = np.zeros(L, np.int32)
            cbp_index = np.zeros(L, np.int64)
        else:
            bp_mask, bp_index, cbp_mask, cbp_index = get_base_pair_mask_and_index(
                d["S"], d["X"], d["X_m"], d["rna_mask"],
                atom_dict=dataset.atom_dict,
                canonical_pair_ints=dataset.na_canonical_base_pair_ints,
                na_shared_tokens=bool(params["NA_SHARED_TOKENS"]))
        interface, sc_interface, nearest_sc = get_interface_masks(
            d["X"], d["X_m"], d["protein_mask"], d["dna_mask"], d["rna_mask"],
            atom_dict=dataset.atom_dict, na_ref_atom=params["NA_REF_ATOM"],
            num_neighbors=params["NUM_NEIGHBORS"])
        out["lengths"][assembly_id] = (d["macromolecule_L"], d["protein_L"],
                                       d["dna_L"], d["rna_L"])
        out["interface"][assembly_id] = interface
        out["sc_interface"][assembly_id] = sc_interface
        out["nearest_sc"][assembly_id] = nearest_sc
        out["bp_mask"][assembly_id] = bp_mask
        out["bp_index"][assembly_id] = bp_index
        out["cbp_mask"][assembly_id] = cbp_mask
        out["cbp_index"][assembly_id] = cbp_index

    if not out["lengths"]:
        if missing_na == len(assemblies):
            return "all_assemblies_no_resolved_and_occupied_nucleic_acids", None
        return "all_assemblies_failed", None
    return None, (out, chain_sequences)


def main(argv=None):
    from .. import constants
    from ..data.dataset import DatasetConfig, NADataset
    from ..data.parsers import make_parsers

    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        sys.exit(0 if argv else 1)
    input_csv, outdir, modulo, remainder = argv[0], argv[1], int(argv[2]), int(argv[3])
    params = dict(DEFAULT_PARAMS)
    if len(argv) > 4:
        with open(argv[4]) as f:
            params.update(json.load(f))

    atoms = (constants.BACKBONE_ATOMS if params["ATOMS_TO_LOAD"] == "backbone"
             else constants.ALL_ATOMS)
    cif_parser, pdb_parser = make_parsers(
        skip_res=params["EXCLUDE_RES"],
        randomize_nmr_model=bool(params["RANDOMIZE_NMR_MODEL"]))
    ds_cfg = DatasetConfig(
        atom_list_to_save=tuple(atoms),
        parse_protein=bool(params["PARSE_PROTEIN"]),
        parse_dna=bool(params["PARSE_DNA"]), parse_rna=bool(params["PARSE_RNA"]),
        parse_rna_as_dna=bool(params["PARSE_RNA_AS_DNA"]),
        na_shared_tokens=bool(params["NA_SHARED_TOKENS"]),
        protein_backbone_occ_cutoff=params["PROTEIN_BACKBONE_OCC_CUTOFF"],
        protein_side_chain_occ_cutoff=params["PROTEIN_SIDE_CHAIN_OCC_CUTOFF"],
        dna_backbone_occ_cutoff=params["DNA_BACKBONE_OCC_CUTOFF"],
        dna_side_chain_occ_cutoff=params["DNA_SIDE_CHAIN_OCC_CUTOFF"],
        rna_backbone_occ_cutoff=params["RNA_BACKBONE_OCC_CUTOFF"],
        rna_side_chain_occ_cutoff=params["RNA_SIDE_CHAIN_OCC_CUTOFF"],
        crop_large_structures=bool(params["CROP_LARGE_STRUCTURES"]),
        batch_tokens=params["BATCH_TOKENS"], na_ref_atom=params["NA_REF_ATOM"])
    dataset = NADataset(cif_parser=cif_parser, pdb_parser=pdb_parser, config=ds_cfg)

    dirs = {d: os.path.join(outdir, d) for d in SIDE_FILE_DIRS}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    with open(input_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    for iii, example in enumerate(rows):
        if (iii + 1) % modulo != remainder:
            continue
        fname = os.path.basename(example["structure_path"])
        name = fname
        for ext in (".gz", ".pdb", ".cif"):
            if name.endswith(ext):
                name = name[: -len(ext)]
        bad_path = os.path.join(dirs["bad"], name + ".txt")
        try:
            err, result = preprocess_structure(dataset, example, params)
        except Exception as e:  # noqa: BLE001 — a failed structure goes to bad/
            with open(bad_path, "w") as f:
                f.write(str(e))
            continue
        if err:
            with open(bad_path, "w") as f:
                f.write(err)
            continue
        out, chain_sequences = result
        lines = ["chain_id,chain_type,sequence"]
        for row in chain_sequences:
            lines.append(",".join("" if x is None else str(x) for x in row))
        with open(os.path.join(dirs["sequences"], name + ".csv"), "w") as f:
            f.write("\n".join(lines))
        np.save(os.path.join(dirs["asmb_lengths"], name + ".npy"), out["lengths"])
        np.save(os.path.join(dirs["asmb_interface_masks"], name + ".npy"), out["interface"])
        np.save(os.path.join(dirs["asmb_side_chain_interface_masks"], name + ".npy"),
                out["sc_interface"])
        np.save(os.path.join(dirs["asmb_nearest_protein_side_chain_index"], name + ".npy"),
                out["nearest_sc"])
        np.save(os.path.join(dirs["asmb_base_pair_masks"], name + ".npy"), out["bp_mask"])
        np.save(os.path.join(dirs["asmb_base_pair_index"], name + ".npy"), out["bp_index"])
        np.save(os.path.join(dirs["asmb_canonical_base_pair_masks"], name + ".npy"),
                out["cbp_mask"])
        np.save(os.path.join(dirs["asmb_canonical_base_pair_index"], name + ".npy"),
                out["cbp_index"])


if __name__ == "__main__":
    main()
