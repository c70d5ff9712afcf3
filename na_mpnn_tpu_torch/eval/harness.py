"""Evaluation pipelines + function-dispatch CLI.

Equivalent of the reference harness's orchestration layer (reference
evaluation/na_eval_utils.py:2356-3753): design / specificity pipelines run
our inference CLI in-process (the reference shells into an apptainer image,
evaluation/na_eval_utils.py:2428-2463), scoring pipelines call the local
scoring math, and external-tool stages (DSSR, EternaFold, AF3, RibonanzaNet)
degrade gracefully when the binaries are absent.

The port's own copy of the JAX package's ``eval/harness.py``: the same
functions, arguments, output layout and JSON keys. Each NA-MPNN run goes
through the port's ``cli/run.py`` with ``--device`` (every entry point that
runs the model takes ``device="cuda"``; ``"cpu"`` runs the plain versions
of the kernels). Each call reloads the checkpoint and featurises its
structure again, as the JAX harness does.

CLI: ``python -m na_mpnn_tpu_torch.eval.harness --function_name <fn>
[kwargs...] [--device cuda]`` mirroring the reference dispatcher
(evaluation/na_eval_utils.py:3659-3753).
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
from typing import Dict, List, Tuple

import numpy as np

from . import scoring
from .. import constants


# ---------------------------------------------------------------------------
# File helpers (reference evaluation/na_eval_utils.py:23-217)
# ---------------------------------------------------------------------------

def read_text_file(path):
    with open(path) as f:
        return f.read()


def write_text_file(path, contents):
    with open(path, "w") as f:
        f.write(contents)


def read_json_file(path):
    with open(path) as f:
        return json.load(f)


def write_json_file(path, contents):
    with open(path, "w") as f:
        json.dump(contents, f, indent=4)


def read_fasta_file(path) -> List[Tuple[str, str]]:
    entries = []
    header, seq = None, []
    for line in read_text_file(path).splitlines():
        if line.startswith(">"):
            if header is not None:
                entries.append((header, "".join(seq)))
            header, seq = line[1:], []
        elif line.strip():
            seq.append(line.strip())
    if header is not None:
        entries.append((header, "".join(seq)))
    return entries


def write_fasta_file(path, fasta_entries):
    write_text_file(path, "\n".join(f">{h}\n{s}" for h, s in fasta_entries))


def parse_design_fasta_header(header: str) -> Dict[str, str]:
    """key=value fields from a design FASTA header. The CLI header mixes
    comma- and space-separated fields (reference inference/run.py:350-352:
    '..., overall_confidence=X seq_rec=Y'), so match key=value tokens
    directly instead of splitting on any one delimiter."""
    import re
    return {m.group(1): m.group(2)
            for m in re.finditer(r"([A-Za-z_]\w*)=([^,\s]+)", header)}


def chain_num_to_chain_id(chain_num: int) -> str:
    """0->A, 25->Z, 26->AA, ... (reference chain_num_to_chain_id)."""
    out = ""
    n = chain_num
    while True:
        out = chr(ord("A") + n % 26) + out
        n = n // 26 - 1
        if n < 0:
            return out


def compute_human_readable_ppm(predicted_ppm, dna_mask, rna_mask,
                               restype_to_int=None):
    """Subset the 33-column PPM to human-readable A/C/G/T(U) columns per NA
    residue (reference compute_human_readable_ppm,
    evaluation/na_eval_utils.py:219-253)."""
    if restype_to_int is None:
        restype_to_int = constants.restype_to_int_table(True)
    t = restype_to_int
    na = (np.asarray(dna_mask) + np.asarray(rna_mask)).astype(bool)
    cols = [t["DA"], t["DC"], t["DG"], t["DT"]]
    return np.asarray(predicted_ppm)[na][:, cols]


# ---------------------------------------------------------------------------
# NA-MPNN runs (in-process; replaces the reference's apptainer subprocess)
# ---------------------------------------------------------------------------

def _structure_name(structure_path: str) -> Tuple[str, str]:
    base = os.path.basename(structure_path)
    if base.endswith(".gz"):
        base = os.path.splitext(base)[0]
    if not (base.endswith(".pdb") or base.endswith(".cif")):
        raise ValueError(f"Invalid structure file extension: {base}")
    return os.path.splitext(base)[0], base


def run_na_mpnn_sequence(structure_path, output_directory, batch_size=10,
                         number_of_batches=1, temperature=0.1,
                         omit_AA="ARNDCQEGHILKMFPSTWYVXbdhuy",
                         design_na_only=1, load_residues_with_missing_atoms=0,
                         output_pdbs=0, catch_failed_inferences=1,
                         na_mpnn_model_path=None, seed=0,
                         pad_to_bucket=0, device="cuda") -> List[Dict]:
    """Design sequences with our CLI and parse the FASTA back into design
    dicts (reference run_na_mpnn_sequence,
    evaluation/na_eval_utils.py:2356-2509)."""
    from ..cli.run import apply_mode_defaults, build_argparser, main as cli_main

    if na_mpnn_model_path is None:
        raise ValueError("na_mpnn_model_path is required")
    structure_name, _ = _structure_name(structure_path)
    args = build_argparser().parse_args([
        "--mode", "design",
        "--checkpoint_na_mpnn", na_mpnn_model_path,
        "--pdb_path", structure_path,
        "--out_folder", output_directory,
        "--batch_size", str(batch_size),
        "--number_of_batches", str(number_of_batches),
        "--temperature", str(temperature),
        "--omit_AA", omit_AA,
        "--design_na_only", str(design_na_only),
        "--load_residues_with_missing_atoms", str(load_residues_with_missing_atoms),
        "--output_pdbs", str(output_pdbs),
        "--seed", str(seed),
        "--pad_to_bucket", str(pad_to_bucket),
        "--device", device,
    ])
    args = apply_mode_defaults(args)
    cli_main(args)

    fasta_path = os.path.join(output_directory, "seqs", f"{structure_name}.fa")
    if not os.path.exists(fasta_path):
        raise ValueError(f"Output fasta file not found: {fasta_path}")
    entries = read_fasta_file(fasta_path)[1:]  # skip the native entry
    design_data = []
    for header, seq in entries:
        meta = parse_design_fasta_header(header)
        design_data.append({
            "input_structure_name": structure_name,
            "input_structure_path": structure_path,
            "design_id": meta.get("id"),
            "name": f"{structure_name}_{meta.get('id')}",
            "design_sequence": seq,
            "tool_reported_sequence_recovery": float(meta.get("seq_rec", "nan")),
            "design_method": "na_mpnn",
            "model_weights_path": na_mpnn_model_path,
        })
    return design_data


def run_na_mpnn_specificity(structure_path, output_directory, batch_size=30,
                            number_of_batches=10, temperature=0.6,
                            na_mpnn_model_path=None, seed=0,
                            pad_to_bucket=0, device="cuda") -> Dict:
    """Predict a PPM with our CLI's specificity mode and load the .npz
    (reference run_na_mpnn_specificity, evaluation/na_eval_utils.py:1034-1200)."""
    from ..cli.run import apply_mode_defaults, build_argparser, main as cli_main

    if na_mpnn_model_path is None:
        raise ValueError("na_mpnn_model_path is required")
    structure_name, _ = _structure_name(structure_path)
    args = build_argparser().parse_args([
        "--mode", "specificity",
        "--checkpoint_na_mpnn", na_mpnn_model_path,
        "--pdb_path", structure_path,
        "--out_folder", output_directory,
        "--batch_size", str(batch_size),
        "--number_of_batches", str(number_of_batches),
        "--temperature", str(temperature),
        "--omit_AA", "ARNDCQEGHILKMFPSTWYVX",
        "--design_na_only", "1",
        "--output_specificity", "1",
        "--output_pdbs", "0",
        "--output_sequences", "0",
        "--seed", str(seed),
        "--pad_to_bucket", str(pad_to_bucket),
        "--device", device,
    ])
    args = apply_mode_defaults(args)
    cli_main(args)

    npz_path = os.path.join(output_directory, "specificity", f"{structure_name}.npz")
    data = np.load(npz_path, allow_pickle=True)
    return {k: data[k] for k in data.files}


def run_na_mpnn_score(structure_path, output_directory, batch_size=10,
                      number_of_batches=1, na_mpnn_model_path=None, seed=0,
                      design_na_only=1, pad_to_bucket=0,
                      device="cuda") -> Dict:
    """Teacher-forced scoring of the native sequence via the CLI's score
    mode (models.score + unconditional_probs; no autoregressive decode) —
    the cheap recovery/likelihood metric for checkpoint sweeps. Returns the
    stats dict (log_probs [N,L,nl], mean_probs, unconditional_log_probs,
    loss, loss_per_residue, recovery_argmax, ...)."""
    from ..cli.run import apply_mode_defaults, build_argparser, main as cli_main

    if na_mpnn_model_path is None:
        raise ValueError("na_mpnn_model_path is required")
    structure_name, _ = _structure_name(structure_path)
    args = build_argparser().parse_args([
        "--mode", "score",
        "--checkpoint_na_mpnn", na_mpnn_model_path,
        "--pdb_path", structure_path,
        "--out_folder", output_directory,
        "--batch_size", str(batch_size),
        "--number_of_batches", str(number_of_batches),
        "--design_na_only", str(design_na_only),
        "--output_pdbs", "0",
        "--output_sequences", "0",
        "--stats_format", "npz",
        "--seed", str(seed),
        "--pad_to_bucket", str(pad_to_bucket),
        "--device", device,
    ])
    args = apply_mode_defaults(args)
    cli_main(args)

    npz_path = os.path.join(output_directory, "stats", f"{structure_name}.npz")
    data = np.load(npz_path, allow_pickle=True)
    return {k: data[k] for k in data.files}


# ---------------------------------------------------------------------------
# Pipelines
# ---------------------------------------------------------------------------

def _fresh_output_dir(overall_output_directory, name):
    out = os.path.join(os.path.abspath(overall_output_directory), name)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.makedirs(out)
    return out


def _copy_structure(structure_path, output_directory):
    structure_name, base = _structure_name(structure_path)
    copy_path = os.path.join(output_directory, base)
    if structure_path.endswith(".gz"):
        with gzip.open(structure_path, "rb") as f_in, open(copy_path, "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
    else:
        shutil.copy(structure_path, copy_path)
    return copy_path


def design_nucleic_acid_sequence(structure_path, overall_output_directory,
                                 num_samples, temperature, method="na_mpnn",
                                 na_mpnn_model_path=None, seed=0,
                                 device="cuda"):
    """Per-structure design pipeline (reference design_nucleic_acid_sequence,
    evaluation/na_eval_utils.py:2787-2910). Methods: na_mpnn (native),
    grnade / rhodesign (site-configured external tools)."""
    structure_path = os.path.abspath(structure_path)
    if temperature is None:
        temperature = 0.1
    if not os.path.exists(structure_path):
        raise ValueError(f"Structure file not found: {structure_path}")
    structure_name, _ = _structure_name(structure_path)
    output_directory = _fresh_output_dir(overall_output_directory, structure_name)
    original = structure_path
    structure_path = _copy_structure(structure_path, output_directory)
    design_json_dir = os.path.join(output_directory, "design_json")
    os.makedirs(design_json_dir)

    if method == "na_mpnn":
        design_data = run_na_mpnn_sequence(
            structure_path, output_directory=output_directory,
            batch_size=num_samples, number_of_batches=1,
            temperature=temperature, na_mpnn_model_path=na_mpnn_model_path,
            seed=seed, device=device)
    elif method == "grnade":
        from .external import run_grnade
        design_data = run_grnade(structure_path, output_directory,
                                 n_samples=num_samples,
                                 temperature=temperature)
    elif method == "rhodesign":
        from .external import run_rhodesign
        design_data = run_rhodesign(structure_path, output_directory,
                                    n_samples=num_samples,
                                    temperature=temperature)
    else:
        raise ValueError(f"Invalid sequence design method: {method}")
    for d in design_data:
        d["original_input_structure_path"] = original
        write_json_file(os.path.join(design_json_dir, f"{d['name']}.json"), d)
    return design_data


def process_reference_monomer_rna(reference_structure_path,
                                  overall_output_directory):
    """Extract the reference RNA monomer's sequence + secondary structure
    with DSSR into <out>/<name>/reference_json/<name>.json (reference
    process_reference_monomer_rna, evaluation/na_eval_utils.py:2912-3004)."""
    from .external import run_dssr

    reference_structure_path = os.path.abspath(reference_structure_path)
    if not os.path.exists(reference_structure_path):
        raise ValueError(
            f"Reference structure file not found: {reference_structure_path}")
    structure_name, _ = _structure_name(reference_structure_path)
    output_directory = _fresh_output_dir(overall_output_directory, structure_name)
    original = reference_structure_path
    reference_structure_path = _copy_structure(reference_structure_path,
                                               output_directory)
    ref_json_dir = os.path.join(output_directory, "reference_json")
    os.makedirs(ref_json_dir)

    # run_dssr already standardizes sequence + secondary structure.
    dssr_output = run_dssr(reference_structure_path)
    scoring.check_rna_sequence_validity(dssr_output["sequence"],
                                        unknown_residue_allowed=True,
                                        chain_breaks_allowed=False)
    dssr_output.pop("raw", None)
    dssr_output.pop("stdout", None)

    output_dict = {
        "name": structure_name,
        "original_reference_structure_path": original,
        "reference_structure_path": reference_structure_path,
        "dssr": dssr_output,
    }
    out_path = os.path.join(ref_json_dir, f"{structure_name}.json")
    write_json_file(out_path, output_dict)
    return out_path


def process_design_monomer_rna(subject_path, overall_output_directory,
                               num_af3_diffusion_samples=5):
    """Process one design JSON: EternaFold 2°, RibonanzaNet 2° + reactivity,
    AlphaFold3 fold, into <out>/<name>/processed_design_json/<name>.json
    (reference process_design_monomer_rna,
    evaluation/na_eval_utils.py:3006-3101)."""
    from . import external

    subject_path = os.path.abspath(subject_path)
    if not os.path.exists(subject_path):
        raise ValueError(f"Design fasta file not found: {subject_path}")
    design_json = read_json_file(subject_path)
    design_name = design_json["name"]
    output_directory = _fresh_output_dir(overall_output_directory, design_name)
    processed_dir = os.path.join(output_directory, "processed_design_json")
    os.makedirs(processed_dir)

    design_sequence = scoring.standardize_rna_sequence(
        design_json["design_sequence"], method=design_json["design_method"])
    scoring.check_rna_sequence_validity(design_sequence,
                                        unknown_residue_allowed=False,
                                        chain_breaks_allowed=False)

    eternafold_result = external.run_eternafold(design_sequence)
    rnn_ss = external.run_ribonanza_net_secondary_structure(design_sequence)
    rnn_react = external.run_ribonanza_net_reactivity_profile(design_sequence)
    af3_result = external.run_alphafold3(
        name=design_name, sequence=design_sequence,
        output_directory=output_directory)

    output_dict = {
        "name": design_name,
        "sequence": design_sequence,
        "design_input_path": subject_path,
        "eternafold": eternafold_result,
        "ribonanza_net_secondary_structure": rnn_ss,
        "ribonanza_net_reactivity_profile": rnn_react,
        "alphafold3": af3_result,
    }
    out_path = os.path.join(processed_dir, f"{design_name}.json")
    write_json_file(out_path, output_dict)
    return out_path


def predict_nucleic_acid_ppm(structure_path, overall_output_directory,
                             num_samples, temperature, num_batches=1,
                             method="na_mpnn", na_mpnn_model_path=None, seed=0,
                             device="cuda"):
    """Per-structure specificity pipeline: sample -> mean PPM -> subject JSON
    (reference predict_nucleic_acid_ppm, evaluation/na_eval_utils.py:3342-3467)."""
    structure_path = os.path.abspath(structure_path)
    if temperature is None:
        temperature = 0.6
    structure_name, _ = _structure_name(structure_path)
    output_directory = _fresh_output_dir(overall_output_directory, structure_name)
    original = structure_path
    structure_path = _copy_structure(structure_path, output_directory)

    if method == "na_mpnn":
        spec = run_na_mpnn_specificity(
            structure_path, output_directory=output_directory,
            batch_size=num_samples, number_of_batches=num_batches,
            temperature=temperature, na_mpnn_model_path=na_mpnn_model_path,
            seed=seed, device=device)
    elif method == "deeppbs":
        from .external import run_deeppbs
        spec = run_deeppbs(structure_path, output_directory)
        spec = {k: np.asarray(v) if isinstance(v, list) else v
                for k, v in spec.items()}
        spec["predicted_ppm"] = spec.pop("predicted_ppm_na_mpnn_format")
        spec["true_sequence"] = spec.pop("true_sequence_na_mpnn_format")
    else:
        raise ValueError(f"Invalid specificity prediction method: {method}")

    subject = {
        "name": structure_name,
        "input_structure_path": structure_path,
        "original_input_structure_path": original,
        "predicted_ppm_na_mpnn_format": np.asarray(spec["predicted_ppm"]).tolist(),
        "true_sequence_na_mpnn_format": np.asarray(spec["true_sequence"]).tolist(),
        "chain_labels": np.asarray(spec["chain_labels"]).tolist(),
        "mask": np.asarray(spec["mask"]).tolist(),
        "protein_mask": np.asarray(spec["protein_mask"]).tolist(),
        "dna_mask": np.asarray(spec["dna_mask"]).tolist(),
        "rna_mask": np.asarray(spec["rna_mask"]).tolist(),
        "human_readable_ppm": compute_human_readable_ppm(
            spec["predicted_ppm"], spec["dna_mask"], spec["rna_mask"]).tolist(),
        "prediction_method": method,
        "model_weights_path": na_mpnn_model_path,
    }
    # Written under specificity_json/ — the directory layout the scoring
    # array scripts glob (reference na_eval_utils.py:3428-3466,
    # score_native_specificities.sh).
    spec_json_dir = os.path.join(output_directory, "specificity_json")
    os.makedirs(spec_json_dir, exist_ok=True)
    subject_path = os.path.join(spec_json_dir, f"{structure_name}.json")
    write_json_file(subject_path, subject)
    return subject_path


def score_specificity_prediction(reference_ppms_list_str, subject_path,
                                 overall_output_directory):
    """Score a predicted PPM against experimental PPMs (reference
    score_specificity_prediction, evaluation/na_eval_utils.py:3469-3651)."""
    from ..data.dataset import load_ppms

    subject_path = os.path.abspath(subject_path)
    if not os.path.exists(subject_path):
        raise ValueError(f"Predicted PPM file not found: {subject_path}")
    subject = read_json_file(subject_path)
    output_directory = _fresh_output_dir(overall_output_directory, subject["name"])

    reference_ppms, chosen = load_ppms(reference_ppms_list_str,
                                       randomize_experimental_ppms=False)
    result = scoring.score_specificity_arrays(
        reference_ppms,
        np.asarray(subject["true_sequence_na_mpnn_format"], np.int64),
        np.asarray(subject["chain_labels"], np.int32),
        np.asarray(subject["protein_mask"], np.int32),
        np.asarray(subject["dna_mask"], np.int32),
        np.asarray(subject["rna_mask"], np.int32),
        np.asarray(subject["predicted_ppm_na_mpnn_format"], np.float64),
        np.asarray(subject["mask"], np.int32))
    result.update({
        "reference_ppms_list_str": reference_ppms_list_str,
        "reference_ppm_paths_chosen": chosen,
        "subject_name": subject["name"],
        "subject_path": subject_path,
    })
    for k, v in list(result.items()):
        if isinstance(v, np.ndarray):
            result[k] = v.tolist()
    out_path = os.path.join(output_directory, f"{subject['name']}.json")
    write_json_file(out_path, result)
    return out_path


def score_design_monomer_rna(reference_path, subject_path,
                             overall_output_directory):
    """Score one RNA-monomer design against its processed reference
    (reference score_design_monomer_rna, evaluation/na_eval_utils.py:3103-3340):
    sequence recovery vs DSSR, 2° F1s vs EternaFold + RibonanzaNet, OpenKnot
    reactivity scores, and C1' RMSD/lDDT/GDT vs the AlphaFold3 model. Stages
    whose inputs are absent from the processed JSONs are skipped (recorded as
    null) so partial protocols still score."""
    from .superimpose import (kabsch_superimpose, load_atom_coords, lddt,
                              rmsd, superimposed_rmsd)

    reference_path = os.path.abspath(reference_path)
    subject_path = os.path.abspath(subject_path)
    reference = read_json_file(reference_path)
    subject = read_json_file(subject_path)
    output_directory = _fresh_output_dir(overall_output_directory, subject["name"])

    ref_seq_len = len(reference["dssr"]["sequence"])
    subject_len = len(subject["sequence"])
    result = {
        "reference_name": reference["name"],
        "reference_path": reference_path,
        "reference_sequence_length": ref_seq_len,
        "subject_name": subject["name"],
        "subject_path": subject_path,
        "subject_sequence_length": subject_len,
        "best_start_idx": None,
        "best_end_idx": None,
    }

    # C1' coordinate arrays for the structural comparison.
    ref_c1 = sub_c1 = None
    af3 = subject.get("alphafold3") or {}
    if af3.get("predicted_structure_path") and os.path.exists(
            af3["predicted_structure_path"]) and os.path.exists(
            reference.get("reference_structure_path", "")):
        ref_c1 = load_atom_coords(reference["reference_structure_path"], "C1'")
        sub_c1 = load_atom_coords(af3["predicted_structure_path"], "C1'")
        # Like the reference (na_eval_utils.py:3152-3157), every C1' atom in
        # the file is used — ligand C1' atoms or missing atoms make the count
        # disagree with the DSSR sequence and misregister the window scan.
        # Warn loudly instead of silently scoring the wrong residues.
        if len(ref_c1) != ref_seq_len:
            print(f"WARNING: {len(ref_c1)} C1' atoms in "
                  f"{reference['reference_structure_path']} but DSSR "
                  f"sequence length {ref_seq_len}; window registration "
                  "may be off (ligand C1' or missing atoms)")

    # Shorter subject: find the best-RMSD reference window, trim sequence,
    # secondary structure (pairs out of the window become loops), and coords.
    if subject_len < ref_seq_len:
        best = (None, None)
        if ref_c1 is not None and sub_c1 is not None:
            for start in range(ref_seq_len - subject_len + 1):
                window = ref_c1[start:start + subject_len]
                if len(window) != len(sub_c1):  # atom/sequence count mismatch
                    continue
                r = superimposed_rmsd(window, sub_c1)
                if best[0] is None or r < best[0]:
                    best = (r, start)
            if best[0] is None:
                best = (None, 0)
        else:
            best = (None, 0)
        start = best[1]
        end = start + subject_len
        result["best_start_idx"] = start
        result["best_end_idx"] = end
        ss = reference["dssr"]["secondary_structure"]
        pairs, _ = scoring.base_pairs_and_loops(ss)
        ss = list(ss)
        for i, j in pairs:
            if i < start or j < start or i >= end or j >= end:
                ss[i] = "."
                ss[j] = "."
        reference["dssr"]["secondary_structure"] = "".join(ss[start:end])
        reference["dssr"]["sequence"] = reference["dssr"]["sequence"][start:end]
        if ref_c1 is not None:
            ref_c1 = ref_c1[start:end]
    elif subject_len > ref_seq_len:
        raise ValueError("Subject sequence is longer than reference sequence.")

    result["sequence_recovery"] = scoring.calculate_sequence_recovery(
        reference["dssr"]["sequence"], subject["sequence"],
        unknown_residue_allowed_in_reference=True)["sequence_recovery"]

    ref_ss = reference["dssr"]["secondary_structure"]
    if subject.get("eternafold"):
        ef = scoring.calculate_secondary_structure_stats(
            ref_ss, subject["eternafold"]["predicted_secondary_structure"])
        result["eternafold_f1_score_pairs"] = ef["f1_score_pairs"]
        result["eternafold_f1_score_loops"] = ef["f1_score_loops"]

    def _mean_over(pred_list, fn):
        acc = {}
        for pred in pred_list:
            for k, v in fn(pred).items():
                acc.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in acc.items()}

    if subject.get("ribonanza_net_secondary_structure"):
        m = _mean_over(
            subject["ribonanza_net_secondary_structure"][
                "predicted_secondary_structures"],
            lambda ss: scoring.calculate_secondary_structure_stats(ref_ss, ss))
        result["ribonanza_net_f1_score_pairs"] = m["f1_score_pairs"]
        result["ribonanza_net_f1_score_loops"] = m["f1_score_loops"]

    if subject.get("ribonanza_net_reactivity_profile"):
        m = _mean_over(
            subject["ribonanza_net_reactivity_profile"][
                "predicted_2A3_reactivity_profiles"],
            lambda prof: scoring.calculate_reactivity_profile_score(
                ref_ss, np.asarray(prof)))
        result["ribonanza_net_eternafold_class_score"] = m["eternafold_class_score"]
        result["ribonanza_net_crossed_pair_quality_score"] = m[
            "crossed_pair_quality_score"]
        result["ribonanza_net_openknot_score"] = m["openknot_score"]

    if ref_c1 is not None and sub_c1 is not None:
        if ref_c1.shape[0] != sub_c1.shape[0]:
            raise ValueError("Reference and subject structures must contain "
                             "the same number of C1' atoms.")
        sup, _ = kabsch_superimpose(ref_c1, sub_c1)
        result["alphafold3_c1_prime_rmsd"] = rmsd(ref_c1, sup)
        result["alphafold3_c1_prime_lddt"] = lddt(ref_c1, sub_c1)
        # The reference computes its "gddt" as superposition-free lDDT with
        # an unbounded inclusion radius and GDT bins
        # (evaluation/na_eval_utils.py:3312-3318).
        result["alphafold3_c1_prime_gddt"] = lddt(
            ref_c1, sub_c1, inclusion_radius=10000.0,
            thresholds=(1.0, 2.0, 4.0, 8.0))
    for key in ("ptm", "pae", "plddt"):
        if key in af3:
            result[f"alphafold3_{key}"] = af3[key]

    out_path = os.path.join(output_directory, f"{subject['name']}.json")
    write_json_file(out_path, result)
    return out_path


# ---------------------------------------------------------------------------
# Dispatcher CLI (reference evaluation/na_eval_utils.py:3659-3753)
# ---------------------------------------------------------------------------

FUNCTIONS = {
    "design_nucleic_acid_sequence": design_nucleic_acid_sequence,
    "process_reference_monomer_rna": process_reference_monomer_rna,
    "process_design_monomer_rna": process_design_monomer_rna,
    "score_design_monomer_rna": score_design_monomer_rna,
    "predict_nucleic_acid_ppm": predict_nucleic_acid_ppm,
    "score_specificity_prediction": score_specificity_prediction,
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--function_name", required=True, choices=sorted(FUNCTIONS))
    p.add_argument("--structure_path")
    p.add_argument("--reference_structure_path")
    p.add_argument("--overall_output_directory")
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--num_batches", type=int, default=1)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--method", default="na_mpnn")
    p.add_argument("--na_mpnn_model_path")
    p.add_argument("--reference_ppms_list_str")
    p.add_argument("--subject_path")
    p.add_argument("--reference_path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    fn = FUNCTIONS[args.function_name]
    if args.function_name == "design_nucleic_acid_sequence":
        fn(args.structure_path, args.overall_output_directory,
           args.num_samples, args.temperature, args.method,
           args.na_mpnn_model_path, args.seed, args.device)
    elif args.function_name == "process_reference_monomer_rna":
        fn(args.reference_structure_path, args.overall_output_directory)
    elif args.function_name == "process_design_monomer_rna":
        fn(args.subject_path, args.overall_output_directory)
    elif args.function_name == "score_design_monomer_rna":
        fn(args.reference_path, args.subject_path,
           args.overall_output_directory)
    elif args.function_name == "predict_nucleic_acid_ppm":
        fn(args.structure_path, args.overall_output_directory,
           args.num_samples, args.temperature, args.num_batches, args.method,
           args.na_mpnn_model_path, args.seed, args.device)
    elif args.function_name == "score_specificity_prediction":
        fn(args.reference_ppms_list_str, args.subject_path,
           args.overall_output_directory)


if __name__ == "__main__":
    main()
