"""Wrappers for external evaluation binaries (DSSR, EternaFold, US-align,
AlphaFold3, RibonanzaNet, DeepPBS, gRNAde, RhoDesign).

These mirror the reference harness's subprocess layer (reference
evaluation/na_eval_utils.py:594-866,1034-1415,1705-1836,2511-2786): the
binaries are evaluation-only dependencies that are not shipped; every wrapper
checks availability and raises ExternalToolUnavailable with the exact command
it would have run, so pipelines can skip the metric gracefully.

The port's own copy of the JAX package's ``eval/external.py``; its
RibonanzaNet stage runs the port's ``eval/ribonanza_runner.py``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np

from .scoring import standardize_rna_sequence, standardize_secondary_structure


class ExternalToolUnavailable(RuntimeError):
    pass


def _require(binary: str, env_var: Optional[str] = None) -> str:
    path = os.environ.get(env_var) if env_var else None
    path = path or shutil.which(binary)
    if not path:
        raise ExternalToolUnavailable(
            f"{binary} not found on PATH"
            + (f" (set {env_var})" if env_var else ""))
    return path


def parse_dssr_output(text: str):
    """(sequence, dot_bracket) from a DSSR text report: scan for the
    '>...' FASTA-style header in the secondary-structure section and take the
    following sequence + dot-bracket lines, validating each line's charset
    (sturdier than a single whole-output regex — DSSR reports vary in
    surrounding sections)."""
    seq_chars = set("ACGUTNacgutn&?.xX")
    ss_chars = set(".()[]{}<>&,?") | set(
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz")
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if not line.startswith(">"):
            continue
        rest = [ln.strip() for ln in lines[i + 1:i + 3]]
        if len(rest) == 2 and rest[0] and rest[1] \
                and set(rest[0]) <= seq_chars and set(rest[1]) <= ss_chars \
                and len(rest[0]) == len(rest[1]):
            return rest[0], rest[1]
    m = re.search(r">.*\n([ACGUacgu&?\.\w]+)\n([\.\(\)\[\]\{\}<>A-Za-z&,?]+)",
                  text)
    if m:
        return m.group(1), m.group(2)
    raise RuntimeError("could not parse DSSR output")


def run_dssr(structure_path: str, dssr_binary: str = "x3dna-dssr") -> Dict:
    """Extract sequence + dot-bracket secondary structure with DSSR
    (reference run_dssr, evaluation/na_eval_utils.py:594-664)."""
    binary = _require(dssr_binary, "DSSR_BINARY")
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [binary, f"--input={structure_path}", "--output=dssr_out.txt"],
            cwd=tmp, capture_output=True, text=True, check=True)
        text = open(os.path.join(tmp, "dssr_out.txt")).read()
    try:
        raw_seq, raw_ss = parse_dssr_output(text)
    except RuntimeError as e:
        raise RuntimeError(f"{e} for {structure_path}") from e
    sequence = standardize_rna_sequence(raw_seq, method="dssr")
    ss = standardize_secondary_structure(raw_ss, method="dssr")
    return {"sequence": sequence, "secondary_structure": ss, "raw": text,
            "stdout": out.stdout}


def run_eternafold(sequence: str, eternafold_binary: str = "eternafold") -> Dict:
    """Predict secondary structure with EternaFold (reference run_eternafold,
    evaluation/na_eval_utils.py:669-729)."""
    binary = _require(eternafold_binary, "ETERNAFOLD_BINARY")
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        f.write(f">query\n{sequence}\n")
        fasta = f.name
    try:
        out = subprocess.run([binary, "predict", fasta], capture_output=True,
                             text=True, check=True)
    finally:
        os.unlink(fasta)
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    ss = standardize_secondary_structure(lines[-1].strip())
    return {"predicted_secondary_structure": ss,
            "secondary_structure": ss}


def run_us_align(reference_structure_path: str, subject_structure_path: str,
                 usalign_binary: str = "USalign") -> Dict:
    """TM-score / RMSD via US-align (reference run_us_align,
    evaluation/na_eval_utils.py:1705-1836)."""
    binary = _require(usalign_binary, "USALIGN_BINARY")
    out = subprocess.run(
        [binary, subject_structure_path, reference_structure_path,
         "-mol", "RNA"],
        capture_output=True, text=True, check=True)
    tm = None
    rmsd = None
    for line in out.stdout.splitlines():
        m = re.match(r"TM-score=\s*([\d.]+)", line)
        if m and tm is None:
            tm = float(m.group(1))
        m = re.search(r"RMSD=\s*([\d.]+)", line)
        if m and rmsd is None:
            rmsd = float(m.group(1))
    return {"tm_score": tm, "rmsd": rmsd, "stdout": out.stdout}


def run_alphafold3(name: str, sequence: str, output_directory: str,
                   af3_cmd: Optional[List[str]] = None) -> Dict:
    """Fold an RNA sequence with AlphaFold3 (reference run_alphafold3,
    evaluation/na_eval_utils.py:871-1029). `af3_cmd` is the site-specific
    launcher (the reference shells into an apptainer image)."""
    if af3_cmd is None:
        raise ExternalToolUnavailable(
            "AlphaFold3 launcher not configured (pass af3_cmd or set up a "
            "site launcher)")
    os.makedirs(output_directory, exist_ok=True)
    request = {
        "name": name,
        "sequences": [{"rna": {"id": "A", "sequence": sequence}}],
        "modelSeeds": [1],
        "dialect": "alphafold3",
        "version": 1,
    }
    request_path = os.path.join(output_directory, f"{name}_af3_input.json")
    with open(request_path, "w") as f:
        json.dump(request, f)
    subprocess.run(list(af3_cmd) + ["--json_path", request_path,
                                    "--output_dir", output_directory],
                   check=True)
    model_dir = os.path.join(output_directory, name.lower())
    result = {"output_directory": model_dir,
              "predicted_structure_path": os.path.join(
                  model_dir, f"{name.lower()}_model.cif")}
    # Confidence summary (ptm / pae / plddt), when AF3 emitted it (reference
    # run_alphafold3 output parse, evaluation/na_eval_utils.py:985-1025).
    summary = os.path.join(model_dir, f"{name.lower()}_summary_confidences.json")
    conf = os.path.join(model_dir, f"{name.lower()}_confidences.json")
    try:
        if os.path.exists(summary):
            s = json.load(open(summary))
            result["ptm"] = s.get("ptm")
        if os.path.exists(conf):
            c = json.load(open(conf))
            if "pae" in c:
                result["pae"] = float(np.mean(c["pae"]))
            if "atom_plddts" in c:
                result["plddt"] = float(np.mean(c["atom_plddts"]))
    except (json.JSONDecodeError, OSError):
        pass
    return result


def _run_ribonanza_runner(mode: str, sequence: str, batch_size: int) -> Dict:
    """Invoke the first-party runner (eval/ribonanza_runner.py — our
    equivalent of the reference's shipped evaluation/run_ribonanza_net.py)
    in a subprocess; requires the RIBONANZA_NET_* site config."""
    if not os.environ.get("RIBONANZA_NET_DIR"):
        raise ExternalToolUnavailable(
            "RibonanzaNet not configured (set RIBONANZA_NET_DIR + "
            "RIBONANZA_NET_WEIGHTS / RIBONANZA_NET_SS_WEIGHTS)")
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run(
            [sys.executable, "-m", "na_mpnn_tpu_torch.eval.ribonanza_runner",
             mode, sequence, tmp, str(batch_size)],
            check=True)
        return np.load(os.path.join(tmp, "output.npy"),
                       allow_pickle=True).item()


def run_ribonanza_net_reactivity_profile(sequence: str,
                                         batch_size: int = 1) -> Dict:
    """Predicted 2A3/DMS reactivity profiles (reference
    run_ribonanza_net_reactivity_profile, evaluation/na_eval_utils.py:731-799)."""
    from .scoring import check_rna_sequence_validity
    check_rna_sequence_validity(sequence, unknown_residue_allowed=False,
                                chain_breaks_allowed=False)
    out = _run_ribonanza_runner("reactivity_profile", sequence, batch_size)
    return {
        "predicted_2A3_reactivity_profiles":
            out["predicted_2A3_reactivity_profiles"],
        "predicted_DMS_reactivity_profiles":
            out["predicted_DMS_reactivity_profiles"],
    }


def run_ribonanza_net_secondary_structure(sequence: str,
                                          batch_size: int = 1) -> Dict:
    """Predicted dot-bracket structures (reference
    run_ribonanza_net_secondary_structure, evaluation/na_eval_utils.py:802-866)."""
    from .scoring import check_rna_sequence_validity
    check_rna_sequence_validity(sequence, unknown_residue_allowed=False,
                                chain_breaks_allowed=False)
    out = _run_ribonanza_runner("secondary_structure", sequence, batch_size)
    return {"predicted_secondary_structures":
            out["predicted_secondary_structures"]}


# Back-compat single-call wrapper.
def run_ribonanza_net(sequence: str) -> Dict:
    return {**run_ribonanza_net_reactivity_profile(sequence),
            **run_ribonanza_net_secondary_structure(sequence)}


# ---------------------------------------------------------------------------
# Specificity / design baselines (DeepPBS, gRNAde, RhoDesign)
# ---------------------------------------------------------------------------

def _tool_cmd(env_var: str, tool: str) -> List[str]:
    """Site launcher prefix for a containerized tool, e.g.
    DEEPPBS_CMD="apptainer exec /path/deeppbs.sif" (the reference hard-codes
    its cluster's apptainer paths; here they are env-configured)."""
    cmd = os.environ.get(env_var)
    if not cmd:
        raise ExternalToolUnavailable(
            f"{tool} launcher not configured (set {env_var})")
    return cmd.split()


def deeppbs_output_to_result(npz_dict: Dict, structure_name: str,
                             structure_path: str) -> Dict:
    """Convert DeepPBS's raw prediction npz into the NA-MPNN specificity
    result contract (reference run_deeppbs post-processing,
    evaluation/na_eval_utils.py:1341-1401): append the reverse-complement
    strand (both PPM and sequence flipped on both axes) as a second chain and
    map the 4-letter PPM into the 33-column NA-MPNN format."""
    from .. import constants

    ppm = np.asarray(npz_dict["P"], np.float64)              # [L, 4] ACGT
    seq_onehot = np.asarray(npz_dict["Seq"])                 # [L, 4]
    bp_ppm = np.flip(np.flip(ppm, axis=1), axis=0)
    bp_seq = np.flip(np.flip(seq_onehot, axis=1), axis=0)
    chain_labels = np.concatenate([
        np.zeros(ppm.shape[0], np.int32), np.ones(bp_ppm.shape[0], np.int32)])
    ppm = np.concatenate([ppm, bp_ppm], axis=0)
    seq_onehot = np.concatenate([seq_onehot, bp_seq], axis=0)

    t = constants.restype_to_int_table(True)
    deep_pbs_cols = {"DA": 0, "DC": 1, "DG": 2, "DT": 3}
    predicted = np.zeros((ppm.shape[0], constants.NUM_LETTERS), np.float64)
    for res, col in deep_pbs_cols.items():
        predicted[:, t[res]] = ppm[:, col]
    int_to_res = {v: k for k, v in deep_pbs_cols.items()}
    true_seq = [t[int_to_res[int(i)]] for i in np.argmax(seq_onehot, axis=-1)]

    n = len(predicted)
    return {
        "input_structure_name": structure_name,
        "input_structure_path": structure_path,
        "name": structure_name,
        "predicted_ppm_na_mpnn_format": predicted,
        "true_sequence_na_mpnn_format": true_seq,
        "chain_labels": chain_labels,
        "mask": [1] * n,
        "protein_mask": [0] * n,
        "dna_mask": [1] * n,
        "rna_mask": [0] * n,
        "encoded_residues": None,
        "encoded_residues_dict": None,
        "specificity_method": "deeppbs",
        "model_weights_path": None,
        "num_samples": 1,
        "temperature": None,
    }


def run_deeppbs(structure_path: str, output_directory: Optional[str] = None) -> Dict:
    """Protein-DNA specificity via DeepPBS (reference run_deeppbs,
    evaluation/na_eval_utils.py:1202-1413). Site config: DEEPPBS_CMD (launcher
    prefix) + DEEPPBS_DIR (DeepPBS checkout)."""
    structure_path = os.path.abspath(structure_path)
    if not os.path.exists(structure_path):
        raise ValueError(f"Invalid structure path: {structure_path}")
    launcher = _tool_cmd("DEEPPBS_CMD", "DeepPBS")
    deeppbs_dir = os.environ.get("DEEPPBS_DIR", "")
    structure_name, ext = os.path.splitext(os.path.basename(structure_path))

    with tempfile.TemporaryDirectory() as tmp:
        pdb_dir = os.path.join(tmp, "pdb")
        os.makedirs(pdb_dir)
        shutil.copy(structure_path, pdb_dir)
        input_txt = os.path.join(tmp, "input.txt")
        open(input_txt, "w").write(f"{structure_name}{ext}")
        os.makedirs(os.path.join(tmp, "npz"))
        predict_txt = os.path.join(tmp, "predict_input.txt")
        open(predict_txt, "w").write(f"{structure_name}.npz")
        out_dir = os.path.join(tmp, "output")
        os.makedirs(out_dir)
        subprocess.run(
            launcher + ["python",
                        os.path.join(deeppbs_dir, "run", "process_co_crystal.py"),
                        input_txt,
                        os.path.join(deeppbs_dir, "run", "process",
                                     "process_config.json"),
                        "--no_pwm"],
            check=True, cwd=tmp)
        subprocess.run(
            launcher + ["python", os.path.join(deeppbs_dir, "run", "predict.py"),
                        predict_txt, out_dir, "-c",
                        os.path.join(deeppbs_dir, "run", "process",
                                     "pred_configs", "pred_config_deeppbs.json")],
            check=True, cwd=tmp)
        out_npz = os.path.join(out_dir, "npzs",
                               f"{structure_name}.npz_predict.npz")
        if not os.path.exists(out_npz):
            raise ValueError(f"Output file not found: {out_npz}")
        raw = dict(np.load(out_npz, allow_pickle=True))
        if output_directory:
            spec_dir = os.path.join(output_directory, "specificity")
            os.makedirs(spec_dir, exist_ok=True)
            shutil.copy(out_npz, os.path.join(spec_dir, f"{structure_name}.npz"))
    return deeppbs_output_to_result(raw, structure_name, structure_path)


def parse_grnade_fasta(fasta_entries, structure_name: str,
                       structure_path: str) -> List[Dict]:
    """gRNAde FASTA -> design dicts (reference run_grnade parse,
    evaluation/na_eval_utils.py:2650-2695). Entry 0 is the native sequence."""
    design_data = []
    for header, seq in fasta_entries[1:]:
        meta = {}
        for item in header.strip().split(", "):
            if "=" in item:
                k, v = item.strip().split("=", 1)
                meta[k] = v
        design_data.append({
            "input_structure_name": structure_name,
            "input_structure_path": structure_path,
            "design_id": meta["sample"],
            "name": f"{structure_name}_{meta['sample']}",
            "design_sequence": seq.replace("\n", ""),
            "tool_reported_sequence_recovery": float(meta["recovery"]),
            "design_method": "grnade",
            "model_weights_path": "",
        })
    return design_data


def run_grnade(structure_path: str, output_directory: Optional[str] = None,
               n_samples: int = 1, temperature: float = 0.1) -> List[Dict]:
    """RNA design via gRNAde (reference run_grnade,
    evaluation/na_eval_utils.py:2511-2637). Site config: GRNADE_CMD +
    GRNADE_SCRIPT (path to gRNAde.py)."""
    structure_path = os.path.abspath(structure_path)
    if not os.path.exists(structure_path):
        raise ValueError(f"Structure file not found: {structure_path}")
    launcher = _tool_cmd("GRNADE_CMD", "gRNAde")
    script = os.environ.get("GRNADE_SCRIPT", "gRNAde.py")
    structure_name = os.path.splitext(os.path.basename(structure_path))[0]

    tmp_ctx = tempfile.TemporaryDirectory() if output_directory is None else None
    out_dir = tmp_ctx.name if tmp_ctx else os.path.abspath(output_directory)
    try:
        seqs_dir = os.path.join(out_dir, "seqs")
        os.makedirs(seqs_dir, exist_ok=True)
        fasta_path = os.path.join(seqs_dir, f"{structure_name}.fa")
        subprocess.run(
            launcher + ["python", script,
                        "--pdb_filepath", structure_path,
                        "--output_filepath", fasta_path,
                        "--split", "das", "--max_num_conformers", "1",
                        "--n_samples", str(n_samples),
                        "--temperature", str(temperature)],
            check=True)
        if not os.path.exists(fasta_path):
            raise ValueError(f"Output fasta file not found: {fasta_path}")
        from .harness import read_fasta_file
        return parse_grnade_fasta(read_fasta_file(fasta_path), structure_name,
                                  structure_path)
    finally:
        if tmp_ctx:
            tmp_ctx.cleanup()


def parse_rhodesign_output(output_text: str):
    """Extract (sequence, recovery) from RhoDesign stdout (reference
    run_rhodesign parse, evaluation/na_eval_utils.py:2745-2753)."""
    sequence, recovery = None, None
    for line in output_text.split("\n"):
        if line.startswith("sequence: "):
            sequence = line.split(": ", 1)[1].strip()
        elif line.startswith("recovery rate: "):
            recovery = line.split(": ", 1)[1].strip()
    if sequence is None or recovery is None:
        raise ValueError("could not parse RhoDesign output")
    return sequence, float(recovery)


def run_rhodesign(structure_path: str, output_directory: Optional[str] = None,
                  n_samples: int = 1, temperature: float = 0.1) -> List[Dict]:
    """RNA design via RhoDesign (reference run_rhodesign,
    evaluation/na_eval_utils.py:2642-2786): one subprocess per sample, parse
    stdout, aggregate a FASTA. Site config: RHODESIGN_CMD + RHODESIGN_SCRIPT."""
    structure_path = os.path.abspath(structure_path)
    if not os.path.exists(structure_path):
        raise ValueError(f"Structure file not found: {structure_path}")
    launcher = _tool_cmd("RHODESIGN_CMD", "RhoDesign")
    script = os.environ.get("RHODESIGN_SCRIPT", "inference_without2d.py")
    structure_name = os.path.splitext(os.path.basename(structure_path))[0]

    tmp_ctx = tempfile.TemporaryDirectory() if output_directory is None else None
    out_dir = tmp_ctx.name if tmp_ctx else os.path.abspath(output_directory)
    try:
        seqs_dir = os.path.join(out_dir, "seqs")
        os.makedirs(seqs_dir, exist_ok=True)
        fasta_entries, design_data = [], []
        for i in range(n_samples):
            with tempfile.TemporaryDirectory() as sample_dir:
                proc = subprocess.run(
                    launcher + ["python", script, "-pdb", structure_path,
                                "-save", sample_dir, "-temp", str(temperature)],
                    check=True, capture_output=True, text=True)
            sequence, recovery = parse_rhodesign_output(proc.stdout)
            fasta_entries.append(
                (f"{structure_name}, id={i}, seq_rec={recovery}", sequence))
            design_data.append({
                "input_structure_name": structure_name,
                "input_structure_path": structure_path,
                "design_id": str(i),
                "name": f"{structure_name}_{i}",
                "design_sequence": sequence,
                "tool_reported_sequence_recovery": recovery,
                "design_method": "rhodesign",
                "model_weights_path": "",
            })
        from .harness import write_fasta_file
        write_fasta_file(os.path.join(seqs_dir, f"{structure_name}.fa"),
                         fasta_entries)
        return design_data
    finally:
        if tmp_ctx:
            tmp_ctx.cleanup()
