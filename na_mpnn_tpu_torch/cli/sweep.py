"""Checkpoint-sweep scoring on released splits.

The reference selects its released checkpoints by scoring every saved
``s_<step>`` on the validation splits — sequence recovery for the design
model, PPM agreement for the specificity model — via Slurm array fan-out
(reference evaluation/evaluation_cmds.txt:1-63, splits/README.md). This CLI
is the one-command equivalent: point it at a checkpoint directory and a
structure CSV (optionally filtered by a released split JSON), and it emits a
per-checkpoint metric table plus the argmax.

    python -m na_mpnn_tpu_torch.cli.sweep \
        --checkpoint_dir runs/design/ --structures_csv design_valid.csv \
        --split /path/splits/design_valid.json --mode design \
        --num_samples 10 --temperature 0.1 --out sweep.json [--device cuda]

CSV columns: ``structure_path`` (PDB files); specificity mode additionally
uses ``ppm_paths`` (the reference's PPM list-string format consumed by
data.dataset.load_ppms; the older ``reference_ppms`` spelling is accepted). Shard across machines with --modulo/--remainder
like the reference's array jobs (data/preprocess_dataset.sh pattern).

The port's own copy of the JAX package's ``cli/sweep.py``: the CSV is read
with ``csv`` into row dicts, and every structure runs through the port's
harness on ``--device`` (default ``cuda``). ``s_*.orbax`` directories are
listed as the JAX sweep lists them, and refused when loaded
(``params.load_params_any``). ``--pad_to_bucket`` keeps the JAX default of
64: the JAX package pads to share compiled executables; the port has no
per-shape compile, and pads so that a sweep featurises the same padded
shapes as the JAX sweep does.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np


def list_checkpoints(checkpoint_dir: str) -> List[str]:
    """All s_<step> checkpoints (.npz native or .pt reference format),
    sorted by step."""
    paths = []
    for ext in ("npz", "pt", "orbax"):
        paths.extend(glob.glob(os.path.join(checkpoint_dir, f"s_*.{ext}")))

    def step_of(p):
        m = re.search(r"s_(\d+)\.(npz|pt|orbax)$", os.path.basename(p))
        return int(m.group(1)) if m else -1

    return sorted((p for p in paths if step_of(p) >= 0), key=step_of)


def _structure_rows(structures_csv: str, split: Optional[str],
                    modulo: int, remainder: int):
    from ..data.dataset import read_csv_rows
    from ..data.splits import filter_dataframe_by_split, load_design_split

    rows = read_csv_rows(structures_csv)[0]
    if split:
        if not split.endswith(".json"):
            raise ValueError(
                f"--split expects a released split JSON, got: {split}")
        rows = filter_dataframe_by_split(rows, load_design_split(split))
    return [r for i, r in enumerate(rows) if i % modulo == remainder]


def score_design_checkpoint(checkpoint_path: str, structure_paths: List[str],
                            num_samples: int, temperature: float,
                            seed: int, workdir: str,
                            pad_to_bucket: int = 0, device="cuda") -> Dict:
    """Mean native-sequence recovery of sampled designs over the structures
    (the design-sweep metric, evaluation_cmds.txt:1-27)."""
    from ..eval.harness import run_na_mpnn_sequence

    recs = []
    for sp in structure_paths:
        out_dir = os.path.join(
            workdir, os.path.splitext(os.path.basename(sp))[0])
        designs = run_na_mpnn_sequence(
            sp, output_directory=out_dir, batch_size=num_samples,
            number_of_batches=1, temperature=temperature,
            na_mpnn_model_path=checkpoint_path, seed=seed,
            pad_to_bucket=pad_to_bucket, device=device)
        recs.extend(d["tool_reported_sequence_recovery"] for d in designs)
    return {"metric": "sequence_recovery",
            "value": float(np.mean(recs)) if recs else float("nan"),
            "n_designs": len(recs)}


def score_teacher_forced_checkpoint(checkpoint_path: str,
                                    structure_paths: List[str],
                                    num_samples: int, seed: int,
                                    workdir: str,
                                    pad_to_bucket: int = 0,
                                    device="cuda") -> Dict:
    """Teacher-forced argmax recovery over random decode orders — one
    parallel-decoder pass per order instead of a full autoregressive decode,
    making this the cheap sweep metric (models.score; role of reference
    model_utils.py:366-424)."""
    from ..eval.harness import run_na_mpnn_score

    recs, losses = [], []
    for sp in structure_paths:
        out_dir = os.path.join(
            workdir, os.path.splitext(os.path.basename(sp))[0])
        stats = run_na_mpnn_score(
            sp, output_directory=out_dir, batch_size=num_samples,
            number_of_batches=1, na_mpnn_model_path=checkpoint_path,
            seed=seed, pad_to_bucket=pad_to_bucket, device=device)
        recs.extend(np.asarray(stats["recovery_argmax"]).ravel().tolist())
        losses.extend(np.asarray(stats["loss"]).ravel().tolist())
    return {"metric": "teacher_forced_recovery",
            "value": float(np.mean(recs)) if recs else float("nan"),
            "mean_loss": float(np.mean(losses)) if losses else float("nan"),
            "n_orders": len(recs)}


def score_specificity_checkpoint(checkpoint_path: str, rows,
                                 num_samples: int, temperature: float,
                                 seed: int, workdir: str,
                                 pad_to_bucket: int = 0,
                                 device="cuda") -> Dict:
    """Mean PPM Pearson correlation of predicted vs experimental PPMs
    (the specificity-sweep metric, evaluation_cmds.txt:29-63)."""
    from ..data.dataset import load_ppms
    from ..eval.harness import run_na_mpnn_specificity
    from ..eval.scoring import score_specificity_arrays

    pearsons = []
    for row in rows:
        sp = row["structure_path"]
        out_dir = os.path.join(
            workdir, os.path.splitext(os.path.basename(sp))[0])
        spec = run_na_mpnn_specificity(
            sp, output_directory=out_dir, batch_size=num_samples,
            number_of_batches=1, temperature=temperature,
            na_mpnn_model_path=checkpoint_path, seed=seed,
            pad_to_bucket=pad_to_bucket, device=device)
        # The specificity-CSV contract column is "ppm_paths"
        # (dataset_recipes.attach_ppm_paths, EVALUATION.md); accept the older
        # "reference_ppms" spelling too.
        ppm_col = "ppm_paths" if "ppm_paths" in row else "reference_ppms"
        reference_ppms, _ = load_ppms(row[ppm_col],
                                      randomize_experimental_ppms=False)
        result = score_specificity_arrays(
            reference_ppms,
            np.asarray(spec["true_sequence"], np.int64),
            np.asarray(spec["chain_labels"], np.int32),
            np.asarray(spec["protein_mask"], np.int32),
            np.asarray(spec["dna_mask"], np.int32),
            np.asarray(spec["rna_mask"], np.int32),
            np.asarray(spec["predicted_ppm"], np.float64),
            np.asarray(spec["mask"], np.int32))
        vals = [result[k] for k in ("pearson_dna", "pearson_rna")
                if np.isfinite(result.get(k, np.nan))]
        if vals:
            pearsons.append(float(np.mean(vals)))
    return {"metric": "ppm_pearson",
            "value": float(np.mean(pearsons)) if pearsons else float("nan"),
            "n_structures": len(pearsons)}


def run_sweep(checkpoint_dir: str, structures_csv: str, mode: str,
              split: Optional[str] = None, num_samples: int = 10,
              temperature: Optional[float] = None, seed: int = 0,
              out: Optional[str] = None, workdir: Optional[str] = None,
              modulo: int = 1, remainder: int = 0,
              checkpoints: Optional[List[str]] = None,
              pad_to_bucket: int = 64, device="cuda") -> Dict:
    if temperature is None:
        temperature = 0.1 if mode == "design" else 0.5
    workdir = workdir or os.path.join(checkpoint_dir, "sweep_work")
    ckpts = checkpoints or list_checkpoints(checkpoint_dir)
    if not ckpts:
        raise ValueError(f"no s_*.npz / s_*.pt checkpoints in {checkpoint_dir}")
    rows = _structure_rows(structures_csv, split, modulo, remainder)

    table = []
    for ck in ckpts:
        ck_work = os.path.join(workdir, os.path.splitext(os.path.basename(ck))[0])
        if mode == "design":
            res = score_design_checkpoint(
                ck, [r["structure_path"] for r in rows], num_samples,
                temperature, seed, ck_work, pad_to_bucket=pad_to_bucket,
                device=device)
        elif mode == "specificity":
            res = score_specificity_checkpoint(
                ck, rows, num_samples, temperature, seed, ck_work,
                pad_to_bucket=pad_to_bucket, device=device)
        elif mode == "score":
            res = score_teacher_forced_checkpoint(
                ck, [r["structure_path"] for r in rows], num_samples, seed,
                ck_work, pad_to_bucket=pad_to_bucket, device=device)
        else:
            raise ValueError(f"invalid mode: {mode}")
        entry = {"checkpoint": ck, **res}
        table.append(entry)
        print(json.dumps(entry))

    valid = [e for e in table if np.isfinite(e["value"])]
    best = max(valid, key=lambda e: e["value"]) if valid else None
    result = {"mode": mode, "structures_csv": structures_csv, "split": split,
              "num_samples": num_samples, "temperature": temperature,
              "table": table, "best_checkpoint": best}
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--structures_csv", required=True)
    p.add_argument("--mode", choices=["design", "specificity", "score"], required=True)
    p.add_argument("--split", help="released split JSON to filter the CSV by")
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help="write the sweep table JSON here")
    p.add_argument("--workdir")
    p.add_argument("--modulo", type=int, default=1,
                   help="shard structures across machines")
    p.add_argument("--remainder", type=int, default=0)
    p.add_argument("--pad_to_bucket", type=int, default=64,
                   help="pad structures to multiples of this length, the "
                        "padded shapes of the JAX sweep; 0 disables")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)
    run_sweep(args.checkpoint_dir, args.structures_csv, args.mode,
              split=args.split, num_samples=args.num_samples,
              temperature=args.temperature, seed=args.seed, out=args.out,
              workdir=args.workdir, modulo=args.modulo,
              remainder=args.remainder, pad_to_bucket=args.pad_to_bucket,
              device=args.device)


if __name__ == "__main__":
    main()
