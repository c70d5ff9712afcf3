"""Dataset curation: database scan, clustering, sampling weights, splits.

Script-form port of the reference curation notebooks (reference
data/datasets/rcsb_cif/scan_rcsb_cif_database.py,
data/aggregate_datasets_and_split.ipynb, data/family_label_and_cluster.ipynb):

* ``scan_structure_database`` — per-structure metadata/coverage CSV rows;
* ``run_cdhit`` — CD-HIT(-EST) clustering wrapper (gated on the binary);
* ``compute_chain_cluster_degrees`` / ``compute_sampling_probability`` —
  cluster-degree balancing: sampling_probability = mean 1/(1+degree) across a
  structure's protein + nucleic chain clusters;
* ``split_train_valid_test_clusters`` / ``train_valid_test_split`` —
  cluster-level splits with a max valid/test cluster degree and optional
  forced-test clusters (e.g. pseudoknots).

The port's own copy of the JAX package's ``data/curation.py``, on rows:
where the JAX function takes or returns a ``pandas.DataFrame``, this one
takes and returns a list of row dicts (as ``csv.DictReader`` gives them),
and the CSVs and TSVs are read and written with ``csv``.
"""
from __future__ import annotations

import csv
import glob
import itertools
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np

from .dataset import read_csv_rows, write_csv_rows


# ---------------------------------------------------------------------------
# Database scan
# ---------------------------------------------------------------------------

SCAN_COLUMNS = ["label", "date", "method", "resolution", "poly", "poly_type",
                "nonpoly", "num_heavy", "coverage", "poly_sequence"]


def scan_structure_database(filenames: Sequence[str], parser=None,
                            skip_res=("HOH",)) -> list:
    """Parse structures -> metadata/coverage rows (reference
    scan_rcsb_cif_database.py:20-58). Keys: label, date, method,
    resolution, poly, poly_type, nonpoly, num_heavy, coverage, poly_sequence.
    """
    if parser is None:
        from .parsers import CIFParser
        parser = CIFParser(skip_res=list(skip_res))

    rows = []
    for fname in filenames:
        try:
            chains, asmb, covale, meta = parser.parse(fname)
            heavy = [a for c in chains.values() for a in c.atoms.values()]
            m = n = 0
            for _, res_atoms in itertools.groupby(heavy, key=lambda a: a.name[:3]):
                res_atoms = list(res_atoms)
                nobs = sum(a.occ > 0 for a in res_atoms)
                m += nobs
                if nobs > 0:
                    n += len(res_atoms)
            label = os.path.basename(fname)
            for ext in (".gz", ".cif", ".pdb"):
                if label.endswith(ext):
                    label = label[: -len(ext)]
            meta = meta or {}
            rows.append({
                "label": label,
                "date": meta.get("date"),
                "method": meta.get("method"),
                "resolution": meta.get("resolution"),
                "poly": [k for k, v in chains.items()
                         if "nonpoly" not in v.type],
                "poly_type": [v.type for v in chains.values()
                              if "nonpoly" not in v.type],
                "nonpoly": [k for k, v in chains.items()
                            if "nonpoly" in v.type],
                "num_heavy": n,
                "coverage": m / n if n > 0 else 0,
                "poly_sequence": [v.sequence for v in chains.values()
                                  if "nonpoly" not in v.type],
            })
        except Exception as e:  # noqa: BLE001 — scan must survive bad files
            print("ERROR:", fname, e)
    return rows


# ---------------------------------------------------------------------------
# Clustering (CD-HIT wrapper; the reference clusters chains with CD-HIT /
# CD-HIT-EST before computing sampling weights)
# ---------------------------------------------------------------------------

def run_cdhit(sequences: Dict[str, str], identity: float = 0.9,
              nucleic: bool = False, extra_args: Sequence[str] = ()) -> Dict[str, int]:
    """Cluster sequences with CD-HIT; returns name -> cluster id. Raises
    RuntimeError when the binary is missing."""
    binary = "cd-hit-est" if nucleic else "cd-hit"
    path = shutil.which(binary)
    if path is None:
        raise RuntimeError(f"{binary} not found on PATH")
    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "in.fa")
        with open(fasta, "w") as f:
            for name, seq in sequences.items():
                f.write(f">{name}\n{seq}\n")
        out = os.path.join(tmp, "out")
        word = ["-n", "8"] if nucleic else []
        subprocess.run([path, "-i", fasta, "-o", out, "-c", str(identity),
                        *word, *extra_args], check=True,
                       stdout=subprocess.DEVNULL)
        return parse_cdhit_clusters(out + ".clstr")


def parse_cdhit_clusters(clstr_path: str) -> Dict[str, int]:
    """Parse a CD-HIT .clstr file -> name -> cluster id (reference
    read_cdhit_cluster_file, evaluation/na_eval_utils.py:156-190)."""
    clusters: Dict[str, int] = {}
    cluster_id = -1
    for line in open(clstr_path):
        if line.startswith(">Cluster"):
            cluster_id = int(line.split()[1])
        elif line.strip():
            name = line.split(">")[1].split("...")[0]
            clusters[name] = cluster_id
    return clusters


# ---------------------------------------------------------------------------
# Sampling weights + splits (reference aggregate_datasets_and_split.ipynb)
# ---------------------------------------------------------------------------

def compute_chain_cluster_degrees(df, chain_cluster_ids_column: str) -> Dict:
    """Cluster id -> number of dataset rows containing it; also adds a
    *_degrees key to every row."""
    degree: Dict = {}
    for row in df:
        for cid in row[chain_cluster_ids_column]:
            degree[cid] = degree.get(cid, 0) + 1
    degrees_column = chain_cluster_ids_column.replace("ids", "degrees")
    for row in df:
        row[degrees_column] = [degree[c] for c in row[chain_cluster_ids_column]]
    return degree


def compute_sampling_probability(df,
                                 protein_degrees_column="protein_chain_cluster_degrees",
                                 na_degrees_column="nucleic_acid_chain_cluster_degrees"):
    """sampling_probability = mean of 1/(1+degree) over all of a structure's
    protein + nucleic chain cluster degrees."""
    for row in df:
        row["sampling_probability"] = float(np.mean(1.0 / (1.0 + np.asarray(
            list(row[protein_degrees_column]) + list(row[na_degrees_column]),
            dtype=np.float64))))
    return df


def split_train_valid_test_clusters(chain_cluster_to_degree: Dict,
                                    valid_fraction: float,
                                    test_fraction: float,
                                    max_valid_test_cluster_degree: Optional[int],
                                    extra_test_cluster_ids: Optional[Sequence] = None,
                                    seed: int = 0):
    """Pick valid/test cluster ids among low-degree clusters; everything else
    trains. Extra test ids (e.g. pseudoknot clusters) are forced into test."""
    rng = np.random.default_rng(seed)
    all_ids = list(chain_cluster_to_degree.keys())
    if max_valid_test_cluster_degree is None:
        candidates = list(all_ids)
    else:
        candidates = [c for c in all_ids
                      if chain_cluster_to_degree[c] <= max_valid_test_cluster_degree]
    extra = set(extra_test_cluster_ids or [])
    candidates = list(set(candidates) - extra)
    assert len(candidates) / max(len(all_ids), 1) >= (test_fraction + valid_fraction)

    test_ids = set(rng.choice(candidates, size=int(test_fraction * len(all_ids)),
                              replace=False).tolist())
    remaining = list(set(candidates) - test_ids)
    valid_ids = set(rng.choice(remaining, size=int(valid_fraction * len(all_ids)),
                               replace=False).tolist())
    test_ids |= extra
    train_ids = set(all_ids) - test_ids - valid_ids
    return train_ids, valid_ids, test_ids


def train_valid_test_split(df, chain_cluster_to_degree,
                           chain_cluster_ids_column: str,
                           output_directory: Optional[str] = None,
                           valid_fraction: float = 0.1,
                           test_fraction: float = 0.1,
                           max_valid_test_cluster_degree: Optional[int] = 25,
                           extra_test_cluster_ids=None, seed: int = 0):
    """Assign each structure to train/valid/test by its cluster memberships:
    a row goes to test if ANY of its clusters is a test cluster, then valid,
    else train. Writes train/valid/test.csv when output_directory is given."""
    train_ids, valid_ids, test_ids = split_train_valid_test_clusters(
        chain_cluster_to_degree, valid_fraction, test_fraction,
        max_valid_test_cluster_degree, extra_test_cluster_ids, seed)

    def assign(ids):
        ids = set(ids)
        if ids & test_ids:
            return "test"
        if ids & valid_ids:
            return "valid"
        return "train"

    df = [{**row, "split": assign(row[chain_cluster_ids_column])}
          for row in df]
    if output_directory:
        os.makedirs(output_directory, exist_ok=True)
        for split in ("train", "valid", "test"):
            write_csv_rows(os.path.join(output_directory, f"{split}.csv"),
                           [r for r in df if r["split"] == split],
                           list(df[0]) if df else ["split"])
    return df


# ---------------------------------------------------------------------------
# Protein family labeling (reference data/family_label_and_cluster.ipynb +
# data/family_label.sh: gather protein chain sequences, shard into FASTAs,
# InterProScan each shard against Pfam, recombine with the sequence mapping)
# ---------------------------------------------------------------------------

INTERPROSCAN_COLUMNS = [
    "protein_accession", "sequence_md5", "sequence_length", "analysis",
    "signature_accession", "signature_description", "start_location",
    "stop_location", "score", "status", "date", "interpro_accession",
    "interpro_description", "go_annotations", "pathway_annotations",
]

NA_CHAIN_TYPES = ("polydeoxyribonucleotide/polyribonucleotide hybrid",
                  "polydeoxyribonucleotide", "polyribonucleotide")


def gather_chain_sequences(preprocessing_csvs: Sequence[str],
                           chain_types: Sequence[str]) -> list:
    """Unique chain sequences of the given types across the datasets'
    per-structure sequences CSVs (notebook 'Gather All Protein Sequences')."""
    out = set()
    for path in preprocessing_csvs:
        for row in read_csv_rows(path)[0]:
            for r in read_csv_rows(row["sequences_path"])[0]:
                if r["chain_type"] in chain_types and r["sequence"]:
                    out.add(r["sequence"])
    return sorted(out)


def standardize_na_sequence(sequence: str) -> str:
    """U->T; anything outside ACGT -> X (notebook standardize_na_sequence) —
    the representation CD-HIT-EST clusters on."""
    table = {"A": "A", "C": "C", "G": "G", "T": "T", "U": "T"}
    return "".join(table.get(c, "X") for c in sequence)


def write_family_label_inputs(sequences: Sequence[str], out_dir: str,
                              num_jobs: int = 1000) -> str:
    """all_protein_sequences.fa (ids = enumerate index) + fasta_splits/ shard
    FASTAs for the array jobs. Returns the combined fasta path."""
    os.makedirs(out_dir, exist_ok=True)
    splits_dir = os.path.join(out_dir, "fasta_splits")
    os.makedirs(splits_dir, exist_ok=True)
    pairs = list(enumerate(sequences))
    fasta_path = os.path.join(out_dir, "all_protein_sequences.fa")
    with open(fasta_path, "w") as f:
        f.write("\n".join(f">{i}\n{s}" for i, s in pairs))
    per_job = (len(pairs) + num_jobs - 1) // max(num_jobs, 1)
    for job in range(num_jobs):
        chunk = pairs[job * per_job:(job + 1) * per_job]
        with open(os.path.join(splits_dir,
                               f"all_protein_sequences_{job}.fa"), "w") as f:
            f.write("\n".join(f">{i}\n{s}" for i, s in chunk))
    return fasta_path


def run_interproscan(fasta_path: str, output_path: str,
                     applications: str = "Pfam"):
    """One InterProScan shard (reference family_label.sh). Site config:
    INTERPROSCAN_CMD (launcher, e.g. '/path/interproscan.sh')."""
    cmd = os.environ.get("INTERPROSCAN_CMD")
    if not cmd:
        raise RuntimeError("InterProScan not configured (set INTERPROSCAN_CMD)")
    subprocess.run(cmd.split() + ["-i", fasta_path, "-f", "tsv",
                                  "-o", output_path, "-appl", applications],
                   check=True)


def combine_family_labels(label_output_dir: str,
                          all_sequences_fasta: str) -> list:
    """Concatenate the per-shard InterProScan TSVs, map the temporary integer
    accessions back to sequences, and drop the accession column (notebook
    'Run InterScanPro and Process Results'). Rows in accession order (a
    stable sort: the hits of one accession keep their order)."""
    rows = []
    for name in sorted(os.listdir(label_output_dir)):
        path = os.path.join(label_output_dir, name)
        if not os.path.isfile(path) or os.path.getsize(path) == 0:
            continue
        with open(path, newline="") as f:
            for fields in csv.reader(f, delimiter="\t"):
                if fields:
                    fields += [""] * (len(INTERPROSCAN_COLUMNS) - len(fields))
                    rows.append(dict(zip(INTERPROSCAN_COLUMNS, fields)))
    rows.sort(key=lambda r: int(r["protein_accession"]))

    id_to_seq = {}
    header = None
    for line in open(all_sequences_fasta):
        line = line.strip()
        if line.startswith(">"):
            header = line[1:]
        elif line and header is not None:
            id_to_seq[header] = line
    out = []
    for r in rows:
        accession = r.pop("protein_accession")
        out.append({**r, "sequence": id_to_seq.get(str(int(accession)))})
    return out


def family_label_pipeline(preprocessing_csvs: Sequence[str], out_dir: str,
                          num_jobs: int = 1000,
                          run_shards: bool = True) -> list:
    """Full stage: gather -> shard -> InterProScan each shard -> combine ->
    all_protein_family_labels.csv. With run_shards=False only the inputs are
    written (use the Slurm array like the reference)."""
    sequences = gather_chain_sequences(preprocessing_csvs, ("polypeptide(L)",))
    fasta = write_family_label_inputs(sequences, out_dir, num_jobs)
    label_dir = os.path.join(out_dir, "out")
    os.makedirs(label_dir, exist_ok=True)
    if run_shards:
        for job in range(num_jobs):
            shard = os.path.join(out_dir, "fasta_splits",
                                 f"all_protein_sequences_{job}.fa")
            if os.path.getsize(shard) > 0:
                run_interproscan(shard, os.path.join(
                    label_dir, f"family_label_{job}.csv"))
    df = combine_family_labels(label_dir, fasta)
    write_csv_rows(os.path.join(out_dir, "all_protein_family_labels.csv"), df,
                   INTERPROSCAN_COLUMNS[1:] + ["sequence"])
    return df


def main(argv=None):
    """CLI: scan a structure database shard into a CSV (role of the
    reference's Slurm-sharded scan script)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("glob_pattern")
    p.add_argument("output_csv")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    args = p.parse_args(argv)
    fnames = sorted(glob.glob(args.glob_pattern))[args.start:args.end]
    write_csv_rows(args.output_csv, scan_structure_database(fnames), SCAN_COLUMNS)


if __name__ == "__main__":
    main()
