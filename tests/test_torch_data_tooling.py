"""The port's data tooling (``data/curation.py``, ``data/dataset_recipes.py``)
against the JAX package's on the same inputs. The port works on lists of
row dicts (as ``csv.DictReader`` gives them); the JAX functions get a
``pandas.DataFrame`` of the same rows. Both must give the same rows, the
same numbers (numpy from a seed; the same code, so equal) and the same CSV
files. Mirrors ``tests/test_dataset_recipes.py`` and the curation cases of
``tests/test_utils_misc.py``."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import csv
import os

import numpy as np
import pandas as pd
import pytest

from na_mpnn_tpu.data import curation as jcur
from na_mpnn_tpu.data import dataset_recipes as jdr

from chip_smoke import write_synthetic_cif, write_synthetic_pdb
from na_mpnn_tpu_torch.data import curation as tcur
from na_mpnn_tpu_torch.data import dataset_recipes as tdr

JASPAR = """>MA0001.1 TEST
A  [  4 19  0 ]
C  [ 16  0 20 ]
G  [  0  1  0 ]
T  [  0  0  0 ]
"""

HOCOMOCO = """>TEST_MOTIF
10 0 0 10
0 20 0 0
0 0 0 0
"""

CISBP = """TF Name\tTEST
Motif\tM001

Pos\tA\tC\tG\tT
1\t0.7\t0.1\t0.1\t0.1
2\t0.25\t0.25\t0.25\t0.25

3\t0.0\t0.3\t0.3\t0.4
"""

TRANSFAC = """VV  TRANSFAC MATRIX TABLE
//
AC  V$TEST_01
XX
P0      A      C      G      T
01      1      0      0      3      W
02      0      4      0      0      C
XX
//
AC  V$OTHER_02
XX
P0      A      C      G      T
01      2      2      0      0      M
XX
//
"""


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _records(df):
    return df.to_dict("records")


# ---------------------------------------------------------------------------
# dataset_recipes: motif converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,text", [("load_ppm_jaspar", JASPAR),
                                     ("load_ppm_hocomoco", HOCOMOCO),
                                     ("load_ppm_cisbp", CISBP)])
def test_motif_converters(fn, text):
    want, got = getattr(jdr, fn)(text), getattr(tdr, fn)(text)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_transfac_converter():
    want, got = jdr.parse_transfac_matrices(TRANSFAC), tdr.parse_transfac_matrices(TRANSFAC)
    assert list(got) == list(want) == ["V$TEST_01", "V$OTHER_02"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("fmt,text", [("jaspar", JASPAR), ("hocomoco", HOCOMOCO),
                                      ("cisbp", CISBP)])
def test_ppm_directories_write_the_same_csvs(tmp_path, fmt, text):
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "M001.txt").write_text(text)
    (raw / "bad.txt").write_text("nonsense without tables")
    (raw / "sub").mkdir()
    for name, mod in (("jax", jdr), ("port", tdr)):
        mod.preprocess_ppm_directory(str(raw), str(tmp_path / name), fmt)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for f in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
    dat = tmp_path / "matrix.dat"
    dat.write_text(TRANSFAC)
    for name, mod in (("jax", jdr), ("port", tdr)):
        mod.preprocess_transfac_ppms(str(dat), str(tmp_path / f"tf_{name}"))
    for f in os.listdir(tmp_path / "tf_jax"):
        assert (tmp_path / "tf_port" / f).read_text() == \
            (tmp_path / "tf_jax" / f).read_text()


# ---------------------------------------------------------------------------
# dataset_recipes: per-source recipes
# ---------------------------------------------------------------------------

def test_sequence_x_filter():
    for seqs in (["MKV", "ACGU"], ["X" * 10], ["X" * 50, "MKV"], ["M" * 50 + "X" * 10],
                 [], [None, "X" * 30], ["X" * 21, "A" * 21]):
        assert tdr.sequence_x_filter(seqs) == jdr.sequence_x_filter(seqs)


def _scan():
    return pd.DataFrame({
        "label": ["1abc", "2def", "3ghi", "4jkl", "5mno", "6pqr"],
        "date": ["2001-01-01"] * 6,
        "num_heavy": [5000, 50, 5000, 5000, 5000, 5000],
        "coverage": [0.95, 0.95, 0.95, 0.95, 0.5, 0.95],
        "resolution": [2.0, 2.0, 2.0, np.nan, 2.0, 4.0],
        "poly_type": ["['polypeptide(L)', 'polyribonucleotide']",
                      "['polyribonucleotide']", "['polypeptide(L)']",
                      "['polydeoxyribonucleotide']", "['polyribonucleotide']",
                      "['polyribonucleotide']"],
        "poly_sequence": ["['MKV', 'ACGU']", "['ACGU']", "['MKV']", "['ACGT']",
                          "['ACGU']", "['ACGU']"],
        "poly": ["['A','B']"] * 6, "nonpoly": ["[]"] * 6,
    })


def test_rcsb_cif_na_recipe(tmp_path):
    scan = _scan()
    want = _records(jdr.make_rcsb_cif_na_input(scan, "/db/cif"))
    # from the CSV's strings, and from the frame's own values
    scan.to_csv(tmp_path / "scan.csv", index=False)
    for rows in (_rows(tmp_path / "scan.csv"), _records(scan)):
        assert tdr.make_rcsb_cif_na_input(rows, "/db/cif") == want
    assert [r["id"] for r in want] == ["1abc", "4jkl"]
    assert want[0]["structure_path"] == "/db/cif/ab/1abc.cif.gz"


@pytest.mark.parametrize("id_column,path_fn", [
    ("gene_id", None), ("absent", None),
    (None, lambda r: f"/other/{r['dataset_name']}/{r['id']}.pdb")])
def test_distillation_recipe(id_column, path_fn):
    df = pd.DataFrame({"id": ["g1_ACGT", "g2_TTTT", "g3_CCCC", "g4_AAAA"],
                       "gene_id": ["g1", "g2", "g3", "g4"],
                       "i_pae": [3.0, 9.0, 5.0, 6.0], "plddt": [0.9, 0.9, 0.7, 0.85]})
    want = _records(jdr.make_distillation_input(df, "/d", "rf2na_distillation_cis_bp",
                                                id_column, path_fn=path_fn))
    got = tdr.make_distillation_input(_records(df), "/d", "rf2na_distillation_cis_bp",
                                      id_column, path_fn=path_fn)
    assert got == want and [r["id"] for r in got] == ["g1_ACGT", "g4_AAAA"]


def test_build_preprocessing_output(tmp_path):
    pre = tmp_path / "preprocessed"
    for attr in ("lengths", "sequences"):
        (pre / attr).mkdir(parents=True)
    (pre / "bad").mkdir()
    (pre / "bad" / "s2.txt").write_text("parse error")
    (pre / "bad" / "s4.txt").write_text("parse error")
    (pre / "notes.txt").write_text("not a directory")
    for sid in ("s1", "s3"):
        (pre / "lengths" / f"{sid}.npy").write_bytes(b"x")
        (pre / "sequences" / f"{sid}.csv").write_text("chain_type,sequence\n")
    input_csv = tmp_path / "preprocessing_input.csv"
    pd.DataFrame({"id": ["s1", "s2", "s3"], "structure_path": ["/a", "/b", "/c"],
                  "date": ["1970-01-01"] * 3, "dataset_name": ["t"] * 3,
                  "gene_id": ["g1", "g2", "g3"]}).to_csv(input_csv, index=False)
    for key, mapping in (("gene_id", {"g1": [["/p/x.csv"]]}), ("id", {"s3": [["/q.csv"]]}),
                         ("id", None)):
        out = {}
        for name, mod in (("jax", jdr), ("port", tdr)):
            path = tmp_path / f"{name}_{key}.csv"
            df, reasons = mod.build_preprocessing_output(
                str(input_csv), str(pre), str(path), id_to_ppm_paths=mapping,
                key_column=key)
            out[name] = (df, reasons, path.read_text())
        assert out["port"][1] == out["jax"][1] == {"parse error": 2}
        assert out["port"][2] == out["jax"][2]          # the same CSV, byte for byte
        assert out["port"][0] == _records(out["jax"][0])
    with pytest.raises(FileNotFoundError):
        tdr.attach_preprocessed_paths([{"id": "s9"}], str(pre))


# ---------------------------------------------------------------------------
# curation
# ---------------------------------------------------------------------------

CLUSTERS = {"protein_chain_cluster_ids": [["p1"], ["p1"], ["p2"], ["p3"], ["p4", "p1"], []],
            "nucleic_acid_chain_cluster_ids": [["n1"], ["n2"], ["n2"], ["n3"], ["n4"],
                                               ["n5", "n6"]]}


def test_cluster_degrees_and_sampling():
    df = pd.DataFrame(CLUSTERS)
    rows = _records(df)
    for col in CLUSTERS:
        assert tcur.compute_chain_cluster_degrees(rows, col) == \
            jcur.compute_chain_cluster_degrees(df, col)
    assert tcur.compute_sampling_probability(rows) is rows
    assert rows == _records(jcur.compute_sampling_probability(df))
    # row 0: degrees [3 (p1), 1 (n1)] -> mean(1/4, 1/2)
    assert rows[0]["sampling_probability"] == (1 / 4 + 1 / 2) / 2


@pytest.mark.parametrize("seed,max_deg,extra", [(1, None, None), (0, 1, None),
                                                (3, 2, ["n1"])])
def test_train_valid_test_split(tmp_path, seed, max_deg, extra):
    df = pd.DataFrame(CLUSTERS)
    rows = _records(df)
    deg = tcur.compute_chain_cluster_degrees(rows, "nucleic_acid_chain_cluster_ids")
    jdeg = jcur.compute_chain_cluster_degrees(df, "nucleic_acid_chain_cluster_ids")
    kw = dict(valid_fraction=0.2, test_fraction=0.2, max_valid_test_cluster_degree=max_deg,
              extra_test_cluster_ids=extra, seed=seed)
    assert tcur.split_train_valid_test_clusters(deg, 0.2, 0.2, max_deg, extra, seed) == \
        jcur.split_train_valid_test_clusters(jdeg, 0.2, 0.2, max_deg, extra, seed)
    want = jcur.train_valid_test_split(df, jdeg, "nucleic_acid_chain_cluster_ids",
                                       output_directory=str(tmp_path / "jax"), **kw)
    got = tcur.train_valid_test_split(rows, deg, "nucleic_acid_chain_cluster_ids",
                                      output_directory=str(tmp_path / "port"), **kw)
    assert got == _records(want)
    assert "split" not in rows[0]
    for split in ("train", "valid", "test"):
        assert (tmp_path / "port" / f"{split}.csv").read_text() == \
            (tmp_path / "jax" / f"{split}.csv").read_text()
    # rows sharing a cluster (n2: rows 1 and 2) get one assignment
    assert got[1]["split"] == got[2]["split"]


def test_cdhit_parser_and_standardize(tmp_path, monkeypatch):
    clstr = tmp_path / "o.clstr"
    clstr.write_text(">Cluster 0\n0\t10nt, >seqA... *\n1\t10nt, >seqB... at 95%\n"
                     ">Cluster 1\n0\t8nt, >seqC... *\n\n")
    assert tcur.parse_cdhit_clusters(str(clstr)) == \
        jcur.parse_cdhit_clusters(str(clstr)) == {"seqA": 0, "seqB": 0, "seqC": 1}
    for s in ("ACGU", "ACGTN?", "", "uacg"):
        assert tcur.standardize_na_sequence(s) == jcur.standardize_na_sequence(s)
    monkeypatch.setenv("PATH", str(tmp_path))        # no cd-hit
    for mod in (jcur, tcur):
        with pytest.raises(RuntimeError, match="cd-hit-est not found"):
            mod.run_cdhit({"a": "ACGU"}, nucleic=True)


def test_family_label_pipeline(tmp_path, monkeypatch):
    """The InterProScan stage with the scanner stubbed in both packages: the
    same gathered sequences, shard files, combined rows and CSV."""
    seqs1 = tmp_path / "s1.csv"
    seqs1.write_text("chain_type,sequence\npolypeptide(L),MKV\npolyribonucleotide,ACGU\n"
                     "polypeptide(L),\n")
    seqs2 = tmp_path / "s2.csv"
    seqs2.write_text("chain_type,sequence\npolypeptide(L),GGAA\n"
                     "polydeoxyribonucleotide,ACGT\npolypeptide(L),WWW\n")
    pre = tmp_path / "preprocessing_output.csv"
    pre.write_text(f"id,sequences_path\na,{seqs1}\nb,{seqs2}\n")
    for types in (("polypeptide(L)",), tcur.NA_CHAIN_TYPES):
        assert tcur.gather_chain_sequences([str(pre)], types) == \
            jcur.gather_chain_sequences([str(pre)], types)

    def fake_scan(fasta_path, output_path, applications="Pfam"):
        rows, header = [], None
        for line in open(fasta_path):
            if line.startswith(">"):
                header = line[1:].strip()
            elif line.strip():
                for hit in range(2):            # two hits per protein
                    rows.append(f"{header}\tmd5\t{len(line.strip())}\tPfam\t"
                                f"PF{header}{hit}\tdesc\t1\t3\t0.1\tT\td\tIPR\ti\tg\tp")
        with open(output_path, "w") as f:
            f.write("\n".join(rows))

    out = {}
    for name, mod in (("jax", jcur), ("port", tcur)):
        monkeypatch.setattr(mod, "run_interproscan", fake_scan)
        d = tmp_path / name
        out[name] = mod.family_label_pipeline([str(pre)], str(d), num_jobs=2)
    assert sorted(os.listdir(tmp_path / "port" / "fasta_splits")) == \
        sorted(os.listdir(tmp_path / "jax" / "fasta_splits"))
    for f in os.listdir(tmp_path / "jax" / "fasta_splits"):
        assert (tmp_path / "port" / "fasta_splits" / f).read_text() == \
            (tmp_path / "jax" / "fasta_splits" / f).read_text()
    a = _rows(tmp_path / "jax" / "all_protein_family_labels.csv")
    b = _rows(tmp_path / "port" / "all_protein_family_labels.csv")
    assert b == a and len(b) == 6
    assert [r["sequence"] for r in out["port"]] == list(out["jax"]["sequence"])
    assert [r["signature_accession"] for r in out["port"]] == \
        list(out["jax"]["signature_accession"])
    assert "protein_accession" not in out["port"][0]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tcur.combine_family_labels(str(empty), str(tmp_path / "port" /
                                                      "all_protein_sequences.fa")) == []


def test_scan_structure_database(tmp_path):
    """The database scan of PDB and mmCIF files: the same rows as the JAX
    scan's frame (a file that fails to parse is skipped by both), and the
    CLI's CSV."""
    from na_mpnn_tpu.data.cif import PDBParser as JaxPDBParser
    from na_mpnn_tpu_torch.data.cif import PDBParser

    pdb = str(tmp_path / "1abc.pdb")
    write_synthetic_pdb(pdb, (("A", "protein", 12), ("B", "dna", 6), ("C", "rna", 5)))
    cif = str(tmp_path / "2def.cif")
    write_synthetic_cif(pdb, cif)
    files = [pdb, str(tmp_path / "3bad.pdb")]                # absent: skipped
    want = _records(jcur.scan_structure_database(files, parser=JaxPDBParser()))
    got = tcur.scan_structure_database(files, parser=PDBParser())
    assert got == want and len(got) == 1 and got[0]["num_heavy"] > 0
    # the synthetic mmCIF has no entity tables for CIFParser: both skip it
    files = [cif, str(tmp_path / "3bad.cif")]
    assert tcur.scan_structure_database(files) == \
        _records(jcur.scan_structure_database(files)) == []
    tcur.main([str(tmp_path / "*.cif"), str(tmp_path / "scan.csv")])
    jcur.main([str(tmp_path / "*.cif"), str(tmp_path / "jscan.csv")])
    assert (tmp_path / "scan.csv").read_text() == (tmp_path / "jscan.csv").read_text()
