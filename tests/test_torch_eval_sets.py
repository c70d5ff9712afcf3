"""The port's split readers and writers (``data/splits.py``), evaluation-set
preparation (``eval/prepare_sets.py``) and visualisation helpers
(``eval/visualize.py``) against the JAX package's. The port works on lists
of row dicts; the JAX functions get a ``pandas.DataFrame`` built from the
same rows. The two must keep the same ids in the same order and write the
same JSON, CSV and PDB files. Mirrors ``tests/test_prepare_sets.py`` and the
split and visualisation cases of ``tests/test_utils_misc.py``, on synthetic
structures."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import csv
import json
import os

import numpy as np
import pandas as pd
import pytest

from na_mpnn_tpu import constants as jconstants
from na_mpnn_tpu.data import splits as jsplits
from na_mpnn_tpu.eval import prepare_sets as jprep
from na_mpnn_tpu.eval import visualize as jvis

from chip_smoke import write_synthetic_pdb
from na_mpnn_tpu_torch.data import splits as tsplits
from na_mpnn_tpu_torch.eval import prepare_sets as tprep
from na_mpnn_tpu_torch.eval import visualize as tvis


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture()
def mini(tmp_path):
    """Five entries as CSV rows: an RNA monomer, a protein-DNA complex, one
    outside the split clusters, one too long, and a TRANSFAC distillation
    entry."""
    side = tmp_path / "side"
    os.makedirs(side)
    rna_pdb, cplx_pdb = str(tmp_path / "r1.pdb"), str(tmp_path / "c1.pdb")
    write_synthetic_pdb(rna_pdb, (("A", "rna", 24),), seed=1)
    write_synthetic_pdb(cplx_pdb, (("A", "protein", 30), ("B", "dna", 9),
                                   ("C", "dna", 9)), seed=2)
    write_synthetic_pdb(str(tmp_path / "t1.pdb"), (("A", "protein", 20),
                                                   ("B", "dna", 8)), seed=3)

    def lengths_npy(name, L):
        p = str(side / f"{name}_lengths.npy")
        np.save(p, {"1": (L, 0, 0, L)}, allow_pickle=True)
        return p

    def sequences_csv(name, chain_types):
        p = str(side / f"{name}_seqs.csv")
        with open(p, "w") as f:
            f.write("chain_type,sequence\n" + "".join(f"{t},AAAAA\n" for t in chain_types))
        return p

    def row(sid, path, dataset, na, prot, na_t, prot_t, L, chains, ppm):
        return {"id": sid, "structure_path": path, "dataset_name": dataset,
                "nucleic_acid_chain_cluster_ids": na,
                "protein_chain_cluster_ids": prot,
                "nucleic_acid_chain_cluster_ids_chain_types": na_t,
                "protein_chain_cluster_ids_chain_types": prot_t,
                "asmb_lengths_path": lengths_npy(sid, L),
                "sequences_path": sequences_csv(sid, chains), "ppm_paths": ppm}

    rows = [
        row("r1", rna_pdb, "rcsb_cif_na", "['na1']", "[]", "['polyribonucleotide']",
            "[]", 24, ["polyribonucleotide"], "[]"),
        row("c1", cplx_pdb, "rcsb_cif_na", "['na2']", "['p1']",
            "['polydeoxyribonucleotide']", "['polypeptide(L)']", 48,
            ["polypeptide(L)", "polydeoxyribonucleotide", "polydeoxyribonucleotide"],
            "[['/x/jaspar/MA0001.1.txt', '/x/H11MO/T1.txt']]"),
        row("leak", rna_pdb, "rcsb_cif_na", "['na1', 'OTHER']", "[]",
            "['polyribonucleotide']", "[]", 24, ["polyribonucleotide"], "[]"),
        row("long", rna_pdb, "rf2na_distillation_cis_bp", "['na3']", "['p2']",
            "['polydeoxyribonucleotide']", "['polypeptide(L)']", 5000,
            ["polypeptide(L)", "polydeoxyribonucleotide"], "[['/x/cisbp/M001.txt']]"),
        row("tf", cplx_pdb.replace("c1", "t1"), "rf2na_distillation_transfac", "['na2']", "['p1']",
            "['polydeoxyribonucleotide']", "['polypeptide(L)']", 48,
            ["polypeptide(L)", "polydeoxyribonucleotide"], "[['/x/tf/V1.txt']]"),
    ]
    csv_path = str(tmp_path / "ds.csv")
    pd.DataFrame(rows).to_csv(csv_path, index=False)
    clusters = tmp_path / "clusters.txt"
    clusters.write_text("na1\nna2\nna3\np1\np2\n")
    return tmp_path, _read_csv(csv_path), pd.read_csv(csv_path), csv_path, str(clusters)


def _ids(x):
    return list(x["id"]) if isinstance(x, pd.DataFrame) else [r["id"] for r in x]


def test_subset_helpers(mini):
    _, rows, df, _, _ = mini
    cases = [
        ("get_exclusive_cluster_subset", ("nucleic_acid_chain_cluster_ids",
                                          {"na1", "na2", "na3"})),
        ("get_exclusive_cluster_subset", ("protein_chain_cluster_ids", {"p1"})),
        ("get_length_subset", (1000, 20)), ("get_length_subset", (30, 20)),
        ("get_rna_monomer_subset", ()), ("get_ppm_subset", ()),
        ("get_entries_in_same_clusters_as_specified_entries",
         (["r1"], "nucleic_acid_chain_cluster_ids")),
        ("get_entries_in_same_clusters_as_specified_entries",
         (["r1", "leak"], "nucleic_acid_chain_cluster_ids")),
    ]
    for fn, args in cases:
        want, got = getattr(jprep, fn)(df, *args), getattr(tprep, fn)(rows, *args)
        assert _ids(got) == _ids(want), fn
    assert _ids(tprep.get_rna_monomer_subset(rows)) == ["r1", "leak"]
    for fn in ("get_polymer_type_statistics", "get_ppm_statistics"):
        assert getattr(tprep, fn)(rows) == getattr(jprep, fn)(df)
    for mod, frame in ((jprep, df), (tprep, rows)):
        with pytest.raises(KeyError):
            mod.get_entries_in_same_clusters_as_specified_entries(
                frame, ["absent"], "nucleic_acid_chain_cluster_ids")


def test_rna_solo_paths(tmp_path):
    rfam, bgsu = tmp_path / "rfam", tmp_path / "bgsu"
    for d, fam in [(rfam, "rfam"), (bgsu, "bgsu")]:
        os.makedirs(d / "x")
        for pdb_id in ("4oqu", "1vc5"):
            (d / "x" / f"{pdb_id}_1_{fam}.pdb").write_text("END\n")
    (rfam / "x" / "PDB_00001abc_2.pdb").write_text("END\n")
    got = tprep.load_rna_solo_paths(str(rfam), str(bgsu))
    assert got == jprep.load_rna_solo_paths(str(rfam), str(bgsu))
    assert "bgsu" in os.path.basename(got["1vc5"][0]) and "1abc" in got
    (tmp_path / "ids.txt").write_text("a\n\nb \n")
    assert tprep.read_cluster_ids_text_file(str(tmp_path / "ids.txt")) == \
        jprep.read_cluster_ids_text_file(str(tmp_path / "ids.txt")) == {"a", "b"}


def _same_pdb_files(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir))
    for n in names:
        assert open(os.path.join(a_dir, n)).read() == \
            open(os.path.join(b_dir, n)).read(), n
    return names


def test_convert_structures(mini):
    tmp, rows, df, _, _ = mini
    want = jprep.convert_structures(df.iloc[:2], str(tmp / "jax"))
    got = tprep.convert_structures(rows[:2], str(tmp / "port"))
    assert _same_pdb_files(tmp / "jax", tmp / "port") == ["c1.pdb", "r1.pdb"]
    assert _ids(got) == _ids(want) == ["r1", "c1"]
    for r, (_, w) in zip(got, want.iterrows()):
        assert r["original_structure_path"] == w["original_structure_path"]
        assert r["copied_structure_path"] == w["copied_structure_path"]
        assert os.path.basename(r["structure_path"]) == \
            os.path.basename(w["structure_path"])
    assert "structure_path" in rows[0] and rows[0]["structure_path"].endswith("r1.pdb")
    solo = {"r1": [rows[0]["structure_path"]]}
    want = jprep.convert_structures(df, str(tmp / "jax_s"), True, solo)
    got = tprep.convert_structures(rows, str(tmp / "port_s"), True, solo)
    assert _ids(got) == _ids(want) == ["r1"]
    _same_pdb_files(tmp / "jax_s", tmp / "port_s")


@pytest.mark.parametrize("subset", ["full", "rna_monomer", "pseudoknot", "specificity"])
def test_prepare_sets(mini, subset):
    tmp, _, _, csv_path, clusters = mini
    out = {}
    for name, mod in (("jax", jprep), ("port", tprep)):
        pdbs, out_csv = str(tmp / name / "pdbs"), str(tmp / name / "set.csv")
        os.makedirs(tmp / name)
        if subset == "specificity":
            res = mod.prepare_specificity_set(csv_path, clusters, pdbs, out_csv)
        else:
            res = mod.prepare_design_set(csv_path, clusters, pdbs, out_csv,
                                         subset=subset, pseudoknot_ids=("r1", "c1"))
        out[name] = (res, _read_csv(out_csv))
    assert _ids(out["port"][0]) == _ids(out["jax"][0])
    a, b = out["jax"][1], out["port"][1]
    assert [list(r) for r in a] == [list(r) for r in b]
    for ra, rb in zip(a, b):
        for k in ra:
            if k != "structure_path":
                assert ra[k] == rb[k], k
        assert os.path.basename(ra["structure_path"]) == \
            os.path.basename(rb["structure_path"])
    if os.path.isdir(tmp / "jax" / "pdbs"):
        _same_pdb_files(tmp / "jax" / "pdbs", tmp / "port" / "pdbs")
    want = {"full": ["r1", "c1", "tf"], "rna_monomer": ["r1"],
            "pseudoknot": ["r1", "c1", "tf"], "specificity": ["c1", "tf"]}[subset]
    assert _ids(out["port"][0]) == want


def test_split_readers_and_writers(mini):
    tmp, rows, df, _, _ = mini
    for name, mod, frame in (("jax", jsplits, df), ("port", tsplits, rows)):
        mod.write_design_split(str(tmp / f"{name}_design.json"), frame)
        sub = frame[frame["id"].isin(["c1", "long", "tf"])] \
            if name == "jax" else [r for r in frame if r["id"] in ("c1", "long", "tf")]
        mod.write_specificity_split(str(tmp / f"{name}_spec.json"), sub)
    for kind in ("design", "spec"):
        assert open(tmp / f"jax_{kind}.json").read() == \
            open(tmp / f"port_{kind}.json").read()
    assert tsplits.load_design_split(str(tmp / "port_design.json")) == \
        jsplits.load_design_split(str(tmp / "port_design.json")) == \
        ["r1", "c1", "leak", "long", "tf"]
    assert tsplits.load_specificity_split(str(tmp / "port_spec.json")) == \
        jsplits.load_specificity_split(str(tmp / "port_spec.json"))
    raw = json.load(open(tmp / "port_spec.json"))
    assert raw[0][1][0] == [["JASPAR", "MA0001.1"], ["HOCOMOCO", "T1"]]
    assert raw[1][1][0][0] == ["CIS-BP", "M001"] and len(raw) == 2

    assert _ids(tsplits.subset_df_to_remove_transfac(rows)) == \
        _ids(jsplits.subset_df_to_remove_transfac(df))
    outputs = [{"structure_path": rows[1]["structure_path"]}]
    assert _ids(tsplits.subset_evaluation_set_to_outputs(rows, outputs)) == \
        _ids(jsplits.subset_evaluation_set_to_outputs(df, pd.DataFrame(outputs))) == ["c1"]
    split_ids = ["R1", "zzz"]
    assert _ids(tsplits.filter_dataframe_by_split(rows, split_ids)) == \
        _ids(jsplits.filter_dataframe_by_split(df, split_ids)) == ["r1", "leak", "long"]
    for path, ds in (("/a/jaspar/x.txt", "rcsb_cif_na"), ("/a/H11MO/y.txt", "rcsb_cif_na"),
                     ("/a/z.txt", "rf2na_distillation_cis_bp"), ("/a/x.txt", "rcsb_cif_na"),
                     ("/a/x.txt", "rf2na_distillation_transfac")):
        try:
            want = jsplits.ppm_source_from_path(path, ds)
        except ValueError:
            with pytest.raises(ValueError):
                tsplits.ppm_source_from_path(path, ds)
        else:
            assert tsplits.ppm_source_from_path(path, ds) == want
    copied = {n: m.copy_distillation_structures(f, str(tmp / f"distill_{n}"))
              for n, m, f in (("jax", jsplits, df), ("port", tsplits, rows))}
    assert [os.path.basename(p) for p in copied["port"]] == \
        [os.path.basename(p) for p in copied["jax"]] == ["r1.pdb"]
    assert tsplits.available_reference_splits(str(tmp)) == \
        jsplits.available_reference_splits(str(tmp))
    assert tsplits.available_reference_splits(str(tmp / "absent")) == {}


# ---------------------------------------------------------------------------
# eval/visualize.py (pandas and matplotlib inside its functions)
# ---------------------------------------------------------------------------

def _training_log(tmp_path):
    lines = ["Epoch\tTrain\tValidation"]
    for e in range(6):
        parts = [f"epoch: {e + 1}, step: {10 * (e + 1)}, train_time: 1.0, valid_time: 0.5"]
        for split in ("train", "valid"):
            parts.append(f"{split}_loss: {3.0 - 0.1 * e:.3f}")
            parts.append(f"{split}_accuracy: {0.1 + 0.01 * e:.3f}")
            for p in ("protein", "dna", "rna"):
                parts.append(f"{split}_{p}_accuracy: {0.1 + 0.02 * e:.3f}")
                parts.append(f"{split}_{p}_loss: {3.0 - 0.2 * e:.3f}")
        lines.append(", ".join(parts))
    log = tmp_path / "log.txt"
    log.write_text("\n".join(lines) + "\n")
    return str(log)


def test_training_log_and_plots(tmp_path):
    log = _training_log(tmp_path)
    pd.testing.assert_frame_equal(tvis.parse_training_log(log),
                                  jvis.parse_training_log(log))
    np.testing.assert_array_equal(tvis.running_mean([1, 2, 3, 4, 9], 2),
                                  jvis.running_mean([1, 2, 3, 4, 9], 2))
    fig = tvis.plot_per_polymer_training_curves(log, smooth=2,
                                                out_path=str(tmp_path / "p.png"))
    assert [len(ax.get_lines()) for ax in fig.axes] == [6, 6]
    tvis.plot_training_metrics(log, out_path=str(tmp_path / "c.png"))
    ppm = np.random.RandomState(0).dirichlet(np.ones(4), size=10)
    tvis.sequence_logo(ppm, out_path=str(tmp_path / "l.png"))
    for f in ("p.png", "c.png", "l.png"):
        assert os.path.getsize(tmp_path / f) > 0


def test_seq_logo_inputs_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    L, nl = 8, jconstants.NUM_LETTERS
    t2i = jconstants.restype_to_int_table(True)
    dna_cols = [t2i[r] for r in ("DA", "DC", "DG", "DT")]
    aligned = np.zeros((L, nl))
    aligned[:, dna_cols] = rng.dirichlet(np.ones(4), L)
    pred = np.zeros((L, nl))
    pred[:, dna_cols] = rng.dirichlet(np.ones(4), L)
    subject = {"predicted_ppm_na_mpnn_format": pred.tolist(),
               "true_sequence_na_mpnn_format": (t2i["DA"] + rng.randint(0, 4, L)).tolist(),
               "mask": [1] * L, "dna_mask": [1] * L,
               "chain_labels": [0] * (L // 2) + [1] * (L - L // 2)}
    json.dump(subject, open(tmp_path / "subject.json", "w"))
    json.dump({"aligned_ppm": aligned.tolist(), "ppm_mask": [1] * L,
               "subject_path": str(tmp_path / "subject.json")},
              open(tmp_path / "score.json", "w"))
    for n in (1, 2):
        a = jvis.load_predicted_ppm_and_true_sequence(str(tmp_path / "score.json"), n)
        b = tvis.load_predicted_ppm_and_true_sequence(str(tmp_path / "score.json"), n)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    fig = tvis.plot_seq_logo_comparison(str(tmp_path / "score.json"), 2,
                                        out_path=str(tmp_path / "cmp.png"))
    assert len(fig.axes) == 2 and os.path.exists(tmp_path / "cmp.png")


def test_result_tables_match_jax(tmp_path):
    for i, rec in enumerate([0.5, 0.7, 0.9]):
        json.dump({"name": f"d{i}", "group": "ab"[i % 2], "sequence_recovery": rec,
                   "eternafold_f1_score_pairs": 1.0 - rec, "list": [1]},
                  open(tmp_path / f"score_{i}.json", "w"))
    (tmp_path / "score_9.json").write_text("{broken")
    pattern = str(tmp_path / "score_*.json")
    pd.testing.assert_frame_equal(tvis.aggregate_result_jsons(pattern),
                                  jvis.aggregate_result_jsons(pattern))
    for group in (None, "group"):
        for x, y in zip(tvis.summarize_scores(pattern, group),
                        jvis.summarize_scores(pattern, group)):
            pd.testing.assert_frame_equal(x, y)

    scan = tmp_path / "scan.csv"
    pd.DataFrame({"label": ["a", "b", "c"],
                  "poly_type": ["['polypeptide(L)', 'polyribonucleotide']",
                                "['polydeoxyribonucleotide']", "[]"],
                  "method": ["X-RAY_DIFFRACTION", "ELECTRON_MICROSCOPY", "X-RAY_DIFFRACTION"],
                  "resolution": [2.0, 3.4, np.nan], "coverage": [0.9, 0.8, 1.0],
                  "num_heavy": [1000, 2000, 10]}).to_csv(scan, index=False)
    got = tvis.dataset_statistics(str(scan), str(tmp_path / "stats.png"))
    assert got == jvis.dataset_statistics(str(scan))
    assert got["median_resolution"] == 2.7 and os.path.exists(tmp_path / "stats.png")

    ok = tmp_path / "openknot.csv"
    pd.DataFrame({"method": ["WT", "MPNN-fixbb", "MPNN-fixbb", "gRNAde"],
                  "round": [1, 1, 1, 2],
                  "target_openknot_score": [40.0, 80.0, 90.0, 60.0],
                  "sequence": ["GGAACCUU"] * 4, "sub_start": [2, 2, 3, 1],
                  "sub_end": [5, 5, 6, 8], "reactivity_0001": [0.1] * 4,
                  "reactivity_0002": [0.2] * 4, "reactivity_0003": [0.3] * 4,
                  "reactivity_error_0001": [9.0] * 4}).to_csv(ok, index=False)
    a, b = jvis.load_experimental_results(str(ok)), tvis.load_experimental_results(str(ok))
    assert list(a["design_seq"]) == list(b["design_seq"])
    for x, y in zip(a["reactivity_vec"], b["reactivity_vec"]):
        np.testing.assert_array_equal(x, y)
    pd.testing.assert_frame_equal(
        tvis.experimental_results_summary(str(ok), methods=["WT", "MPNN-fixbb"],
                                          rounds=[1], out_path=str(tmp_path / "box.png")),
        jvis.experimental_results_summary(str(ok), methods=["WT", "MPNN-fixbb"],
                                          rounds=[1]))
    assert os.path.exists(tmp_path / "box.png")
