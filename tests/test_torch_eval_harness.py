"""The port's evaluation entry points (``eval/harness.py``, ``cli/sweep.py``)
on the CPU against the JAX package's, at the full width of the released
model (H=128, K=32, 3+3 layers) with random weights that the JAX package
writes as ``.npz``:

* the monomer-RNA protocol (design -> DSSR reference -> EternaFold /
  RibonanzaNet / AF3 processing -> score) with the external stages stubbed
  in both packages: the same files, and equal JSONs downstream of the
  design;
* ``predict_nucleic_acid_ppm`` on a protein-DNA complex (the same subject
  keys, shapes and deterministic fields), then ``score_specificity_prediction``
  of the port's subject JSON by both packages against one PPM CSV: equal
  keys, numbers within 1e-12;
* ``run_sweep`` in score and design mode over two checkpoints: the same
  table keys, counts and work-directory files, finite values;
* a checkpoint's ``.pt`` export and its ``.npz`` give bitwise the same sweep
  table in the port (same seed);
* the flags the harness passes to ``cli/run.py`` exist in the port's parser
  with the JAX parser's meaning.

The two packages sample with different generators, so sampled sequences
are compared by shape and layout only; JSON paths are compared with each
package's output root replaced."""
import json
import os

import numpy as np
import pytest

import jax

from na_mpnn_tpu.cli import run as jrun
from na_mpnn_tpu.cli import sweep as jsweep
from na_mpnn_tpu.eval import external as jext
from na_mpnn_tpu.eval import harness as jharness
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.train.checkpoint import save_checkpoint_npz

from chip_smoke import write_synthetic_pdb
from na_mpnn_tpu_torch.cli import run as trun
from na_mpnn_tpu_torch.cli import sweep as tsweep
from na_mpnn_tpu_torch.eval import external as text
from na_mpnn_tpu_torch.eval import harness as tharness
from na_mpnn_tpu_torch.models import ModelConfig
from na_mpnn_tpu_torch.params import load_params_any, save_torch_checkpoint

PACKAGES = {"jax": (jharness, jsweep, jext), "port": (tharness, tsweep, text)}
CPU = {"jax": {}, "port": {"device": "cpu"}}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two full-width checkpoints written by the JAX package, a protein-DNA
    complex, an RNA monomer and the CSV of the complex."""
    d = tmp_path_factory.mktemp("eval")
    ckpts = d / "ckpts"
    ckpts.mkdir()
    for step, seed in ((1000, 1), (2000, 2)):
        save_checkpoint_npz(str(ckpts / f"s_{step}.npz"),
                            jax_init(jax.random.PRNGKey(seed), JaxConfig()),
                            meta={"step": step})
    cplx = str(d / "cplx.pdb")
    write_synthetic_pdb(cplx, (("A", "protein", 30), ("B", "dna", 10),
                               ("C", "dna", 10)), seed=11)
    rna = str(d / "rna1.pdb")
    write_synthetic_pdb(rna, (("A", "rna", 14),), seed=12)
    csv_path = str(d / "structures.csv")
    with open(csv_path, "w") as f:
        f.write(f"structure_path,ppm_paths\n{cplx},\"[['{d}/ppm.csv']]\"\n")
    rng = np.random.RandomState(0)
    ppm = rng.dirichlet(np.ones(4) * 0.5, size=6)
    with open(d / "ppm.csv", "w") as f:
        f.write("A,C,G,T\n" + "".join(",".join(repr(float(v)) for v in r) + "\n"
                                      for r in ppm))
    return d, ckpts, cplx, rna, csv_path


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def _normalised(obj, roots):
    """A JSON value with each output root replaced by ``<out>``."""
    if isinstance(obj, dict):
        return {k: _normalised(v, roots) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_normalised(v, roots) for v in obj]
    if isinstance(obj, str):
        for r in roots:
            obj = obj.replace(r, "<out>")
    return obj


def _close(a, b, atol, where=""):
    """Equal structure and strings; numbers within ``atol`` (NaN = NaN)."""
    if isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _close(a[k], b[k], atol, f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, atol, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            assert a is b, where
        elif np.isnan(a):
            assert np.isnan(b), where
        else:
            assert abs(a - b) <= atol, (where, a, b)
    else:
        assert a == b, (where, a, b)


# ---------------------------------------------------------------------------
# The monomer-RNA protocol, external stages stubbed
# ---------------------------------------------------------------------------

REF_SS = "(((((....)))))"
REF_SEQ = "GGGGGAAAACCCCC"


def _stub_externals(monkeypatch, ext, rna):
    monkeypatch.setattr(ext, "run_dssr", lambda p: {
        "sequence": REF_SEQ, "secondary_structure": REF_SS})
    monkeypatch.setattr(ext, "run_eternafold", lambda s: {
        "predicted_secondary_structure": REF_SS})
    monkeypatch.setattr(ext, "run_ribonanza_net_secondary_structure", lambda s: {
        "predicted_secondary_structures": [REF_SS, "(((......)))..", REF_SS]})
    monkeypatch.setattr(ext, "run_ribonanza_net_reactivity_profile", lambda s: {
        "predicted_2A3_reactivity_profiles": [
            [0.9 if c == "." else 0.1 for c in REF_SS], [0.4] * len(REF_SS)],
        "predicted_DMS_reactivity_profiles": [[0.1] * len(REF_SS)]})

    def fake_af3(name, sequence, output_directory, af3_cmd=None):
        path = os.path.join(output_directory, f"{name}_af3.pdb")
        write_synthetic_pdb(path, (("A", "rna", len(sequence)),), seed=13)
        return {"predicted_structure_path": path, "ptm": 0.9, "pae": 3.0,
                "plddt": 85.0}

    monkeypatch.setattr(ext, "run_alphafold3", fake_af3)


def test_monomer_rna_protocol_matches_jax(inputs, tmp_path, monkeypatch):
    d, ckpts, _, rna, _ = inputs
    ckpt = str(ckpts / "s_1000.npz")
    designs = {}
    for name, (harness, _, ext) in PACKAGES.items():
        _stub_externals(monkeypatch, ext, rna)
        out = tmp_path / name
        designs[name] = harness.design_nucleic_acid_sequence(
            rna, str(out / "designs"), 2, 0.1, na_mpnn_model_path=ckpt, seed=3,
            **CPU[name])
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")
    assert len(designs["port"]) == 2
    for a, b in zip(designs["jax"], designs["port"]):
        assert list(a) == list(b)
        for k in ("input_structure_name", "design_id", "name", "design_method",
                  "model_weights_path", "original_input_structure_path"):
            assert a[k] == b[k], k
        assert _normalised(a["input_structure_path"], roots) == \
            _normalised(b["input_structure_path"], roots)
        assert len(a["design_sequence"]) == len(b["design_sequence"]) == 14

    # the port's first design, as an RNA sequence, through both pipelines
    design = dict(designs["port"][0], design_sequence="GGGGGAAAACCCCA")
    design_path = str(tmp_path / "design.json")
    json.dump(design, open(design_path, "w"))
    scored = {}
    for name, (harness, _, ext) in PACKAGES.items():
        _stub_externals(monkeypatch, ext, rna)
        out = tmp_path / name
        ref_json = harness.process_reference_monomer_rna(rna, str(out / "refs"))
        subj_json = harness.process_design_monomer_rna(design_path,
                                                       str(out / "processed"))
        score_json = harness.score_design_monomer_rna(ref_json, subj_json,
                                                      str(out / "scores"))
        scored[name] = [json.load(open(p)) for p in (ref_json, subj_json, score_json)]
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")
    for a, b in zip(scored["jax"], scored["port"]):
        assert _normalised(a, roots) == _normalised(b, roots)
    score = scored["port"][2]
    assert score["sequence_recovery"] == 13 / 14
    assert score["eternafold_f1_score_pairs"] == 1.0
    assert score["alphafold3_ptm"] == 0.9


def test_monomer_rna_score_trims_shorter_subject(inputs, tmp_path, monkeypatch):
    """A subject 4 residues shorter: both find the same best window."""
    _, _, _, rna, _ = inputs
    sub_pdb = str(tmp_path / "sub.pdb")
    write_synthetic_pdb(sub_pdb, (("A", "rna", 10),), seed=14)
    subj = {"name": "rna1_0", "sequence": REF_SEQ[2:12],
            "eternafold": {"predicted_secondary_structure": "..((..))..",},
            "alphafold3": {"predicted_structure_path": sub_pdb}}
    subj_path = str(tmp_path / "rna1_0.json")
    json.dump(subj, open(subj_path, "w"))
    scores = {}
    for name, (harness, _, ext) in PACKAGES.items():
        _stub_externals(monkeypatch, ext, rna)
        ref_json = harness.process_reference_monomer_rna(rna, str(tmp_path / name / "r"))
        scores[name] = json.load(open(harness.score_design_monomer_rna(
            ref_json, subj_path, str(tmp_path / name / "s"))))
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    assert _normalised(scores["jax"], roots) == _normalised(scores["port"], roots)
    assert scores["port"]["best_end_idx"] - scores["port"]["best_start_idx"] == 10


# ---------------------------------------------------------------------------
# Specificity: predict, then score the port's subject with both packages
# ---------------------------------------------------------------------------

DETERMINISTIC = ("name", "original_input_structure_path", "true_sequence_na_mpnn_format",
                 "chain_labels", "mask", "protein_mask", "dna_mask", "rna_mask",
                 "prediction_method", "model_weights_path")


def test_specificity_pipeline_matches_jax(inputs, tmp_path):
    d, ckpts, cplx, _, _ = inputs
    ckpt = str(ckpts / "s_2000.npz")
    subjects = {}
    for name, (harness, _, _) in PACKAGES.items():
        path = harness.predict_nucleic_acid_ppm(
            cplx, str(tmp_path / name / "spec"), 4, 0.6, na_mpnn_model_path=ckpt,
            seed=3, **CPU[name])
        subjects[name] = (path, json.load(open(path)))
    a, b = subjects["jax"][1], subjects["port"][1]
    assert list(a) == list(b)
    for k in DETERMINISTIC:
        assert a[k] == b[k], k
    for k in ("predicted_ppm_na_mpnn_format", "human_readable_ppm"):
        assert np.shape(a[k]) == np.shape(b[k]), k
    assert np.shape(b["predicted_ppm_na_mpnn_format"]) == (50, 33)
    assert np.shape(b["human_readable_ppm"]) == (20, 4)
    assert np.isfinite(b["predicted_ppm_na_mpnn_format"]).all()
    na = np.asarray(b["dna_mask"], bool)         # the designed (NA) rows
    np.testing.assert_allclose(
        np.sum(b["predicted_ppm_na_mpnn_format"], -1)[na], 1.0, atol=1e-5)
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")

    ppm_str = f"[['{d}/ppm.csv']]"
    results = {}
    for name, (harness, _, _) in PACKAGES.items():
        out = harness.score_specificity_prediction(
            ppm_str, subjects["port"][0], str(tmp_path / name / "scores"))
        results[name] = json.load(open(out))
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    _close(_normalised(results["jax"], roots), _normalised(results["port"], roots),
           1e-12)
    assert np.isfinite(results["port"]["pearson_dna"])
    assert results["port"]["aligned_dna_length"] >= 5

    # the dispatcher CLI scores the same file to the same JSON
    tharness.main(["--function_name", "score_specificity_prediction",
                   "--reference_ppms_list_str", ppm_str,
                   "--subject_path", subjects["port"][0],
                   "--overall_output_directory", str(tmp_path / "cli")])
    again = json.load(open(tmp_path / "cli" / "cplx" / "cplx.json"))
    assert again == json.load(open(tmp_path / "port" / "scores" / "cplx" / "cplx.json"))


# ---------------------------------------------------------------------------
# The checkpoint sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["score", "design"])
def test_sweep_matches_jax(inputs, tmp_path, mode):
    d, ckpts, _, _, csv_path = inputs
    tables = {}
    for name, (_, sweep, _) in PACKAGES.items():
        tables[name] = sweep.run_sweep(
            str(ckpts), csv_path, mode, num_samples=2, seed=5,
            out=str(tmp_path / name / "sweep.json"),
            workdir=str(tmp_path / name / "work"), **CPU[name])
    a, b = tables["jax"], tables["port"]
    assert list(a) == list(b)
    assert [e["checkpoint"] for e in a["table"]] == \
        [e["checkpoint"] for e in b["table"]] == tsweep.list_checkpoints(str(ckpts))
    for ea, eb in zip(a["table"], b["table"]):
        assert list(ea) == list(eb)
        assert ea["metric"] == eb["metric"]
        count = "n_orders" if mode == "score" else "n_designs"
        assert ea[count] == eb[count] == 2
        assert np.isfinite(eb["value"])
        if mode == "score":
            assert np.isfinite(eb["mean_loss"])
    assert b["best_checkpoint"] in b["table"]
    assert a["temperature"] == b["temperature"]
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")
    assert list(json.load(open(tmp_path / "port" / "sweep.json"))) == list(b)


@pytest.mark.parametrize("mode", ["score", "design"])
def test_pt_export_sweeps_as_its_npz(inputs, tmp_path, mode):
    """The port's ``.pt`` export of a checkpoint and the ``.npz`` it came from
    give bitwise the same sweep row (same seed, CPU); the CLI's
    ``--checkpoint_dir`` finds both."""
    _, ckpts, _, _, csv_path = inputs
    cdir = tmp_path / "ckpts"
    cdir.mkdir()
    npz = ckpts / "s_1000.npz"
    (cdir / "s_1000.npz").write_bytes(npz.read_bytes())
    params, _ = load_params_any(str(npz), ModelConfig(), device="cpu")
    save_torch_checkpoint(str(cdir / "s_2000.pt"), params, ModelConfig(),
                          meta={"step": 1000})
    out = tmp_path / "sweep.json"
    tsweep.main(["--checkpoint_dir", str(cdir), "--structures_csv", csv_path,
                 "--mode", mode, "--num_samples", "3", "--seed", "9",
                 "--out", str(out), "--workdir", str(tmp_path / "work"),
                 "--device", "cpu"])
    rows = json.load(open(out))["table"]
    assert [os.path.basename(r.pop("checkpoint")) for r in rows] == \
        ["s_1000.npz", "s_2000.pt"]
    assert rows[0] == rows[1] and np.isfinite(rows[0]["value"])


def test_orbax_checkpoints_are_listed_and_refused(inputs, tmp_path):
    _, _, _, _, csv_path = inputs
    for name in ["s_3000.npz", "s_200.npz", "s_19137.pt", "last.npz", "s_bad.npz"]:
        (tmp_path / name).write_bytes(b"x")
    (tmp_path / "s_500.orbax").mkdir()
    got = [os.path.basename(p) for p in tsweep.list_checkpoints(str(tmp_path))]
    assert got == [os.path.basename(p) for p in jsweep.list_checkpoints(str(tmp_path))]
    assert got == ["s_200.npz", "s_500.orbax", "s_3000.npz", "s_19137.pt"]
    with pytest.raises(NotImplementedError, match="orbax"):
        tsweep.run_sweep(str(tmp_path), csv_path, "score", device="cpu",
                         checkpoints=[str(tmp_path / "s_500.orbax")],
                         workdir=str(tmp_path / "work"))


def test_structure_rows_shard_and_split(tmp_path):
    """``_structure_rows``: the split filter and the modulo / remainder shard
    by row index, as the JAX sweep's DataFrame rows."""
    paths = [f"/x/{i}abc.pdb" for i in range(7)] + ["/x/pdb9zzz.cif.gz"]
    csv_path = tmp_path / "s.csv"
    csv_path.write_text("structure_path,other\n" + "".join(
        f"{p},{i}\n" for i, p in enumerate(paths)))
    split = tmp_path / "split.json"
    json.dump(["1ABC", "3abc", "4abc", "6abc", "9zzz"], open(split, "w"))
    for sp in (None, str(split)):
        for modulo, rem in ((1, 0), (2, 1), (3, 0), (3, 2)):
            want = jsweep._structure_rows(str(csv_path), sp, modulo, rem)
            got = tsweep._structure_rows(str(csv_path), sp, modulo, rem)
            assert [r["structure_path"] for r in got] == list(want["structure_path"])
            assert [r["other"] for r in got] == [str(v) for v in want["other"]]
    with pytest.raises(ValueError):
        tsweep._structure_rows(str(csv_path), str(tmp_path / "x.txt"), 1, 0)


# ---------------------------------------------------------------------------
# The flags the harness passes to cli/run.py
# ---------------------------------------------------------------------------

HARNESS_FLAGS = {
    "run_na_mpnn_sequence": [
        "--mode", "--checkpoint_na_mpnn", "--pdb_path", "--out_folder",
        "--batch_size", "--number_of_batches", "--temperature", "--omit_AA",
        "--design_na_only", "--load_residues_with_missing_atoms", "--output_pdbs",
        "--seed", "--pad_to_bucket"],
    "run_na_mpnn_specificity": [
        "--mode", "--checkpoint_na_mpnn", "--pdb_path", "--out_folder",
        "--batch_size", "--number_of_batches", "--temperature", "--omit_AA",
        "--design_na_only", "--output_specificity", "--output_pdbs",
        "--output_sequences", "--seed", "--pad_to_bucket"],
    "run_na_mpnn_score": [
        "--mode", "--checkpoint_na_mpnn", "--pdb_path", "--out_folder",
        "--batch_size", "--number_of_batches", "--design_na_only", "--output_pdbs",
        "--output_sequences", "--stats_format", "--seed", "--pad_to_bucket"],
}


class _Stop(Exception):
    pass


@pytest.mark.parametrize("runner", sorted(HARNESS_FLAGS))
def test_harness_flags_keep_their_meaning(runner, monkeypatch):
    """Each runner's argv, captured before the CLI runs: exactly the named
    flags (and ``--device`` in the port), each an option of the port's
    parser with the JAX parser's type and default; the two parsed and
    mode-defaulted namespaces agree but for ``device``."""
    seen = {}
    for name, run_mod in (("jax", jrun), ("port", trun)):
        real = run_mod.build_argparser

        def recording(real=real, name=name):
            p = real()
            parse = p.parse_args

            def parse_args(argv):
                seen[name, "argv"] = list(argv)
                return parse(argv)
            p.parse_args = parse_args
            return p

        def stop(args, name=name):
            seen[name, "args"] = vars(args)
            raise _Stop

        monkeypatch.setattr(run_mod, "build_argparser", recording)
        monkeypatch.setattr(run_mod, "main", stop)
        harness = jharness if name == "jax" else tharness
        with pytest.raises(_Stop):
            getattr(harness, runner)("/x/s.pdb", "/o", na_mpnn_model_path="/m.npz",
                                     seed=4, pad_to_bucket=16, **CPU[name])
    flags = {k: [a for a in seen[k, "argv"] if a.startswith("--")]
             for k in ("jax", "port")}
    assert flags["jax"] == HARNESS_FLAGS[runner]
    assert flags["port"] == HARNESS_FLAGS[runner] + ["--device"]
    assert seen["port", "argv"][:-2] == seen["jax", "argv"]
    assert seen["port", "argv"][-2:] == ["--device", "cpu"]
    actions = {k: {a.option_strings[0]: a for a in mod.build_argparser()._actions}
               for k, mod in (("jax", jrun), ("port", trun))}
    for flag in HARNESS_FLAGS[runner]:
        a, b = actions["jax"][flag], actions["port"][flag]
        assert (b.dest, b.type, b.default, b.choices) == \
            (a.dest, a.type, a.default, a.choices), flag
    port_args = dict(seen["port", "args"])
    assert port_args.pop("device") == "cpu"
    assert port_args == seen["jax", "args"]
