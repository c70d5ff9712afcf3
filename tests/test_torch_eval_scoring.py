"""The port's numpy evaluation code against the JAX package's on the same
inputs, made with numpy from a seed: ``eval/scoring.py``,
``eval/superimpose.py``, the Hungarian extractor of
``eval/ribonanza_runner.py``, the parsers of ``eval/external.py`` and the
file helpers of ``eval/harness.py``. Both run the same numpy, so every
result is required equal (``==`` or ``assert_array_equal``), NaN where
NaN. Mirrors the cases of ``tests/test_eval.py`` that need no reference
module and the unit cases of ``tests/test_eval_monomer_rna.py``."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import json
import os

import numpy as np
import pytest

from na_mpnn_tpu import constants as jconstants
from na_mpnn_tpu.eval import external as jext
from na_mpnn_tpu.eval import harness as jharness
from na_mpnn_tpu.eval import ribonanza_runner as jrr
from na_mpnn_tpu.eval import scoring as jsc
from na_mpnn_tpu.eval import superimpose as jsup

from chip_smoke import write_synthetic_cif, write_synthetic_pdb
from na_mpnn_tpu_torch.eval import external as text
from na_mpnn_tpu_torch.eval import harness as tharness
from na_mpnn_tpu_torch.eval import ribonanza_runner as trr
from na_mpnn_tpu_torch.eval import scoring as tsc
from na_mpnn_tpu_torch.eval import superimpose as tsup


def same(a, b):
    """Equal results, recursively: dicts, sequences, arrays and floats
    (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (a, b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a, b)
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), (a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


def both(fn_name, *args, module=(jsc, tsc), **kwargs):
    """Call one function of both packages; equal results or the same
    exception type."""
    out = []
    for mod in module:
        try:
            out.append(("ok", getattr(mod, fn_name)(*args, **kwargs)))
        except Exception as e:  # noqa: BLE001 — the same error on both sides
            out.append(("raised", type(e).__name__))
    assert out[0][0] == out[1][0], out
    if out[0][0] == "ok":
        same(out[0][1], out[1][1])
    else:
        assert out[0][1] == out[1][1]
    return out[1]


# ---------------------------------------------------------------------------
# eval/scoring.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref,sub,kw", [
    ("ACGUACGUAXGU", "ACGUUCGUACGU", {"unknown_residue_allowed_in_reference": True}),
    ("ACG/UAC", "ACG/AAC", {"chain_breaks_allowed": True}),
    ("ACG/UAC", "ACGU/AC", {"chain_breaks_allowed": True}),   # breaks apart
    ("ACG", "AC", {}),                                      # lengths differ
    ("XXX", "ACG", {"unknown_residue_allowed_in_reference": True}),  # no residue
    ("ACGT", "ACGU", {}),                                   # invalid letter
])
def test_sequence_recovery(ref, sub, kw):
    both("calculate_sequence_recovery", ref, sub, **kw)


@pytest.mark.parametrize("seq,method,breaks", [
    ("bdhuy", "na_mpnn", False), ("AC?gu&AC", "dssr", False),
    ("AC?gu&AC", "dssr", True), ("ACGT", None, False)])
def test_standardize_sequence(seq, method, breaks):
    both("standardize_rna_sequence", seq, method=method, remove_chain_breaks=breaks)


@pytest.mark.parametrize("ss,kw", [
    ("((?..))&.", dict(method="dssr", replace_unknown_restypes=True,
                       remove_chain_breaks=True)),
    ("((?..))", {}), ("(([[..))]]Aa", {})])
def test_standardize_secondary_structure(ss, kw):
    both("standardize_secondary_structure", ss, **kw)


@pytest.mark.parametrize("ss", ["((..[[..))..]].", "((..((..))..)).", "(()", "().)",
                                "(a)", "..AB..ba..", "((((....))))"])
def test_base_pairs_and_crossed_pairs(ss):
    both("base_pairs_and_loops", ss)
    both("crossed_pair_quality_inputs", ss)


def test_secondary_structure_stats():
    for ref, sub in [("((..[[..))..]].", "((..((..))..))."),
                     ("((((....))))", "............"), ("(((...)))", "(((...)))"),
                     ("(..)", "(...)")]:
        both("calculate_secondary_structure_stats", ref, sub)


def test_reactivity_profile_score():
    rng = np.random.RandomState(0)
    for ss in ["((((....))))", "((..[[..))..]].", "............"]:
        for react in (rng.rand(len(ss)), np.full(len(ss), 0.5),
                      np.array([0.1] * 4 + [0.9] * 4 + [0.1] * 4)[:len(ss)]):
            both("calculate_reactivity_profile_score", ss, react)
    both("calculate_reactivity_profile_score", "(())", np.ones(3))


def test_ppm_metrics():
    rng = np.random.RandomState(0)
    a = rng.dirichlet(np.ones(4), size=12)
    b = rng.dirichlet(np.ones(4), size=12)
    b[3, 1] = 0.0                                   # log(0) in cross entropy
    for fn in ("calculate_ppm_mean_absolute_error",
               "calculate_ppm_root_mean_squared_error",
               "calculate_ppm_cross_entropy", "calculate_ppm_pearson"):
        both(fn, a, b)
        both(fn, a, b[:5])
    both("calculate_ppm_pearson", np.ones((3, 4)), np.ones((3, 4)))


def _planted_complex(seed):
    rng = np.random.RandomState(seed)
    t = jconstants.restype_to_int_table(True)
    S = np.concatenate([rng.randint(0, 20, size=10),
                        t["DA"] + rng.randint(0, 4, size=20),
                        t["A"] + rng.randint(0, 4, size=12)]).astype(np.int64)
    chain_labels = np.array([0] * 10 + [1] * 20 + [2] * 12, np.int32)
    protein_mask = np.array([1] * 10 + [0] * 32, np.int32)
    dna_mask = np.array([0] * 10 + [1] * 20 + [0] * 12, np.int32)
    rna_mask = np.array([0] * 30 + [1] * 12, np.int32)
    motif = np.full((8, 4), 0.02)
    for k in range(8):
        motif[k, int(S[12 + k]) - t["DA"]] = 0.94
    rna_ppm = rng.dirichlet(np.ones(4), size=6)
    ppms = [(motif, "dna"), (np.flip(np.flip(motif, 1), 0).copy(), "dna"),
            (rna_ppm, "rna")]
    predicted = rng.dirichlet(np.ones(33), size=len(S))
    mask = (rng.rand(len(S)) > 0.1).astype(np.int32)
    return ppms, S, chain_labels, protein_mask, dna_mask, rna_mask, predicted, mask


@pytest.mark.parametrize("seed", [3, 4])
def test_align_ppms_and_specificity_scores(seed):
    ppms, S, cl, pm, dm, rm, predicted, mask = _planted_complex(seed)
    out = both("align_ppms", ppms, S, cl, pm, dm, rm)[1]
    assert out[1].sum() > 0
    both("weighted_align", ppms[0][0], np.eye(4)[S[10:30] % 4], np.ones(20, bool))
    both("score_specificity_arrays", ppms, S, cl, pm, dm, rm, predicted, mask)
    # no RNA chain: the RNA scores are NaN on both sides
    both("score_specificity_arrays", ppms[:2], S[:30], cl[:30], pm[:30], dm[:30],
         rm[:30], predicted[:30], mask[:30])


# ---------------------------------------------------------------------------
# eval/superimpose.py
# ---------------------------------------------------------------------------

def test_superimpose_metrics():
    rng = np.random.RandomState(1)
    ref = rng.randn(40, 3) * 8
    theta = 0.7
    R = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0], [0, 0, 1]])
    sub = ref @ R.T + np.array([5.0, -3.0, 2.0]) + rng.randn(40, 3) * 0.05
    bad = sub + rng.randn(40, 3) * 3
    m = (jsup, tsup)
    for s in (sub, bad, sub[::-1].copy()):
        both("kabsch_superimpose", ref, s, module=m)
        both("rmsd", ref, s, module=m)
        both("superimposed_rmsd", ref, s, module=m)
        both("lddt", ref, s, module=m)
        both("lddt", ref, s, inclusion_radius=10000.0,
             thresholds=(1.0, 2.0, 4.0, 8.0), module=m)
        both("gdt", ref, s, module=m)
        both("structure_comparison_metrics", ref, s, module=m)
    both("lddt", ref[:1], sub[:1], module=m)        # no pair in the radius
    assert tsup.superimposed_rmsd(ref, sub) < 0.15


def test_load_atom_coords(tmp_path):
    pdb = str(tmp_path / "s.pdb")
    write_synthetic_pdb(pdb, (("A", "protein", 6), ("B", "rna", 9),
                              ("C", "dna", 7)), seed=5)
    cif = str(tmp_path / "s.cif")
    write_synthetic_cif(pdb, cif)
    for path in (pdb, cif):
        for atom in ("C1'", "CA", "P", "XX"):
            out = both("load_atom_coords", path, atom, module=(jsup, tsup))[1]
    assert tsup.load_atom_coords(pdb, "C1'").shape == (16, 3)
    np.testing.assert_array_equal(tsup.load_atom_coords(pdb, "C1'"),
                                  tsup.load_atom_coords(cif, "C1'"))
    assert out.shape == (0, 3)


# ---------------------------------------------------------------------------
# eval/ribonanza_runner.py: the Hungarian extractor
# ---------------------------------------------------------------------------

def _pair_matrix(n, pairs, p=0.95):
    m = np.zeros((n, n))
    for i, j in pairs:
        m[i, j] = m[j, i] = p
    return m


@pytest.mark.parametrize("case", ["planted", "helix", "random", "near_diagonal"])
def test_hungarian_extractor(case):
    m = (jrr, trr)
    rng = np.random.RandomState(7)
    if case == "planted":
        prob = _pair_matrix(20, [(0, 19), (1, 18), (2, 17), (5, 12), (6, 11)])
    elif case == "helix":
        prob = _pair_matrix(20, [(0, 19), (5, 15), (6, 14), (7, 13)])
    elif case == "random":
        a = rng.rand(30, 30)
        prob = (a + a.T) / 2
    else:
        prob = _pair_matrix(12, [(3, 5), (0, 11)])
    for theta, min_len in ((0.5, 1), (0.5, 2), (0.3, 3)):
        both("hungarian_base_pairs", prob, theta=theta, min_len_helix=min_len,
             module=m)
        both("extract_secondary_structure", prob, theta=theta,
             min_len_helix=min_len, module=m)
    both("mask_diagonal", prob, module=m)
    both("mask_diagonal", prob, width=2, mask_value=-1.0, module=m)


def test_dot_bracket_layers():
    m = (jrr, trr)
    for pairs, n in (([(0, 10), (1, 9), (4, 14)], 16),
                     ([(0, 5), (2, 8), (4, 11), (7, 13)], 14), ([], 4)):
        ss = both("pairs_to_dot_bracket", pairs, n, module=m)[1]
        assert sorted(tsc.base_pairs_and_loops(ss)[0]) == sorted(pairs)


def test_runner_main_writes_the_result(tmp_path, monkeypatch):
    """The runner's CLI with its site model stubbed: the same result file as
    the JAX runner's."""
    class Model:
        def __call__(self, seq, *rest):
            import torch
            n = seq.shape[1]
            if rest:                                  # reactivity: [1, n, 2]
                return torch.linspace(0, 1, 2 * n).reshape(1, n, 2)
            a = torch.arange(n * n, dtype=torch.float32).reshape(1, n, n) % 7 - 3
            return a + a.transpose(1, 2)

    outs = {}
    for name, mod in (("jax", jrr), ("port", trr)):
        monkeypatch.setattr(mod, "load_model", lambda mode: Model())
        for mode in ("reactivity_profile", "secondary_structure"):
            d = str(tmp_path / name / mode)
            mod.main([mode, "GGGAAACCCUUU", d, "2"])
            outs[name, mode] = np.load(os.path.join(d, "output.npy"),
                                       allow_pickle=True).item()
    for mode in ("reactivity_profile", "secondary_structure"):
        same(outs["jax", mode], outs["port", mode])
    with pytest.raises(ValueError):
        trr._sequence_tensor("ACGT")


# ---------------------------------------------------------------------------
# eval/external.py: parsers and the unconfigured tools
# ---------------------------------------------------------------------------

DSSR = """\
Some preamble
****************************************************************************
Secondary structures in dot-bracket notation (dbn) as a whole and per chain
>4oqu nts=12 [whole]
GGGGAAAACCCC
((((....))))
****************************************************************************
"""


@pytest.mark.parametrize("report", [
    DSSR, DSSR.replace("GGGGAAAACCCC", "GGGG&AAACCCC"), ">x\nACGU\n(..)\n",
    "no structure here", ">a\nACGU\n((..))\n>b\nAC\n()\n"])
def test_parse_dssr_output(report):
    both("parse_dssr_output", report, module=(jext, text))


def test_deeppbs_output_conversion():
    rng = np.random.RandomState(0)
    for L in (1, 6, 11):
        P = rng.rand(L, 4)
        P /= P.sum(-1, keepdims=True)
        seq = np.eye(4)[rng.randint(0, 4, L)]
        both("deeppbs_output_to_result", {"P": P, "Seq": seq}, "s", "/x/s.pdb",
             module=(jext, text))


def test_grnade_and_rhodesign_parsers():
    entries = [("native", "ACGU"), ("sample=0, recovery=0.75", "ACGG"),
               ("sample=1, recovery=0.5", "AC\nCU")]
    both("parse_grnade_fasta", entries, "rna1", "/x/rna1.pdb", module=(jext, text))
    for out in ("some log\nsequence: ACGUACGU\nrecovery rate: 0.625\n",
                "sequence: A\n", "nothing useful"):
        both("parse_rhodesign_output", out, module=(jext, text))


def test_external_tools_raise_when_unconfigured(monkeypatch, tmp_path):
    for var in ("DEEPPBS_CMD", "GRNADE_CMD", "RHODESIGN_CMD", "RIBONANZA_NET_DIR",
                "DSSR_BINARY", "ETERNAFOLD_BINARY", "USALIGN_BINARY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    pdb = str(tmp_path / "r.pdb")
    write_synthetic_pdb(pdb, (("A", "rna", 8),))
    for call in (lambda m: m.run_grnade(pdb), lambda m: m.run_rhodesign(pdb),
                 lambda m: m.run_deeppbs(pdb), lambda m: m.run_dssr(pdb),
                 lambda m: m.run_eternafold("ACGU"),
                 lambda m: m.run_us_align(pdb, pdb),
                 lambda m: m.run_alphafold3("x", "ACGU", str(tmp_path)),
                 lambda m: m.run_ribonanza_net_secondary_structure("ACGU"),
                 lambda m: m.run_ribonanza_net_reactivity_profile("ACGU")):
        for m in (jext, text):
            with pytest.raises(m.ExternalToolUnavailable):
                call(m)


def test_ribonanza_stage_launches_the_ports_runner(monkeypatch, tmp_path):
    """The RibonanzaNet stage runs ``na_mpnn_tpu_torch.eval.ribonanza_runner``
    in a subprocess (the JAX stage runs its own package's)."""
    seen = []

    def fake_run(argv, check):
        seen.append(argv)
        np.save(os.path.join(argv[-2], "output.npy"), np.asarray(
            {"predicted_secondary_structures": ["(..)"]}, dtype=object),
            allow_pickle=True)

    monkeypatch.setenv("RIBONANZA_NET_DIR", str(tmp_path))
    monkeypatch.setattr(text.subprocess, "run", fake_run)
    out = text.run_ribonanza_net_secondary_structure("ACGU", batch_size=3)
    assert out == {"predicted_secondary_structures": ["(..)"]}
    assert seen[0][1:3] == ["-m", "na_mpnn_tpu_torch.eval.ribonanza_runner"]
    assert seen[0][3:5] == ["secondary_structure", "ACGU"] and seen[0][-1] == "3"


# ---------------------------------------------------------------------------
# eval/harness.py: file helpers
# ---------------------------------------------------------------------------

def test_harness_helpers(tmp_path):
    m = (jharness, tharness)
    for h in ("4oqu, id=3, T=0.1, seed=7, overall_confidence=0.8123 seq_rec=0.4321",
              "native, score=1.0", ""):
        both("parse_design_fasta_header", h, module=m)
    for n in (0, 25, 26, 27, 701, 702, 18277):
        both("chain_num_to_chain_id", n, module=m)
    rng = np.random.RandomState(2)
    ppm = rng.dirichlet(np.ones(33), size=15)
    dna = (rng.rand(15) > 0.5).astype(np.int32)
    rna = ((1 - dna) * (rng.rand(15) > 0.5)).astype(np.int32)
    both("compute_human_readable_ppm", ppm, dna, rna, module=m)
    entries = [("a, id=0", "ACGU"), ("b", "GG/CC")]
    for name, mod in (("j.fa", jharness), ("t.fa", tharness)):
        mod.write_fasta_file(str(tmp_path / name), entries)
        mod.write_json_file(str(tmp_path / (name + ".json")), {"x": [1, 2]})
    assert open(tmp_path / "j.fa").read() == open(tmp_path / "t.fa").read()
    assert open(tmp_path / "j.fa.json").read() == open(tmp_path / "t.fa.json").read()
    assert tharness.read_fasta_file(str(tmp_path / "t.fa")) == entries
    assert json.load(open(tmp_path / "t.fa.json")) == {"x": [1, 2]}
    for bad in ("x.txt", "y.pdb.gz", "z.cif"):
        both("_structure_name", bad, module=m)
