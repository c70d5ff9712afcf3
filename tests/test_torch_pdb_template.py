"""The backbone PDB writer's template (``data/pdb.py::BackboneTemplate``)
against the JAX package's writer (``na_mpnn_tpu.data.pdb.write_backbone_pdb``,
one ``_format_atom_line`` per atom): every file is byte for byte the
reference's, on parsed structures (protein with four DNA strands, RNA with
O2', a LigandMPNN view with context atoms) and on atoms built to overflow
the fixed columns (serials past 99,999, residue numbers past ``%4d``,
coordinates past ``%8.3f``), with insertion codes, altlocs,
multi-character chains, 4-letter atom names, 2-letter elements, ``UNK``
names, B-factors at ``%6.2f`` ties and the CLI's ``bf > 0.01`` zeroing,
and fields the template cannot hold (non-ASCII text, its own marker bytes,
a name or B-factor wider than its column). The CLI writes its samples'
files through one template per structure, inside a ``cli.pdbs`` span that
counts the files written and the templates built."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import collections
import os

import numpy as np
import pytest
import torch

import chip_smoke
from na_mpnn_tpu.data.pdb import write_backbone_pdb as reference_write
from na_mpnn_tpu_torch import constants, trace
from na_mpnn_tpu_torch.cli.run import cli_entry
from na_mpnn_tpu_torch.data import seq_format
from na_mpnn_tpu_torch.data.featurize import get_score
from na_mpnn_tpu_torch.data.ligand_input import ligand_view
from na_mpnn_tpu_torch.data.pdb import (BackboneTemplate, PDBAtom, parse_pdb,
                                        write_backbone_pdb)
from na_mpnn_tpu_torch.models import ModelConfig, init_params
from na_mpnn_tpu_torch.params import save_checkpoint_npz

THREE = sorted(set(constants.RESTYPE_1_TO_3.values()))


def cli_bfactors(loss_per_residue):
    """The CLI's B-factors: exp(-loss), zero where the loss is at most 0.01."""
    bf = np.asarray(loss_per_residue, np.float32)
    return np.exp(-bf) * (bf > 0.01).astype(np.float32)


def random_samples(rng, n_res, count):
    """``count`` samples of distinct residue names and CLI B-factors, some
    losses at or under 0.01."""
    samples = []
    for _ in range(count):
        names = [THREE[k] for k in rng.integers(0, len(THREE), n_res)]
        loss = rng.exponential(1.0, n_res).astype(np.float32)
        loss[rng.random(n_res) < 0.1] = rng.choice([0.0, 0.005, 0.01], 1)[0]
        samples.append((names, cli_bfactors(loss)))
    return samples


def atom(name, resname, chain, resnum, xyz, element, record="ATOM", altloc=" ",
         icode="", occupancy=1.0):
    return PDBAtom(record, 0, name, altloc, resname, chain, resnum, icode,
                   np.asarray(xyz, np.float32), occupancy, 10.0, element, "")


def parsed_of(residues, others=()):
    return {"backbone_atoms": [list(r) for r in residues], "other_atoms": list(others)}


def synthetic(tmp_path, chains, name="s.pdb"):
    path = str(tmp_path / name)
    chip_smoke.write_synthetic_pdb(path, chains, seed=2)
    return path


def case_specificity_dna(tmp_path, rng):
    parsed = parse_pdb(synthetic(tmp_path, (("A", "protein", 30), ("B", "protein", 12),
                                             ("C", "dna", 8), ("D", "dna", 8),
                                             ("E", "dna", 7), ("F", "dna", 6))))
    return parsed, random_samples(rng, len(parsed["backbone_atoms"]), 30)


def case_rna_o2(tmp_path, rng):
    parsed = parse_pdb(synthetic(tmp_path, (("R", "rna", 20), ("S", "rna", 9))))
    assert any(a.name == "O2'" for res in parsed["backbone_atoms"] for a in res)
    return parsed, random_samples(rng, len(parsed["backbone_atoms"]), 4)


def case_ligand_context(tmp_path, rng):
    path = synthetic(tmp_path, (("A", "protein", 24), ("B", "dna", 6)))
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln != "END"]
    for i, el in enumerate(["C", "N", "O", "S", "CL", "FE", "P", "BR"]):
        xyz = rng.standard_normal(3) * 3.0
        lines.append(f"HETATM{900 + i:>5} {(el + str(i))[:4]:<4} LIG L   1    "
                     f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00 10.00          {el:>2}")
    with open(path, "w") as f:
        f.write("\n".join(lines + ["END"]) + "\n")
    view = ligand_view(path, parse_pdb(path))
    assert len(view["other_atoms"]) > 8
    return view, random_samples(rng, len(view["backbone_atoms"]), 3)


def case_insertion_altloc_chain(tmp_path, rng):
    residues = [[atom(n, "ALA", chain, 10, rng.standard_normal(3) * 9, n[0],
                      altloc=alt, icode=ic) for n in ("N", "CA", "C", "O")]
                for chain, alt, ic in (("A", " ", ""), ("A", "A", "A"), ("AB", "B", "B"),
                                       ("XYZ", " ", "Z"), ("b", "A", ""))]
    return parsed_of(residues), random_samples(rng, len(residues), 3)


def case_long_names_two_letter_elements(tmp_path, rng):
    residues = [[atom("HO5'", "DA", "C", 1, (1, 2, 3), "H"),
                 atom("O5'", "DA", "C", 1, (1.5, 2, 3), "O"),
                 atom("SE", "MSE", "C", 2, (4, 5, 6), "SE"),
                 atom("CA", "MSE", "C", 2, (4, 5.5, 6), "C")],
                [atom("C1'", "DA", "C", 3, (7, 8, 9), "C"),
                 atom("FE", "HEM", "C", 3, (7, 8, 9.5), "FE")]]
    others = [atom("CL", "CL", "L", 1, (0, 0, 0), "CL", record="HETATM"),
              atom("C12", "LIG", "L", 2, (1, 1, 1), "C", record="HETATM"),
              atom("ZN1", "ZN", "L", 3, (2, 2, 2), "ZN", record="HETATM")]
    return parsed_of(residues, others), random_samples(rng, len(residues), 3)


def case_coordinates_overflow(tmp_path, rng):
    coords = [(-1000.0, 0.0, 0.0), (-1234.5678, -9999.9995, 5.0), (10000.0, 1.0, 2.0),
              (12345.678, 99999.999, -0.0004), (-0.0, 0.0005, 9999.9996)]
    residues = [[atom("P", "DG", "D", k, xyz, "P"), atom("C1'", "DG", "D", k, xyz, "C")]
                for k, xyz in enumerate(coords, 1)]
    return parsed_of(residues), random_samples(rng, len(residues), 3)


def case_resnum_overflow(tmp_path, rng):
    residues = [[atom("CA", "GLY", "A", n, rng.standard_normal(3), "C")]
                for n in (-999, -1000, 9999, 10000, -12345, 123456)]
    return parsed_of(residues), random_samples(rng, len(residues), 3)


def case_serial_overflow(tmp_path, rng):
    n_res = 25_100        # 100,400 atoms
    xyz = rng.uniform(-99, 99, (n_res, 3)).astype(np.float32)
    residues = [[atom(n, "LEU", "A", i % 9999 + 1, xyz[i], n[0])
                 for n in ("N", "CA", "C", "O")] for i in range(n_res)]
    others = [atom("O", "HOH", "W", 1, (1, 2, 3), "O", record="HETATM")]
    return parsed_of(residues, others), random_samples(rng, n_res, 2)


def case_bfactor_ties(tmp_path, rng):
    residues = [[atom("CA", "ALA", "A", k, (k, 0, 0), "C")] for k in range(1, 15)]
    # float32 values on, just under and just over the %6.2f halfway points,
    # and losses around the 0.01 cut
    ties = np.array([0.125, 0.375, 0.625, 0.875, 0.005, 0.015, 0.995, 0.045,
                     0.335, 0.665, 0.0, 1.0, 0.994999, 0.005001], np.float32)
    loss = np.array([0.01, np.nextafter(np.float32(0.01), np.float32(1)), 0.0, 0.005,
                     0.011, 2.0794415, 0.2876821, 1e-8, 0.01, 0.02, 5.0, 0.9808292,
                     0.47, 0.0100001], np.float32)
    return parsed_of(residues), [(["ALA"] * 14, ties), (["GLY"] * 14, cli_bfactors(loss))]


def case_unk_names(tmp_path, rng):
    parsed = parse_pdb(synthetic(tmp_path, (("A", "protein", 10), ("B", "dna", 5))))
    n = len(parsed["backbone_atoms"])
    seq = "".join(rng.choice(list("ACDEFGXZ*"), n))
    names = [constants.RESTYPE_1_TO_3.get(c, "UNK") for c in seq]
    assert "UNK" in names
    wide = ["UNK"] * n
    wide[1], wide[3] = "ABCD", "DA"             # a name wider than its column
    big = np.full(n, 0.5, np.float32)
    big[2] = 1234.5                            # a B-factor wider than its column
    return parsed, [(names, cli_bfactors(rng.exponential(1.0, n))), (wide, big),
                    (["UNK"] * n, np.zeros(n, np.float32))]


def case_non_ascii(tmp_path, rng):
    residues = [[atom("CA", "ALA", "Ω", 1, (1, 2, 3), "C")],
                [atom("CA", "GLY", "A", 2, (4, 5, 6), "C")]]
    return parsed_of(residues), random_samples(rng, len(residues), 2)


def case_marker_bytes_in_fields(tmp_path, rng):
    residues = [[atom("CA", "ALA", "A", 1, (1, 2, 3), "C", altloc="\x01")],
                [atom("CA", "GLY", "A", 2, (4, 5, 6), "C", icode="\x02")]]
    return parsed_of(residues), random_samples(rng, len(residues), 2)


CASES = {f.__name__[len("case_"):]: f for f in (
    case_specificity_dna, case_rna_o2, case_ligand_context, case_insertion_altloc_chain,
    case_long_names_two_letter_elements, case_coordinates_overflow, case_resnum_overflow,
    case_serial_overflow, case_bfactor_ties, case_unk_names,
    case_non_ascii, case_marker_bytes_in_fields)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_template_writes_the_per_atom_writers_bytes(tmp_path, case):
    parsed, samples = CASES[case](tmp_path, np.random.default_rng(len(case)))
    template = BackboneTemplate(parsed)
    for k, (names, bfactors) in enumerate(samples):
        got, want = str(tmp_path / f"got_{k}.pdb"), str(tmp_path / f"want_{k}.pdb")
        template.write(got, names, bfactors)
        reference_write(want, parsed, names, bfactors)
        with open(got, "rb") as g, open(want, "rb") as w:
            assert g.read() == w.read(), (case, k)
    names, bfactors = samples[0]
    one = str(tmp_path / "one.pdb")
    write_backbone_pdb(one, parsed, names, bfactors)
    with open(one, "rb") as g, open(str(tmp_path / "want_0.pdb"), "rb") as w:
        assert g.read() == w.read(), case


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pdbs")
    pdb = str(d / "complex.pdb")
    chip_smoke.write_synthetic_pdb(pdb, (("A", "protein", 20), ("B", "protein", 8),
                                         ("C", "dna", 6), ("D", "dna", 6)), seed=4)
    ckpt = str(d / "model.npz")
    save_checkpoint_npz(ckpt, init_params(5, ModelConfig(), device="cpu"))
    return d, pdb, ckpt


@pytest.mark.parametrize("mode,batch", [("specificity", 30), ("design", 1)])
def test_cli_writes_each_sample_through_one_template(cli_inputs, monkeypatch, mode, batch):
    d, pdb, ckpt = cli_inputs
    out = str(d / mode)
    built = []
    init = BackboneTemplate.__init__

    def counted_init(self, parsed):
        built.append(self)
        init(self, parsed)

    monkeypatch.setattr(BackboneTemplate, "__init__", counted_init)
    trace.clear()
    trace.enable()
    try:
        cli_entry(["--mode", mode, "--checkpoint_na_mpnn", ckpt, "--pdb_path", pdb,
                   "--out_folder", out, "--device", "cpu", "--seed", "3",
                   "--batch_size", str(batch), "--output_pdbs", "1", "--save_stats", "1",
                   "--stats_format", "npz"])
        recs = trace.records()
    finally:
        trace.disable()
        trace.clear()
    by = collections.defaultdict(list)
    for r in recs:
        by[r.name].append(r)
    pdbs, = by["cli.pdbs"]
    outputs, = by["cli.outputs"]
    assert outputs.t0 <= pdbs.t0 <= pdbs.t1 <= outputs.t1
    assert pdbs.counts == {"files": batch, "templates": 1}
    assert len(built) == 1

    # the served sequences and B-factors, from the stats the call saved
    parsed = parse_pdb(pdb)
    stats = np.load(os.path.join(out, "stats", "complex.npz"))
    S = stats["generated_sequences"]
    assert S.shape[0] == batch
    _, loss = get_score(torch.as_tensor(S), torch.as_tensor(stats["log_probs"]),
                        torch.ones(S.shape), constants.NUM_LETTERS)
    _, int_to_str, dna_to_rna = seq_format.token_maps(True)
    for ix in range(batch):
        seq = seq_format.ints_to_seq(S[ix], parsed["rna_mask_for_token_conversion"],
                                     int_to_str, dna_to_rna)
        names = [constants.RESTYPE_1_TO_3.get(c, "UNK") for c in seq]
        want = str(d / f"want_{mode}_{ix}.pdb")
        reference_write(want, parsed, names, cli_bfactors(loss[ix].numpy()))
        with open(os.path.join(out, "backbones", f"complex_{ix + 1}.pdb"), "rb") as g, \
                open(want, "rb") as w:
            assert g.read() == w.read(), (mode, ix)
