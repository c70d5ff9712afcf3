"""mmCIF input in the port (``data/cif.py``, ``data/pdb.py::read_cif_atoms``)
against the JAX package's readers on the same synthetic files (the writers
of ``test_inference_cif.py``): the same atom records and ``parse_pdb``
features from ``.cif``, ``.cif.gz``, ``.mmcif`` and upper-case names, the
same fallbacks for mmCIF null tokens and multi-character chain IDs, a
``ValueError`` without ``atom_site``, and the port's CLI on an mmCIF
input."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import os

import numpy as np
import pytest

from na_mpnn_tpu.data.pdb import parse_pdb as jax_parse_pdb
from na_mpnn_tpu.data.pdb import read_cif_atoms as jax_read_cif_atoms

from na_mpnn_tpu_torch.data.pdb import parse_pdb, read_cif_atoms, read_pdb_atoms
from test_inference_cif import _make_atoms, _write_cif, _write_pdb

FIELDS = ("record", "name", "altloc", "resname", "chain", "resnum", "icode",
          "occupancy", "bfactor", "element")


def _same_atoms(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in FIELDS:
            assert getattr(x, f) == getattr(y, f), (f, x, y)
        np.testing.assert_array_equal(x.xyz, y.xyz)


def _same_parse(a, b):
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        elif k in ("chain_letters", "na_chain_letters", "icodes", "resnames",
                   "chain_list"):
            assert a[k] == v, k
    assert len(a["backbone_atoms"]) == len(b["backbone_atoms"])


def test_cif_atoms_match_jax_and_pdb(tmp_path):
    recs = _make_atoms()
    cif = _write_cif(tmp_path / "s.cif", recs)
    got = read_cif_atoms(cif)
    _same_atoms(got, jax_read_cif_atoms(cif))
    pdb_atoms = read_pdb_atoms(_write_pdb(tmp_path / "s.pdb", recs))
    assert len(pdb_atoms) == len(got) == len(recs)
    for a, b in zip(pdb_atoms, got):
        for f in ("record", "name", "resname", "chain", "resnum", "icode",
                  "occupancy", "bfactor", "element"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.xyz, b.xyz)


@pytest.mark.parametrize("name", ["s.cif", "s.cif.gz", "S.CIF", "s.mmcif",
                                  "s.mmcif.gz"])
def test_parse_pdb_on_cif_matches_jax_and_the_pdb(tmp_path, name):
    recs = _make_atoms(seed=3)
    ref = parse_pdb(_write_pdb(tmp_path / "s.pdb", recs))
    path = _write_cif(tmp_path / name, recs)
    got = parse_pdb(path)
    _same_parse(got, jax_parse_pdb(path))
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["chain_letters"] == ref["chain_letters"]


def test_cif_null_tokens_and_multichar_chains(tmp_path):
    text = """data_X
#
loop_
_atom_site.group_PDB
_atom_site.type_symbol
_atom_site.label_atom_id
_atom_site.label_comp_id
_atom_site.auth_asym_id
_atom_site.label_asym_id
_atom_site.auth_seq_id
_atom_site.label_seq_id
_atom_site.label_alt_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
_atom_site.occupancy
_atom_site.B_iso_or_equiv
_atom_site.pdbx_PDB_model_num
ATOM C CA GLY . B . 5 . 1.0 2.0 3.0 1.0 10.0 1
ATOM ? "C1'" DA AA X 7 7 . 4.0 5.0 6.0 1.0 10.0 1
ATOM C CB ALA A A 8 8 B 1.0 1.0 1.0 1.0 10.0 1
ATOM C CA ALA A A 9 9 . 1.0 1.0 1.0 0.0 10.0 1
ATOM C CA ALA A A 10 10 . 1.0 1.0 1.0 1.0 10.0 2
"""
    p = tmp_path / "n.cif"
    p.write_text(text)
    atoms = read_cif_atoms(str(p))
    _same_atoms(atoms, jax_read_cif_atoms(str(p)))
    assert len(atoms) == 2   # altloc B, occupancy 0 and model 2 are dropped
    assert atoms[0].resnum == 5 and atoms[0].chain == "B" and atoms[0].element == "C"
    assert atoms[1].chain == "AA" and atoms[1].resnum == 7 and atoms[1].element == "C"
    assert len(read_cif_atoms(str(p), first_model_only=False)) == 3


def test_cif_without_atom_site_raises_value_error(tmp_path):
    p = tmp_path / "comp.cif"
    p.write_text("data_PX4\n_chem_comp.id PX4\n")
    with pytest.raises(ValueError, match="atom_site"):
        read_cif_atoms(str(p))
    with pytest.raises(ValueError, match="atom_site"):
        parse_pdb(str(p))


def test_design_cli_accepts_cif(tmp_path):
    """The port's CLI on an mmCIF input writes what it writes for the same
    structure as PDB: the same files, shapes and native sequence."""
    from na_mpnn_tpu_torch.cli.run import cli_entry
    from na_mpnn_tpu_torch.models import ModelConfig, init_params
    from na_mpnn_tpu_torch.params import save_checkpoint_npz

    recs = _make_atoms(seed=5)
    ckpt = str(tmp_path / "m.npz")
    save_checkpoint_npz(ckpt, init_params(0, ModelConfig(), device="cpu"))
    outs = {}
    for ext, writer in (("cif", _write_cif), ("pdb", _write_pdb)):
        path = writer(tmp_path / f"s.{ext}", recs)
        out = str(tmp_path / f"out_{ext}")
        cli_entry(["--mode", "design", "--checkpoint_na_mpnn", ckpt,
                   "--pdb_path", path, "--out_folder", out, "--seed", "7",
                   "--batch_size", "2", "--save_stats", "1", "--stats_format",
                   "npz", "--device", "cpu"])
        outs[ext] = out
        assert open(os.path.join(out, "seqs", "s.fa")).read().startswith(">s,")
    a = np.load(os.path.join(outs["cif"], "stats", "s.npz"))
    b = np.load(os.path.join(outs["pdb"], "stats", "s.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape, k
    np.testing.assert_array_equal(a["native_sequence"], b["native_sequence"])
