"""The port's ligand residue library (``na_mpnn_tpu_torch/data/ligands.py``)
and its use by the port's ``CIFParser``, against the JAX package's on the
same inputs: the 21 tests of ``tests/test_ligands.py``, each with that
test's assertions on the port's result and the port's result held to
JAX's (strings, integers and automorphism rows exact, float arrays within
1e-12)."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import copy
import dataclasses

import numpy as np
import pytest

import na_mpnn_tpu.data.cif as jax_cif
import na_mpnn_tpu.data.ligands as jl
import na_mpnn_tpu_torch.data.cif as tcif
import na_mpnn_tpu_torch.data.ligands as tl
from test_ligands import (LIGAND_STRUCTURE_CIF, MODIFIED_STRUCTURE_CIF, PO4_CIF,
                          SDF_ETHANOLAMINE, _atom, _benzene, _bond)


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _same(a, b, where="result"):
    """Deep equality of two results of the two packages: containers by
    structure, floats (and float arrays) within 1e-12 with NaN equal to NaN,
    everything else exact."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        a, b = ({f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
                for x in (a, b))
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a, b)
        if hasattr(a, "_fields"):
            assert a._fields == b._fields, where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, equal_nan=True,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float):
        assert isinstance(b, float) and (abs(a - b) <= 1e-12 or (a != a and b != b)), \
            (where, a, b)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _parse_both(path):
    raw = tl.parse_chem_comp_cif(path)
    _same(raw, jl.parse_chem_comp_cif(path))
    return raw


def _residue_both(raw):
    res = tl.build_residue(copy.deepcopy(raw))
    _same(res, jl.build_residue(copy.deepcopy(raw)))
    return res


def test_parse_chem_comp_cif(tmp_path):
    raw = _parse_both(_write(tmp_path, "PX4.cif", PO4_CIF))
    assert raw["name"] == "PX4"
    assert len(raw["atoms"]) == 6
    assert len(raw["bonds"]) == 5
    o4b = [a for a in raw["atoms"] if a["atom_id"] == "O4B"][0]
    assert o4b["leaving"] is True
    o1 = [a for a in raw["atoms"] if a["atom_id"] == "O1"][0]
    assert o1["charge"] == -1
    p = [b for b in raw["bonds"] if b["b"] == "O3"][0]
    assert p["order"] == 2


def test_build_residue_leaving_groups_and_parents(tmp_path):
    res = _residue_both(_parse_both(_write(tmp_path, "PX4.cif", PO4_CIF)))
    assert res.atoms["O4"].leaving_group == ["O4B"]
    assert res.atoms["P"].leaving_group == []
    assert res.atoms["O1"].parent == "P"
    assert res.atoms["O4B"].parent == "O4"
    assert "P" in res.planars
    assert res.chirals == []


def test_automorphisms_swap_equivalent_oxygens(tmp_path):
    res = _residue_both(_parse_both(_write(tmp_path, "PX4.cif", PO4_CIF)))
    autos = np.asarray(res.automorphisms)
    assert autos.shape[0] >= 2
    assert "P" not in autos[0]
    id_row = autos[0].tolist()
    assert any(row.tolist() != id_row for row in autos[1:])
    assert not any("O4B" in row for row in autos.tolist())


def test_find_automorphisms_filters_identity_only():
    args = (["C", "O", "N"], ["C", "O", "N"], [("C", "O"), ("O", "N")])
    out = tl.find_automorphisms(*args)
    _same(out, jl.find_automorphisms(*args))
    assert out == []


def test_residue_library_lazy_and_json_roundtrip(tmp_path):
    _write(tmp_path, "PX4.cif", PO4_CIF)
    lib = tl.ResidueLibrary(cif_dir=str(tmp_path))
    assert "PX4" in lib and "ZZZ" not in lib
    res = lib.get("PX4")
    assert res is not None and res.name == "PX4"
    assert lib.get("PX4") is res
    _same(res, jl.ResidueLibrary(cif_dir=str(tmp_path)).get("PX4"))
    json_path = str(tmp_path / "ligands.json.gz")
    lib.save_json(json_path)
    jax_json = str(tmp_path / "jax_ligands.json")
    jl.ResidueLibrary(cif_dir=str(tmp_path)).save_json(jax_json)
    lib2 = tl.ResidueLibrary(json_path=json_path)
    assert lib2.get("PX4").atoms["O4"].leaving_group == ["O4B"]
    # the port's file reads back in JAX's library, and JAX's in the port's
    _same(lib2.get("PX4"), jl.ResidueLibrary(json_path=json_path).get("PX4"))
    _same(tl.ResidueLibrary(json_path=jax_json).get("PX4"), res)
    lib3 = tl.ResidueLibrary(json_path=json_path, skip_res=["PX4"])
    assert lib3.get("PX4") is None


def _chains_same(a, b):
    assert list(a) == list(b)
    for k in a:
        _same(tuple(a[k]), tuple(b[k]), f"chain {k}")


def test_cif_ligand_and_composite_assembly_roundtrip(tmp_path):
    _write(tmp_path, "PX4.cif", PO4_CIF)
    struct = _write(tmp_path, "test.cif", LIGAND_STRUCTURE_CIF)
    parser = tcif.CIFParser(residue_library=tl.ResidueLibrary(cif_dir=str(tmp_path)))
    chains, asmb, covale, meta = parser.parse(struct)
    jparser = jax_cif.CIFParser(residue_library=jl.ResidueLibrary(cif_dir=str(tmp_path)))
    jchains, jasmb, jcovale, jmeta = jparser.parse(struct)
    _chains_same(chains, jchains)
    _same((asmb, covale, meta), (jasmb, jcovale, jmeta))

    assert chains["A"].type == "polypeptide(L)"
    assert chains["B"].type == "nonpoly"
    assert len(chains["B"].atoms) == 5
    assert len(asmb["1"]) == 4
    xforms = [x for cid, x in asmb["1"] if cid == "A"]
    assert len(xforms) == 2
    expected = np.eye(4)
    expected[0, 3], expected[1, 3], expected[2, 3] = 5, 0, 5
    assert any(np.allclose(x, expected) for x in xforms)

    ligands = parser.ligand_residues(chains)
    _same(ligands, jparser.ligand_residues(jchains))
    assert ("B", "9", "PX4") in ligands
    assert ligands[("B", "9", "PX4")].atoms["O1"].parent == "P"
    assert isinstance(ligands[("B", "9", "PX4")], tl.LigandResidue)


def test_parse_operation_expression_forms():
    for expr, want in (("1-4", ["1", "2", "3", "4"]), ("(1,2,5)", ["1", "2", "5"]),
                       ("P,X0", ["P", "X0"]), (" 1-2,7 ", ["1", "2", "7"])):
        assert tcif.parse_operation_expression(expr) == want
        assert jax_cif.parse_operation_expression(expr) == want


def test_save_all_roundtrip(tmp_path):
    from na_mpnn_tpu.data.pdb import read_pdb_atoms as jax_read
    from na_mpnn_tpu_torch.data.pdb import read_pdb_atoms

    struct = _write(tmp_path, "test.cif", LIGAND_STRUCTURE_CIF)
    chains, asmb, covale, meta = tcif.CIFParser().parse(struct)
    jchains = jax_cif.CIFParser().parse(struct)[0]

    out, jout = str(tmp_path / "out.pdb"), str(tmp_path / "jout.pdb")
    first_atom = next(iter(chains["A"].atoms))
    first_lig = next(iter(chains["B"].atoms))
    tcif.save_all(chains, [(first_atom, first_lig)], out)
    jax_cif.save_all(jchains, [(first_atom, first_lig)], jout)
    text = open(out).read()
    assert text == open(jout).read()
    assert "TER" in text and "CONECT" in text and "HETATM" in text

    atoms = read_pdb_atoms(out, use_native=False)
    _same(atoms, jax_read(out, use_native=False))
    n_in = sum(len(c.atoms) for c in chains.values())
    assert len(atoms) == n_in
    assert {a.chain for a in atoms} == {"A", "B"}

    single, jsingle = str(tmp_path / "single.pdb"), str(tmp_path / "jsingle.pdb")
    tcif.save_chain(chains["A"], single)
    jax_cif.save_chain(jchains["A"], jsingle)
    assert open(single).read() == open(jsingle).read()
    assert len(read_pdb_atoms(single, use_native=False)) == len(chains["A"].atoms)


def test_automorphisms_respect_charge_and_bond_order(tmp_path):
    res = _residue_both(_parse_both(_write(tmp_path, "PX4.cif", PO4_CIF)))
    autos = np.asarray(res.automorphisms)
    assert autos.shape[0] == 2
    assert not any("O3" in row for row in autos.tolist())
    swapped = [row for row in autos.tolist() if row != autos[0].tolist()]
    assert swapped and set(swapped[0]) == {"O1", "O2"}


def _topology_both(raw):
    topo = tl.get_topology(copy.deepcopy(raw))
    _same(topo, jl.get_topology(copy.deepcopy(raw)))
    return topo


def test_get_topology_counts_and_lengths(tmp_path):
    topo = _topology_both(_parse_both(_write(tmp_path, "PX4.cif", PO4_CIF)))
    assert topo["bonds"].shape == (5, 2)
    assert np.isclose(topo["bondlen"][0], 1.5)
    assert topo["angles"].shape == (7, 3)
    assert topo["dihedrals"].shape == (3, 4)


def test_bondlen_falls_back_to_covalent_radii():
    raw = {"name": "XX", "atoms": [_atom("C1", "C", [np.nan] * 3),
                                   _atom("C2", "C", [np.nan] * 3)],
           "bonds": [_bond("C1", "C2", 2)]}
    topo = _topology_both(raw)
    assert np.isclose(topo["bondlen"][0], 2 * 0.75 * 0.87)


def test_chiral_quadruples_oriented_positive():
    raw = {"name": "CHI",
           "atoms": [_atom("CA", "C", [0, 0, 0], stereo="R"),
                     _atom("N", "N", [1, 0, 0]),
                     _atom("O", "O", [0, 1, 0]),
                     _atom("F", "F", [0, 0, 1]),
                     _atom("H", "H", [-0.6, -0.6, -0.6])],
           "bonds": [_bond("CA", "N"), _bond("CA", "O"), _bond("CA", "F"),
                     _bond("CA", "H")]}
    quads = tl.chiral_quadruples(raw)
    _same(quads, jl.chiral_quadruples(raw))
    assert quads.shape == (1, 4) and quads[0, 0] == 0
    xyz = np.asarray([a["xyz"] for a in raw["atoms"]], float)
    v = xyz[quads[0, 1:]] - xyz[quads[0, 0]]
    assert np.dot(v[0], np.cross(v[1], v[2])) > 0
    for a in raw["atoms"]:
        a["xyz"][2] = -a["xyz"][2]
    quads_m = tl.chiral_quadruples(raw)
    _same(quads_m, jl.chiral_quadruples(raw))
    xyz = np.asarray([a["xyz"] for a in raw["atoms"]], float)
    v = xyz[quads_m[0, 1:]] - xyz[quads_m[0, 0]]
    assert np.dot(v[0], np.cross(v[1], v[2])) > 0


def test_planar_quadruples_guanidinium():
    raw = {"name": "GAI",
           "atoms": [_atom("C", "C", [0, 0, 0], charge=1),
                     _atom("N1", "N", [1.3, 0, 0]),
                     _atom("N2", "N", [-0.65, 1.1, 0]),
                     _atom("N3", "N", [-0.65, -1.1, 0])],
           "bonds": [_bond("C", "N1", 2), _bond("C", "N2"), _bond("C", "N3")]}
    quads = tl.planar_quadruples(raw)
    _same(quads, jl.planar_quadruples(raw))
    assert quads.shape == (1, 4) and quads[0, 0] == 0
    assert set(quads[0, 1:]) == {1, 2, 3}


def _features_both(raw, **kw):
    """(f1d, f2d raw, f2d one-hot, 1D embedding) of the port, each held to
    JAX's."""
    feat, jfeat = tl.MolFeaturizer(**kw), jl.MolFeaturizer(**kw)
    assert (feat.dims1d, feat.dims2d) == (jfeat.dims1d, jfeat.dims2d)
    out = (feat.features_1d(raw), feat.features_2d(raw, one_hot=False),
           feat.features_2d(raw), feat.embed_features_1d(raw))
    _same(out, (jfeat.features_1d(raw), jfeat.features_2d(raw, one_hot=False),
                jfeat.features_2d(raw), jfeat.embed_features_1d(raw)))
    return feat, out


def test_featurizer_1d_2d_benzene_and_px4(tmp_path):
    raw = _parse_both(_write(tmp_path, "PX4.cif", PO4_CIF))
    feat, (f1d, _, _, _) = _features_both(raw)
    assert f1d[0].tolist() == [15, 0, 0, 2]
    assert f1d[1].tolist() == [8, -1, 0, 3]

    _, (_, f2d, oh, _) = _features_both(_benzene())
    assert f2d[0, 1].tolist() == [1, 1, 1, 1]
    assert f2d[0, 3, 3] == 3
    assert f2d[0, 0, 3] == 0
    assert oh.shape == (6, 6, feat.num_features_2d())
    assert oh.sum(-1).min() == 4
    chain = {"name": "ETH", "atoms": [_atom("C1", "C", [0, 0, 0]),
                                      _atom("C2", "C", [1.5, 0, 0])],
             "bonds": [_bond("C1", "C2")]}
    assert _features_both(chain)[1][1][0, 1, 1] == 0


def test_electron_configuration_aufbau():
    for z in range(1, 119):
        _same(tl.electron_configuration(z), np.asarray(jl.electron_configuration(z)))
    c = tl.electron_configuration(6)
    assert c.sum() == 6 and c[:6].tolist() == [1, 1, 1, 1, 1, 1]
    assert tl.electron_configuration(26).sum() == 26


def test_embed_features_1d_dims():
    feat, (_, _, _, emb) = _features_both(_benzene())
    assert emb.shape == (6, feat.num_features_1d())
    assert emb[0, :6].sum() == 6


def test_reduce_hydrogens_methane():
    atoms = [_atom("C", "C", [0, 0, 0])]
    bonds = []
    for i, d in enumerate(np.eye(3).tolist() + [[-1, -1, -1]]):
        atoms.append(_atom(f"H{i+1}", "H", d))
        bonds.append(_bond("C", f"H{i+1}"))
    raw = {"name": "CH4", "atoms": atoms, "bonds": bonds}
    feat, (f1d, _, oh, _) = _features_both(raw)
    assert f1d[0].tolist() == [6, 0, 4, 3]
    red = feat.reduce_hydrogens(raw, f1d=f1d, f2d=oh)
    jfeat = jl.MolFeaturizer()
    _same(red, jfeat.reduce_hydrogens(raw, f1d=f1d, f2d=oh))
    # the shuffled hydrogen order from the same generator state
    _same(feat.reduce_hydrogens(raw, rng=np.random.default_rng(3)),
          jfeat.reduce_hydrogens(raw, rng=np.random.default_rng(3)))
    assert red["xyz"].shape == (1, feat.maxhydr + 1, 3)
    assert np.isfinite(red["xyz"][0, :5]).all()
    assert np.isnan(red["xyz"][0, 5:]).all()
    assert red["ijk"].shape == (5, 3)
    assert red["ijk"][:, 2].tolist() == [0, 1, 2, 3, 4]
    assert red["observed"].all() and red["heavy"].tolist() == [True] + [False] * 4
    assert red["f1d"].shape == (1, 4) and red["f2d"].shape == (1, 1, feat.num_features_2d())


def test_parse_sdf_and_featurize():
    mols = tl.parse_sdf(SDF_ETHANOLAMINE)
    _same(mols, jl.parse_sdf(SDF_ETHANOLAMINE))
    assert len(mols) == 1
    raw = mols[0]
    assert raw["name"] == "ethanolamine"
    assert len(raw["atoms"]) == 4 and len(raw["bonds"]) == 3
    assert raw["atoms"][2]["charge"] == 1
    topo = _topology_both(raw)
    assert topo["bonds"].shape == (3, 2)
    assert np.isclose(topo["bondlen"][0], 1.5)
    _, (f1d, _, _, _) = _features_both(raw)
    assert f1d[:, 0].tolist() == [6, 6, 7, 8]


@pytest.fixture(scope="module")
def libraries():
    """The packaged library of each package, every entry built once."""
    lib, jlib = tl.ResidueLibrary.standard(), jl.ResidueLibrary.standard()
    assert sorted(lib._raw) == sorted(jlib._raw)
    return lib, jlib


def test_standard_residue_library(libraries):
    lib, jlib = libraries
    with open(tl.ResidueLibrary.STANDARD_LIBRARY_PATH, "rb") as f, \
            open(jl.ResidueLibrary.STANDARD_LIBRARY_PATH, "rb") as g:
        assert f.read() == g.read()
    names = list("ACGU") + ["DA", "DC", "DG", "DT"] + [
        "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
        "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL"]
    for n in names:
        assert n in lib, n
        assert lib.get(n) is not None, n
        _same(lib.get(n), jlib.get(n), n)

    assert lib.get("ALA").atoms["C"].leaving_group == ["OXT"]
    assert lib.get("DA").atoms["P"].leaving_group == ["OP3"]
    phe = np.asarray(lib.get("PHE").automorphisms)
    assert phe.shape[0] == 2 and {"CD1", "CD2", "CE1", "CE2"} <= set(phe[0])
    assert np.asarray(lib.get("VAL").automorphisms).shape[0] == 2
    assert lib.get("ASP").automorphisms == []
    assert lib.get("ARG").automorphisms == []
    assert lib.get("ALA").atoms["CA"].stereo == "S"
    assert lib.get("CYS").atoms["CA"].stereo == "R"
    assert lib.get("GLY").chirals == []
    assert lib.get("THR").atoms["CB"].stereo == "R"
    assert "C2'" in lib.get("A").chirals and "C2'" not in lib.get("DA").chirals

    raw = lib._raw["PRO"]
    topo = _topology_both(raw)
    _, (_, f2d, _, _) = _features_both(raw)
    name_to_i = {a["atom_id"]: i for i, a in enumerate(raw["atoms"])}
    assert f2d[name_to_i["N"], name_to_i["CD"], 1] == 1
    assert f2d[name_to_i["C"], name_to_i["O"], 2] == 2
    assert (topo["bondlen"] > 1.0).all()
    trp = lib._raw["TRP"]
    _, (_, f2d_trp, _, _) = _features_both(trp)
    nt = {a["atom_id"]: i for i, a in enumerate(trp["atoms"])}
    assert f2d_trp[nt["CD2"], nt["CE2"], 0] == 1
    _, (f1d, _, _, _) = _features_both(lib._raw["HIS"])
    hyb = {a["atom_id"]: h for a, h in zip(lib._raw["HIS"]["atoms"], f1d[:, 3])}
    assert hyb["CG"] == 2 and hyb["CB"] == 3


def test_packaged_library_covers_modified_residues(libraries):
    lib, jlib = libraries
    modified = ["MSE", "SEC", "SEP", "TPO", "PTR", "CSO", "CSD", "CME",
                "HYP", "MLZ", "MLY", "M3L", "ALY", "KCX", "PCA", "FME",
                "PSU", "5MC", "5CM", "5MU", "1MA", "7MG", "2MG", "M2G",
                "OMC", "OMG", "H2U", "4SU", "BRU", "I", "DI", "DU"]
    for name in modified:
        res = lib.get(name)
        assert res is not None, name
        assert len(res.atoms) >= 7, name
        _same(res, jlib.get(name), name)

    assert lib.get("MSE").atoms["SE"].element.upper() == "SE"
    assert lib.get("MSE").atoms["SE"].parent in ("CG", "CE")
    assert lib.get("SEC").atoms["SE"].element.upper() == "SE"
    assert lib.get("4SU").atoms["S4"].element.upper() == "S"
    assert lib.get("BRU").atoms["BR"].element.upper() == "BR"
    for name, host in [("SEP", "OG"), ("TPO", "OG1"), ("PTR", "OH")]:
        res = lib.get(name)
        assert res.atoms["P"].parent in (host, "O1P", "O2P", "O3P"), name
        assert {"O1P", "O2P", "O3P"} <= set(res.atoms), name
    psu_bonds = {frozenset((b.a, b.b)) for b in lib.get("PSU").bonds}
    assert frozenset(("C1'", "C5")) in psu_bonds
    assert frozenset(("C1'", "N1")) not in psu_bonds
    assert not any(b.aromatic for b in lib.get("H2U").bonds)
    mg = lib.get("7MG")
    assert mg.atoms["CM7"].parent == "N7"
    assert mg.atoms["N7"].charge == 1
    assert "N2" not in lib.get("I").atoms and "O6" in lib.get("I").atoms
    pca_bonds = {frozenset((b.a, b.b)) for b in lib.get("PCA").bonds}
    assert frozenset(("N", "CD")) in pca_bonds

    raw = lib._raw["MSE"]
    topo = _topology_both(raw)
    assert (topo["bondlen"] > 1.0).all()
    _, (f1d, _, _, _) = _features_both(raw)
    assert f1d.shape[0] == len(raw["atoms"])


def test_every_packaged_entry_matches_jax(libraries):
    """Every raw entry of the packaged library: topology, features and
    hydrogen reduction equal JAX's; then the same entries with seeded
    random coordinates (the packaged ones carry none), so that every
    stereocentre's quadruples are oriented by the triple product (float32
    in both packages) and equal JAX's."""
    lib, _ = libraries
    rng = np.random.default_rng(0)
    n_chiral = 0
    for name in sorted(lib._raw):
        raw = lib._raw[name]
        topo = _topology_both(raw)
        feat, (f1d, _, oh, _) = _features_both(raw)
        _same(feat.reduce_hydrogens(raw, f1d=f1d, f2d=oh),
              jl.MolFeaturizer().reduce_hydrogens(raw, f1d=f1d, f2d=oh), name)
        placed = copy.deepcopy(raw)
        for a in placed["atoms"]:
            a["xyz"] = (1.5 * rng.standard_normal(3)).tolist()
        n_chiral += len(_topology_both(placed)["chirals"])
    assert n_chiral > 100


def test_cif_parse_with_modified_residues(tmp_path, libraries):
    lib, jlib = libraries
    struct = _write(tmp_path, "modx.cif", MODIFIED_STRUCTURE_CIF)
    parser = tcif.CIFParser(residue_library=lib)
    chains, asmb, covale, meta = parser.parse(struct)
    jparser = jax_cif.CIFParser(residue_library=jlib)
    jchains, jasmb, jcovale, jmeta = jparser.parse(struct)
    _chains_same(chains, jchains)
    _same((asmb, covale, meta), (jasmb, jcovale, jmeta))

    assert chains["A"].type == "polypeptide(L)"
    assert chains["B"].type == "polyribonucleotide"
    assert chains["C"].type == "nonpoly"
    mse_atoms = {an for (_c, _n, rn, an) in chains["A"].atoms if rn == "MSE"}
    assert "SE" in mse_atoms
    psu_atoms = {an for (_c, _n, rn, an) in chains["B"].atoms if rn == "PSU"}
    assert psu_atoms >= {"C5", "N1"}

    ligands = parser.ligand_residues(chains)
    _same(ligands, jparser.ligand_residues(jchains))
    key = next(k for k in ligands if k[2] == "7MG")
    assert ligands[key].atoms["CM7"].parent == "N7"
