"""The port's native structure tokenizer (``na_mpnn_tpu_torch/native/
na_parse.cc`` through ``data/native_loader.py``) and ``read_pdb_atoms``
on both of its paths, against the JAX package's pure-Python
``read_pdb_atoms(use_native=False)``, the semantic reference of both
packages' tokenizers; the port's native columns bitwise against the JAX
package's native columns; ``parse_pdb``'s features bitwise equal from the
port's two readers. Structures are written here (``chip_smoke``'s
synthetic complex, and a file of the cases a reader must get right), plain
and gzipped."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import gzip
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import na_mpnn_tpu.data.native_loader as jax_native
import na_mpnn_tpu_torch.data.native_loader as native
from na_mpnn_tpu.data.pdb import read_pdb_atoms as jax_read_pdb_atoms
from na_mpnn_tpu_torch.data.pdb import read_pdb_atoms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



@pytest.fixture
def needs_native():
    """Skip, saying why, where the native tokenizer does not build (decided
    when the test runs, never at import)."""
    if not native.native_available():
        pytest.skip(f"the native tokenizer does not build here: {native.BUILD['error']}")

FIELDS = ("record", "serial", "name", "altloc", "resname", "chain", "resnum",
          "icode", "element")


def _atom_line(rec, serial, name, alt, resname, chain, resnum, icode, xyz,
               occ, bfac, element=None):
    """One fixed-column PDB record; without ``element`` the line ends at
    column 66 (no element columns)."""
    nm = name if len(name) == 4 else " " + name
    line = (f"{rec:<6}{serial:>5} {nm:<4}{alt}{resname:>3} {chain}{resnum:>4}{icode}   "
            f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}{occ:6.2f}{bfac:6.2f}")
    if element is not None:
        line += f"          {element:>2}"
    return line


def _edge_case_model(serial, shift, elements=True):
    """Records of one model: protein residues with altlocs A / B, an atom
    at occupancy 0, insertion codes, a negative residue number, DNA atom
    names with primes, HETATM records (a metal, a water), a 4-character
    name, with or without element columns."""
    rows = []

    def add(rec, name, alt, resname, chain, resnum, icode, xyz, occ=1.0,
            element=None):
        nonlocal serial
        el = element if elements else None
        rows.append(_atom_line(rec, serial, name, alt, resname, chain, resnum,
                               icode, np.asarray(xyz) + shift, occ,
                               10.0 + serial % 7, el))
        serial += 1

    for i, (resname, icode) in enumerate((("GLY", " "), ("ALA", " "), ("SER", "A"),
                                          ("LYS", "B"))):
        c = np.array([3.8 * i, 0.5 * i, -0.3 * i])
        for j, (name, el) in enumerate((("N", "N"), ("CA", "C"), ("C", "C"),
                                        ("O", "O"))):
            xyz = c + [0.9 * j, 1.1 - 0.4 * j, 0.2 * j]
            if resname == "ALA" and name == "CA":
                add("ATOM", name, "A", resname, "A", 2, icode, xyz, 0.6, el)
                add("ATOM", name, "B", resname, "A", 2, icode, xyz + 0.3, 0.4, el)
            elif resname == "SER" and name == "O":
                add("ATOM", name, " ", resname, "A", 2, icode, xyz, 0.0, el)
            else:
                add("ATOM", name, " ", resname, "A", i + 1 if i < 2 else 2, icode,
                    xyz, 1.0, el)
    for i, resname in enumerate(("DA", "DC")):
        c = np.array([2.0, 10.0 + 6.0 * i, 1.0])
        for j, name in enumerate(chip_smoke.DNA_ATOMS):
            add("ATOM", name, " ", resname, "B", -1 + i, " ",
                c + [0.7 * (j % 4), 0.5 * (j // 4), 0.3 * j],
                element=name.strip("'0123456789")[0])
    add("HETATM", "HO5'", " ", "DA", "B", -1, " ", [1.0, 2.0, 3.0], element="H")
    add("HETATM", "MG", " ", "MG", "C", 101, " ", [5.0, 5.0, 5.0], element="MG")
    add("HETATM", "O", " ", "HOH", "D", 201, " ", [7.0, -2.0, 4.0], element="O")
    return rows, serial


def _write_edge_cases(path, models=2, elements=True):
    lines = ["HEADER    READER CASES", "REMARK   1 two models, altlocs, insertion codes"]
    serial = 1
    for m in range(models):
        rows, serial = _edge_case_model(serial, shift=1.5 * m, elements=elements)
        lines += [f"MODEL     {m + 1:>4}"] + rows + ["TER", "ENDMDL"]
    lines.append("END")
    text = "\n".join(lines) + "\n"
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return path


@pytest.fixture(scope="module")
def structures(tmp_path_factory):
    """{case: path}: the synthetic 389-residue complex and the reader
    cases, each plain and gzipped; the cases also without element columns."""
    d = tmp_path_factory.mktemp("structures")
    paths = {"complex": str(d / "complex.pdb")}
    chip_smoke.write_synthetic_pdb(paths["complex"])
    paths["cases"] = _write_edge_cases(str(d / "cases.pdb"))
    paths["cases_no_element"] = _write_edge_cases(str(d / "no_element.pdb"),
                                                  elements=False)
    paths["cases_one_model"] = _write_edge_cases(str(d / "one_model.pdb"), models=1)
    for k in list(paths):
        gz = paths[k] + ".gz"
        with open(paths[k], "rb") as f, gzip.open(gz, "wb") as g:
            shutil.copyfileobj(f, g)
        paths[k + ".gz"] = gz
    return paths


def _records_equal(got, want, native_path):
    """The native path: the fields ``chip_smoke._records_match`` holds, and
    no source lines; the Python path: every field exactly, lines included."""
    assert all(a.xyz.dtype == np.float32 for a in got)
    if native_path:
        assert chip_smoke._records_match(got, want)
        assert all(a.line == "" for a in got)
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(getattr(a, f) for f in FIELDS) == tuple(getattr(b, f) for f in FIELDS)
        np.testing.assert_array_equal(a.xyz, b.xyz)
        assert (a.occupancy, a.bfactor, a.line) == (b.occupancy, b.bfactor, b.line)


CASES = ["complex", "complex.gz", "cases", "cases.gz", "cases_no_element",
         "cases_no_element.gz", "cases_one_model"]


@pytest.mark.parametrize("first_model_only", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_python_reader_matches_jax(structures, case, first_model_only):
    path = structures[case]
    want = jax_read_pdb_atoms(path, first_model_only, use_native=False)
    got = read_pdb_atoms(path, first_model_only, use_native=False)
    _records_equal(got, want, native_path=False)


@pytest.mark.usefixtures("needs_native")
@pytest.mark.parametrize("first_model_only", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_native_reader_matches_jax(structures, case, first_model_only):
    path = structures[case]
    want = jax_read_pdb_atoms(path, first_model_only, use_native=False)
    _records_equal(read_pdb_atoms(path, first_model_only), want, native_path=True)
    _records_equal(native.read_pdb_atoms_native(path, first_model_only), want,
                   native_path=True)


def test_reader_cases_are_present(structures):
    """The reader cases hold what they are meant to: two models, altloc B
    dropped, the occupancy-0 atom dropped, insertion codes, HETATM, no
    element columns (filled from the name)."""
    atoms = jax_read_pdb_atoms(structures["cases"], use_native=False)
    every = jax_read_pdb_atoms(structures["cases"], False, use_native=False)
    assert len(every) == 2 * len(atoms)
    assert {a.altloc for a in atoms} == {" ", "A"}
    assert {a.icode for a in atoms} == {"", "A", "B"}
    assert not any(a.resname == "SER" and a.name == "O" for a in atoms)
    assert {a.record for a in atoms} == {"ATOM", "HETATM"}
    assert min(a.resnum for a in atoms) == -1
    bare = jax_read_pdb_atoms(structures["cases_no_element"], use_native=False)
    assert [a.element for a in bare][:4] == ["N", "C", "C", "O"]
    assert all(len(a.line) <= 66 for a in bare)


@pytest.mark.usefixtures("needs_native")
@pytest.mark.parametrize("first_model_only", [True, False])
@pytest.mark.parametrize("kind", ["pdb", "pdb.gz", "cif", "cif.gz"])
def test_native_columns_bitwise_jax(structures, tmp_path, kind, first_model_only):
    if not jax_native.native_available():
        pytest.skip("the JAX package's native tokenizer does not build here")
    path = structures["cases"] if kind.startswith("pdb") else str(tmp_path / "s.cif")
    if kind.startswith("cif"):
        chip_smoke.write_synthetic_cif(structures["complex"], path)
    if kind.endswith(".gz"):
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            shutil.copyfileobj(f, g)
        path += ".gz"
    got = native.parse_structure_native(path, first_model_only)
    want = jax_native.parse_structure_native(path, first_model_only)
    assert got.n == want.n > 0
    for col in native.NativeAtomTable.__slots__[1:]:
        a, b = getattr(got, col), getattr(want, col)
        assert a.dtype == b.dtype and a.shape == b.shape, col
        assert a.tobytes() == b.tobytes(), col


@pytest.mark.usefixtures("needs_native")
@pytest.mark.parametrize("case", ["complex", "cases.gz"])
def test_parse_pdb_features_bitwise(structures, case):
    """parse_pdb on the native reader gives the model inputs of parse_pdb
    on the Python reader, bit for bit."""
    path = structures[case]
    p_native = chip_smoke._parse_pdb_with(path, native=True)
    p_py = chip_smoke._parse_pdb_with(path, native=False)
    assert chip_smoke._parsed_equal(p_native, p_py)
    assert all(a.line == "" for r in p_native["backbone_atoms"] for a in r)
    assert all(a.line for r in p_py["backbone_atoms"] for a in r)


@pytest.mark.usefixtures("needs_native")
def test_native_failure_falls_back_to_python(structures, tmp_path):
    """Where the native reader raises on a file (here a non-ASCII byte in a
    kept record's element column), read_pdb_atoms reads it as the Python
    reader does, as the JAX package's read_pdb_atoms does."""
    lines = open(structures["cases"]).read().split("\n")
    i = next(k for k, line in enumerate(lines) if line.startswith("ATOM"))
    lines[i] = lines[i].ljust(78)[:76] + " \u00c9"
    path = str(tmp_path / "non_ascii.pdb")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    with pytest.raises(UnicodeDecodeError):
        native.read_pdb_atoms_native(path)
    got = read_pdb_atoms(path)
    assert got[0].element == "\u00c9"
    want = jax_read_pdb_atoms(path, use_native=False)
    _records_equal(got, want, native_path=False)
    _records_equal(got, jax_read_pdb_atoms(path), native_path=False)


@pytest.mark.parametrize("use_native", [True, False])
def test_missing_file_raises_file_not_found(tmp_path, use_native):
    """A missing file raises FileNotFoundError on either path, as it does
    through the JAX package's read_pdb_atoms."""
    path = str(tmp_path / "absent.pdb")
    with pytest.raises(FileNotFoundError):
        jax_read_pdb_atoms(path, use_native=use_native)
    with pytest.raises(FileNotFoundError):
        read_pdb_atoms(path, use_native=use_native)


@pytest.mark.usefixtures("needs_native")
def test_native_parser_speed(structures):
    """The native reader is not slower than the Python one (JAX's bar,
    1.5x), each read's best of 15 taken in turns, so that neither the other
    workers of a parallel run nor a garbage-collector pass lands on one
    side only. It passed 20 runs of 20 made one after another beside a
    whole tier-1 run at ``-n 6`` on an 8-core host."""
    path = structures["complex"]
    best = {True: float("inf"), False: float("inf")}
    for _ in range(15):
        for use_native in (True, False):
            t0 = time.perf_counter()
            atoms = read_pdb_atoms(path, use_native=use_native)
            best[use_native] = min(best[use_native], time.perf_counter() - t0)
            assert len(atoms) == 2179 and bool(atoms[0].line) != use_native
    print(f"native {best[True] * 1e3:.1f} ms vs python {best[False] * 1e3:.1f} ms")
    assert best[True] < best[False] * 1.5


@pytest.mark.usefixtures("needs_native")
def test_cold_build_in_a_fresh_directory(structures, tmp_path, monkeypatch):
    """A build into an empty directory: one library named by the hash of
    the source, the flags, the compiler and the machine, no temporary file
    left, and it reads what this process's library reads."""
    want = native.read_pdb_atoms_native(structures["cases.gz"])
    path = native.build(tmp_path)
    assert path.parent == tmp_path and path.name == native.library_name()
    assert sorted(os.listdir(tmp_path)) == [path.name]
    assert native.build(tmp_path) == path          # built once
    monkeypatch.setattr(native, "_lib", native.load(path))
    monkeypatch.setattr(native, "_tried", True)
    got = native.read_pdb_atoms_native(structures["cases.gz"])
    _records_equal(got, want, native_path=True)


def test_library_name_keys_on_compiler_and_machine(monkeypatch):
    """A library built by another compiler or for another machine has
    another name, so a carried build directory is not loaded."""
    name = native.library_name()
    monkeypatch.setattr(native, "_compiler_id", lambda: "g++ 0.0 other-machine")
    assert native.library_name() != name


def test_failed_build_reports_and_python_serves(structures, tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message; a
    process whose build failed records the error, and read_pdb_atoms takes
    the Python reader."""
    bad = tmp_path / "na_parse.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="native tokenizer build failed"):
        native.build(tmp_path / "out")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", {"path": None, "seconds": None, "error": None})
    with pytest.warns(UserWarning, match="pure-Python"):
        assert not native.native_available()
    assert "native tokenizer build failed" in native.BUILD["error"]
    atoms = read_pdb_atoms(structures["cases"])
    assert atoms and all(a.line for a in atoms)
    _records_equal(atoms, jax_read_pdb_atoms(structures["cases"], use_native=False),
                   native_path=False)


def test_import_builds_nothing():
    """Importing the loader (and the port's readers) compiles nothing."""
    code = ("import na_mpnn_tpu_torch.data.pdb, na_mpnn_tpu_torch.data.native_loader as n; "
            "assert not n._tried and n.BUILD['path'] is None")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_never_loads_the_jax_library():
    """The port builds its own copy of the source into the checkout's build
    directory (or the port's cache), never into or from the JAX package's
    directory, which holds a library of its own."""
    assert native.SRC.parent == Path(ROOT) / "na_mpnn_tpu_torch" / "native"
    assert native.BUILD_DIR == Path(ROOT) / "build" / "na_mpnn_tpu_torch" / "native"
    if native.native_available():
        lib_dir = Path(native.BUILD["path"]).parent
        assert lib_dir in (native.BUILD_DIR, native.CACHE_DIR.expanduser())
        assert lib_dir != Path(jax_native.__file__).resolve().parents[1] / "native"
