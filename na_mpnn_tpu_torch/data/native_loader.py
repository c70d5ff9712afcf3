"""ctypes bindings of the native structure tokenizer
(``na_mpnn_tpu_torch/native/na_parse.cc``).

The library is built with ``g++`` at first use, never at import, into the
checkout's ``build/na_mpnn_tpu_torch/native/`` (beside the CUDA libraries of
``ops/_build.py``), or into ``~/.cache/na-mpnn-tpu-torch`` where that is not
writable. Its file name carries a hash of the source, the flags, the
compiler's version and the machine's architecture, so an edited source, or
a build directory carried to another host, is rebuilt; the compiler writes
a temporary file that is then ``os.replace``d into place, so processes
building at once never load a half-written library. Where the build or the
load fails, ``native_available`` is false, ``BUILD["error"]`` says why, and
``data/pdb.py::read_pdb_atoms`` takes its pure-Python reader, the
tokenizer's semantic reference (as it does where the native reader raises
on a file).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
import time
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "na_parse.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "na_mpnn_tpu_torch" / "native"
CACHE_DIR = Path("~/.cache/na-mpnn-tpu-torch")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# The outcome of this process's first load: the library's path, the seconds
# its build took (0.0 when it was already built), or the error.
BUILD = {"path": None, "seconds": None, "error": None}

_lock = threading.Lock()
_lib = None
_tried = False


@functools.lru_cache(maxsize=None)
def _compiler_id() -> str:
    """The compiler's version and the machine's architecture, so that a
    library built by another compiler or for another machine is not loaded.
    An absent compiler reads as "none"; ``build`` then reports it."""
    try:
        version = subprocess.run(["g++", "-dumpfullversion"], check=True,
                                 capture_output=True, text=True).stdout.strip()
    except (subprocess.CalledProcessError, OSError):
        version = "none"
    return f"g++ {version} {platform.machine()}"


def library_name() -> str:
    """``libna_parse-<hash>.so``, the hash of the flags, the compiler, the
    machine and the source."""
    h = hashlib.sha256(" ".join((*FLAGS, _compiler_id())).encode())
    h.update(SRC.read_bytes())
    return f"libna_parse-{h.hexdigest()[:12]}.so"


def _target_dir() -> Optional[Path]:
    for d in (BUILD_DIR, CACHE_DIR.expanduser()):
        try:
            d.mkdir(parents=True, exist_ok=True)
        except OSError:
            continue
        if os.access(d, os.W_OK):
            return d
    return None


def build(directory) -> Path:
    """The library in ``directory``, compiled there unless it already is.
    Raises ``RuntimeError`` with the compiler's message."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / library_name()
    if path.exists():
        return path
    tmp = directory / f"{path.name}.tmp.{os.getpid()}"
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC), "-lz"],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    except (subprocess.CalledProcessError, OSError) as e:
        stderr = getattr(e, "stderr", None)
        raise RuntimeError("native tokenizer build failed: "
                           + (stderr.decode(errors="replace") if stderr else str(e))) from e
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


def load(path) -> ctypes.CDLL:
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    lib.na_parse_structure.restype = ctypes.c_void_p
    lib.na_parse_structure.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.na_parse_num_atoms.restype = ctypes.c_int64
    lib.na_parse_num_atoms.argtypes = [ctypes.c_void_p]
    lib.na_parse_error.restype = ctypes.c_char_p
    lib.na_parse_error.argtypes = [ctypes.c_void_p]
    lib.na_parse_free.argtypes = [ctypes.c_void_p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.na_parse_copy.argtypes = [ctypes.c_void_p, f32p, f32p, f32p, i32p,
                                  i32p, u8p, u8p, u8p, u8p, u8p, u8p, u8p,
                                  i32p]
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        t0 = time.perf_counter()
        try:
            directory = _target_dir()
            if directory is None:
                raise RuntimeError(f"no writable directory for the native "
                                   f"tokenizer ({BUILD_DIR}, {CACHE_DIR})")
            fresh = not (directory / library_name()).exists()
            path = build(directory)
            _lib = load(path)
        except (RuntimeError, OSError) as e:
            BUILD["error"] = str(e)
            warnings.warn(f"{e}; the pure-Python structure reader serves")
            return None
        BUILD["path"] = str(path)
        BUILD["seconds"] = time.perf_counter() - t0 if fresh else 0.0
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeAtomTable:
    """Column-oriented atom table parsed by the native library."""

    __slots__ = ["n", "xyz", "occ", "bfac", "resnum", "serial", "name",
                 "resname", "chain", "icode", "element", "altloc", "hetero",
                 "model"]

    def __init__(self, n):
        self.n = n
        self.xyz = np.empty((n, 3), np.float32)
        self.occ = np.empty(n, np.float32)
        self.bfac = np.empty(n, np.float32)
        self.resnum = np.empty(n, np.int32)
        self.serial = np.empty(n, np.int32)
        self.name = np.empty((n, 8), np.uint8)
        self.resname = np.empty((n, 8), np.uint8)
        self.chain = np.empty((n, 4), np.uint8)
        self.icode = np.empty(n, np.uint8)
        self.element = np.empty((n, 4), np.uint8)
        self.altloc = np.empty(n, np.uint8)
        self.hetero = np.empty(n, np.uint8)
        self.model = np.empty(n, np.int32)

    @staticmethod
    def _str(a):
        return a.tobytes().decode("ascii", "replace").rstrip("\x00").strip()

    def name_str(self, i):
        return self._str(self.name[i])

    def resname_str(self, i):
        return self._str(self.resname[i])

    def chain_str(self, i):
        return self._str(self.chain[i])


def parse_structure_native(path: str,
                           first_model_only: bool = True) -> Optional[NativeAtomTable]:
    """Parse a PDB or mmCIF file (gzipped or not) with the native library.
    None if it is unavailable."""
    lib = _load()
    if lib is None:
        return None
    is_cif = int(".cif" in os.path.basename(path))
    h = lib.na_parse_structure(path.encode(), is_cif, int(first_model_only))
    try:
        err = lib.na_parse_error(h)
        if err:
            raise IOError(f"{path}: {err.decode()}")
        n = lib.na_parse_num_atoms(h)
        t = NativeAtomTable(n)
        if n:
            lib.na_parse_copy(h, t.xyz, t.occ, t.bfac, t.resnum, t.serial,
                              t.name.reshape(-1), t.resname.reshape(-1),
                              t.chain.reshape(-1), t.icode, t.element.reshape(-1),
                              t.altloc, t.hetero, t.model)
        return t
    finally:
        lib.na_parse_free(h)


def read_pdb_atoms_native(path: str, first_model_only: bool = True) -> Optional[List]:
    """The records ``data/pdb.py::read_pdb_atoms`` returns (ATOM / HETATM,
    altloc ' ' or 'A', occupancy > 0) from the native columns, with
    ``line`` empty. The filters and string decodes are whole-column numpy
    operations, leaving one object construction per atom kept."""
    from .pdb import PDBAtom

    t = parse_structure_native(path, first_model_only)
    if t is None:
        return None
    if t.n == 0:
        return []

    keep = (t.occ > 0) & ((t.altloc == 0) | (t.altloc == ord(" "))
                          | (t.altloc == ord("A")))
    if first_model_only:
        keep &= t.model == t.model[0]
    idx = np.nonzero(keep)[0]

    def decode(col):
        # fixed-width byte columns -> stripped strings, one bulk operation
        return np.char.strip(
            col[idx].view(f"S{col.shape[1]}")[:, 0].astype(str)).tolist()

    names = decode(t.name)
    resnames = decode(t.resname)
    chains = [c or " " for c in decode(t.chain)]
    elements = [e.upper() for e in decode(t.element)]
    alts = [chr(a) if a else " " for a in t.altloc[idx].tolist()]
    icodes = [chr(c).strip() if c else "" for c in t.icode[idx].tolist()]
    groups = np.where(t.hetero[idx], "HETATM", "ATOM").tolist()
    xyz = t.xyz[idx]
    serials = t.serial[idx].tolist()
    resnums = t.resnum[idx].tolist()
    occs = t.occ[idx].tolist()
    bfacs = t.bfac[idx].tolist()

    out = []
    for i in range(len(idx)):
        element = elements[i]
        if not element:
            for ch in names[i]:
                if ch.isalpha():
                    element = ch.upper()
                    break
        out.append(PDBAtom(groups[i], serials[i], names[i], alts[i],
                           resnames[i], chains[i], resnums[i], icodes[i],
                           xyz[i], occs[i], bfacs[i], element, ""))
    return out
