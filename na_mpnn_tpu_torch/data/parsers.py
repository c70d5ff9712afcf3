"""Training-side structure parsers (re-exported from cif)."""
from .cif import Atom, Chain, CIFParser, PDBParser, make_parsers, read_cif

__all__ = ["Atom", "Chain", "CIFParser", "PDBParser", "make_parsers", "read_cif"]
