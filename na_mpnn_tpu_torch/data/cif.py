"""A minimal mmCIF reader: the first data block's categories as tables
(the port's own copy of the tokenizer and table reader of the JAX package's
``data/cif.py``; its training-side parsers, assemblies and metadata are not
ported). ``data/pdb.py::read_cif_atoms`` reads ``atom_site`` through it.
"""
from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Tuple


def _float_or(token: Optional[str], default: float) -> float:
    try:
        return float(token)
    except (TypeError, ValueError):
        return default


def _tokenize_line(line: str) -> List[str]:
    tokens = []
    i, n = 0, len(line)
    while i < n:
        ch = line[i]
        if ch in " \t":
            i += 1
            continue
        if ch == "#":
            break
        if ch in "'\"":
            j = i + 1
            while j < n:
                if line[j] == ch and (j + 1 >= n or line[j + 1] in " \t"):
                    break
                j += 1
            tokens.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            tokens.append(line[i:j])
            i = j
    return tokens


class CifTable:
    """A single category's rows as a list of dicts-by-index."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.index = {c: i for i, c in enumerate(columns)}
        self.rows: List[List[str]] = []

    def get(self, row: int, column: str, default: Optional[str] = None) -> Optional[str]:
        i = self.index.get(column)
        if i is None:
            return default
        return self.rows[row][i]

    def column(self, column: str) -> Optional[List[str]]:
        i = self.index.get(column)
        if i is None:
            return None
        return [r[i] for r in self.rows]

    def __len__(self):
        return len(self.rows)


def read_cif(path: str) -> Dict[str, CifTable]:
    """Parse the first data block of an mmCIF file into category tables."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.read().split("\n")

    tables: Dict[str, CifTable] = {}
    i, n = 0, len(lines)

    def read_value(i) -> Tuple[str, int]:
        """Read one (possibly multi-line ;-delimited) value starting at lines[i]."""
        if lines[i].startswith(";"):
            parts = [lines[i][1:]]
            i += 1
            while i < n and not lines[i].startswith(";"):
                parts.append(lines[i])
                i += 1
            return "\n".join(parts), i + 1
        toks = _tokenize_line(lines[i])
        return (toks[0] if toks else ""), i + 1

    while i < n:
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        if line.startswith("data_"):
            if tables:
                break  # only the first data block
            i += 1
            continue
        if line.startswith("loop_"):
            i += 1
            columns = []
            while i < n and lines[i].strip().startswith("_"):
                columns.append(lines[i].strip().split()[0])
                i += 1
            if not columns:
                continue
            category = columns[0].split(".")[0][1:]
            names = [c.split(".", 1)[1] if "." in c else c for c in columns]
            table = tables.setdefault(category, CifTable(names))
            ncol = len(names)
            buf: List[str] = []
            while i < n:
                s = lines[i]
                st = s.strip()
                if not st:
                    i += 1
                    continue
                if st.startswith(("loop_", "_", "#", "data_")) and not buf:
                    break
                if s.startswith(";"):
                    val, i = read_value(i)
                    buf.append(val)
                else:
                    buf.extend(_tokenize_line(s))
                    i += 1
                while len(buf) >= ncol:
                    table.rows.append(buf[:ncol])
                    buf = buf[ncol:]
            continue
        if line.startswith("_"):
            key = line.split()[0]
            category = key.split(".")[0][1:]
            name = key.split(".", 1)[1] if "." in key else key
            rest = line[len(key):].strip()
            if rest:
                val = _tokenize_line(rest)[0]
                i += 1
            else:
                val, i = read_value(i + 1)
            table = tables.get(category)
            if table is None or name not in table.index:
                if table is None:
                    table = tables[category] = CifTable([name])
                    table.rows.append([val])
                else:
                    for r in table.rows:
                        r.append(val)
                    table.columns.append(name)
                    table.index[name] = len(table.columns) - 1
            continue
        i += 1
    return tables
