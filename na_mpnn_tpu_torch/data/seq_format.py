"""Sequence token maps and inference output formatting (the port's own copy
of the JAX package's ``data/seq_format.py``): the 33-letter alphabet maps,
the omit/bias vectors and the design FASTA record formats.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .. import constants


def structure_name(path: str) -> str:
    """Output-file stem for a structure input: basename minus .gz and the
    .pdb/.cif extension (shared by the inference CLI and batch design)."""
    import os

    name = os.path.basename(path)
    if name.lower().endswith(".gz"):
        name = name[:-3]
    for ext in (".pdb", ".cif", ".mmcif"):
        if name.lower().endswith(ext):
            name = name[:-len(ext)]
            break
    return name


def token_maps(na_shared_tokens: bool) -> Tuple[Dict, Dict, Dict]:
    """(str->int, int->str, dna_char->rna_char) for the 33-letter alphabet;
    with shared NA tokens, RNA letters map onto the DNA ints and the
    dna->rna table converts O2'-bearing residues back on output."""
    restype_to_int = constants.restype_to_int_table(na_shared_tokens)
    str_to_int = {constants.RESTYPE_3_TO_1[k]: v
                  for k, v in restype_to_int.items()}
    int_to_str: Dict[int, str] = {}
    for k, v in str_to_int.items():
        int_to_str.setdefault(v, k)
    dna_to_rna = dict(constants.DNA_CHAR_TO_RNA_CHAR) if na_shared_tokens \
        else {}
    return str_to_int, int_to_str, dna_to_rna


def omit_vector(omit_AA: str, na_shared_tokens: bool) -> np.ndarray:
    """0/1 float vector over the alphabet; shared-token mode additionally
    omits the bare RNA letters (they are produced via O2' conversion)."""
    omit_list = omit_AA + ("bdhuy" if na_shared_tokens else "")
    return np.array([aa in omit_list for aa in constants.ALPHABET], np.float32)


def parse_bias_spec(spec: str, str_to_int: Dict) -> np.ndarray:
    """'x:val,...' -> per-letter bias vector (reference --bias_AA)."""
    v = np.zeros([constants.NUM_LETTERS], np.float32)
    if spec:
        for item in spec.split(","):
            aa, val = item.split(":")
            v[str_to_int[aa]] = float(val)
    return v


def parse_pair_bias_spec(spec: str, str_to_int: Dict) -> np.ndarray:
    """'xy:val,...' -> [nl,nl] neighbor-pair bias matrix
    (reference --pair_bias_AA)."""
    nl = constants.NUM_LETTERS
    m = np.zeros([nl, nl], np.float32)
    if spec:
        for item in spec.split(","):
            pair, val = item.split(":")
            m[str_to_int[pair[0]], str_to_int[pair[1]]] = float(val)
    return m


def ints_to_seq(S_ints, rna_conversion_mask, int_to_str: Dict,
                dna_to_rna: Dict) -> str:
    """Token ints -> letters, converting shared-DNA tokens to RNA letters
    where the O2' mask marks the residue as RNA."""
    chars = []
    for i, aa in enumerate(np.asarray(S_ints).tolist()):
        ch = int_to_str[int(aa)]
        if rna_conversion_mask[i] == 1:
            ch = dna_to_rna.get(ch, ch)
        chars.append(ch)
    return "".join(chars)


def seq_by_chains(seq: str, mask_c) -> str:
    """'/'-joined per-chain segments (the reference FASTA chain separator)."""
    arr = np.array(list(seq))
    return "/".join("".join(arr[np.asarray(m)]) for m in mask_c)


def _f4(x) -> str:
    return np.format_float_positional(x, unique=False, precision=4)


def native_fasta_entry(name, temperature, seed, num_res, batch_size,
                       number_of_batches, model_path, seq_text) -> str:
    """The first (native-sequence) FASTA record (inference/run.py:445-455)."""
    return (f">{name}, T={temperature}, seed={seed}, num_res={num_res}, "
            f"batch_size={batch_size}, number_of_batches={number_of_batches}, "
            f"model_path={model_path}\n{seq_text}")


def sample_fasta_entry(name, sample_id, temperature, seed, confidence,
                       seq_rec, seq_text) -> str:
    """One designed-sequence FASTA record (inference/run.py:456-516);
    confidence/seq_rec are printed with the reference's 4-digit
    format_float_positional."""
    return (f">{name}, id={sample_id}, T={temperature}, seed={seed}, "
            f"overall_confidence={_f4(confidence)} seq_rec={_f4(seq_rec)}\n"
            f"{seq_text}")
