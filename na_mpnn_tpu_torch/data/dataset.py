"""Training dataset: structure loading, assembly expansion, PPM alignment,
augmentations, and token-bucketed batching (the port's own copy of the JAX
package's ``data/dataset.py``).

Host-side numpy, as in the JAX package: the device never sees any of this;
structures are collated by ``train.collate`` into dense batches. The tables
of examples are read without pandas: ``read_examples_csv`` gives a list of
row dicts (rows in file order), and ``make_batch_iter`` takes that list and
draws from its ``RandomState`` in the JAX function's order, so both packages
pick the same clusters from the same seed. PPM files are read with ``csv``.
"""
from __future__ import annotations

import ast
import csv
import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import constants


@dataclasses.dataclass
class DatasetConfig:
    """Union of the reference training-config dataset params
    (design_model.json / specificity_model.json)."""
    atom_list_to_save: Sequence[str] = tuple(constants.BACKBONE_ATOMS)
    parse_protein: bool = True
    parse_dna: bool = True
    parse_rna: bool = True
    parse_rna_as_dna: bool = False
    na_shared_tokens: bool = True
    protein_backbone_occ_cutoff: float = 0.8
    protein_side_chain_occ_cutoff: float = 0.5
    dna_backbone_occ_cutoff: float = 0.8
    dna_side_chain_occ_cutoff: float = 0.5
    rna_backbone_occ_cutoff: float = 0.8
    rna_side_chain_occ_cutoff: float = 0.5
    crop_large_structures: bool = False
    batch_tokens: int = 6000
    na_ref_atom: str = "C1'"
    parse_ppms: bool = False
    min_overlap_length: int = 5
    drop_protein_probability: float = 0.0
    na_only_as_uniform_ppm: bool = False
    protein_interface_residue_mutation_probability: float = 0.0
    mutate_base_pair_together: bool = False
    mutate_entire_side_chain_interface_probability: float = 0.0
    na_non_interface_as_uniform_ppm: bool = False


# ---------------------------------------------------------------------------
# PPM machinery
# ---------------------------------------------------------------------------

def ppm_information_content(ppm: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Per-position information content in log-base-1/4 units
    (reference na_data_utils.py:413-437)."""
    p = ppm + eps
    p = p / p.sum(-1, keepdims=True)
    return np.sum(np.log(p) / np.log(0.25), axis=-1)


def ppm_pearson(ppm: np.ndarray, S_one_hot: np.ndarray) -> np.ndarray:
    """Per-position Pearson r between ppm rows and one-hot sequence rows;
    0 where the ppm row is uniform (reference na_data_utils.py:439-476)."""
    pb = ppm.mean(-1, keepdims=True)
    sb = S_one_hot.mean(-1, keepdims=True)
    num = np.sum((ppm - pb) * (S_one_hot - sb), axis=-1)
    den = np.sqrt(np.sum((ppm - pb) ** 2, -1) * np.sum((S_one_hot - sb) ** 2, -1))
    out = np.zeros_like(num)
    nz = den != 0
    out[nz] = num[nz] / den[nz]
    return out


def ppm_alignment_score(ppm: np.ndarray, S_one_hot: np.ndarray) -> float:
    """Sum of IC-weighted Pearson r (reference na_data_utils.py:478-507)."""
    return float(np.sum(ppm_pearson(ppm, S_one_hot) * 0.5 * ppm_information_content(ppm)))


def load_ppms(ppm_paths_str: str, randomize_experimental_ppms: bool, rng=np.random):
    """Load PPM csv files; each gets its reverse-complement twin appended
    (reference load_ppms, na_data_utils.py:345-411)."""
    ppm_paths = ast.literal_eval(ppm_paths_str)
    ppms, chosen = [], []
    for alternatives in ppm_paths:
        path = rng.choice(alternatives) if randomize_experimental_ppms else alternatives[0]
        chosen.append(path)
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            rows = list(reader)
            columns = reader.fieldnames or []
        if "T" in columns:
            cols, ppm_type = ["A", "C", "G", "T"], "dna"
        elif "U" in columns:
            cols, ppm_type = ["A", "C", "G", "U"], "rna"
        else:
            raise ValueError(f"PPM at {path} is not valid.")
        ppm = np.array([[float(r[c]) for c in cols] for r in rows],
                       np.float64).reshape(len(rows), 4)
        bp_ppm = np.copy(np.flip(np.flip(ppm, axis=1), axis=0))
        ppms.append((ppm, ppm_type))
        ppms.append((bp_ppm, ppm_type))
    return ppms, chosen


class NADataset:
    """Loads (structure, assembly) examples into the model feature contract.

    Mirrors reference PDBDataset (na_data_utils.py:70-1403); parsing is
    delegated to pluggable parser objects with the reference Chain contract
    (pdbutils.Chain namedtuples / cifutils chains).
    """

    def __init__(self, cif_parser=None, pdb_parser=None,
                 config: Optional[DatasetConfig] = None, rng=None):
        self.cfg = config or DatasetConfig()
        self.cif_parser = cif_parser
        self.pdb_parser = pdb_parser
        # Stored as _rng so the dataset pickles into loader worker processes
        # (the np.random module object is not picklable).
        self._rng = rng

        c = self.cfg
        self.atom_dict = {a: i for i, a in enumerate(c.atom_list_to_save)}
        self.num_atoms = len(c.atom_list_to_save)

        self.polytype_to_int = dict(constants.POLYTYPE_TO_INT)
        if c.parse_rna_as_dna:
            self.polytype_to_int["RNA"] = self.polytype_to_int["DNA"]

        self.restype_to_int = constants.restype_to_int_table(
            c.parse_rna_as_dna or c.na_shared_tokens)
        prot, dna, rna, unk = constants.restype_group_ints(
            c.parse_rna_as_dna or c.na_shared_tokens)
        self.protein_restype_ints = prot
        self.dna_restype_ints = dna
        self.rna_restype_ints = rna
        self.unknown_restype_ints = unk
        self.na_canonical_base_pair_ints = constants.canonical_base_pair_ints(
            c.parse_rna_as_dna or c.na_shared_tokens)

        self.protein_bb_idx = [self.atom_dict[a] for a in constants.PROTEIN_BACKBONE_ATOMS
                               if a in self.atom_dict]
        self.dna_bb_idx = [self.atom_dict[a] for a in constants.DNA_BACKBONE_ATOMS
                           if a in self.atom_dict]
        self.rna_bb_idx = [self.atom_dict[a] for a in constants.RNA_BACKBONE_ATOMS
                           if a in self.atom_dict]

    @property
    def rng(self):
        return self._rng if self._rng is not None else np.random

    # -- parsing ---------------------------------------------------------

    def enable_parse_cache(self, max_entries: int = 256):
        """LRU-cache parse_structure outputs (keyed by path + mtime).

        Parsing is deterministic and read-only; every per-visit random
        choice (assembly selection, noise, crops, mutations) happens in
        loader()/load_assembly AFTER parsing, so caching preserves training
        semantics exactly while epochs that revisit the same files skip the
        parser. Called per worker process by data.loader.PrefetchLoader."""
        self._parse_cache_max = max(int(max_entries), 0)
        if not hasattr(self, "_parse_cache"):
            self._parse_cache = {}

    def parse_structure(self, structure_path: str):
        cache_max = getattr(self, "_parse_cache_max", 0)
        if cache_max:
            key = (structure_path, os.path.getmtime(structure_path))
            hit = self._parse_cache.get(key)
            if hit is not None:
                return hit
        if structure_path.endswith((".pdb", ".pdb.gz")):
            out = self.pdb_parser.parse(structure_path)
        elif structure_path.endswith((".cif", ".cif.gz")):
            out = self.cif_parser.parse(structure_path)
        else:
            raise ValueError(
                f"{structure_path}: Unknown structure path extension.")
        if cache_max:
            if len(self._parse_cache) >= cache_max:
                # FIFO eviction — epochs sweep the corpus, LRU == FIFO here.
                self._parse_cache.pop(next(iter(self._parse_cache)))
            self._parse_cache[key] = out
        return out

    def load_chains(self, chains) -> Dict[str, Dict]:
        """Chain namedtuples -> per-chain dense atom tables
        (reference na_data_utils.py:718-762)."""
        polymer_types = {
            "polypeptide(L)", "polydeoxyribonucleotide", "polyribonucleotide",
            "polydeoxyribonucleotide/polyribonucleotide hybrid",
        }
        out = {}
        for letter, chain in chains.items():
            if chain.type not in polymer_types:
                continue
            residue_ids: List[str] = []
            seen = set()
            for key in chain.atoms.keys():
                rid = key[1]
                if rid not in seen:
                    seen.add(rid)
                    residue_ids.append(rid)
            L = len(residue_ids)
            rid_to_c = {r: c for c, r in enumerate(residue_ids)}
            xyz = np.zeros([L, self.num_atoms, 3], np.float32)
            occ = np.zeros([L, self.num_atoms], np.float32)
            residue_idx = -100 * np.ones([L], np.int32)
            raw_sequence = L * ["UNK"]
            for key, atom in chain.atoms.items():
                _, res_idx_str, res_name, atom_name = key
                c = rid_to_c[res_idx_str]
                ai = self.atom_dict.get(atom_name)
                if ai is not None:
                    xyz[c, ai] = np.asarray(atom.xyz)
                    occ[c, ai] = atom.occ
                raw_sequence[c] = res_name
                residue_idx[c] = int(res_idx_str)
            out[letter] = {"type": chain.type, "xyz": xyz, "occ": occ,
                           "seq": raw_sequence, "residue_idx": residue_idx}
        return out

    # -- PPM alignment ----------------------------------------------------

    def weighted_align(self, ppm, S_one_hot_na, S_non_x_mask):
        """Exhaustive gapless alignment maximizing the IC-weighted Pearson
        score (reference na_data_utils.py:509-577); returns every tied-best
        (ppm_start, S_start, overlap_len)."""
        min_olap = self.cfg.min_overlap_length
        max_score = -np.inf
        opt = ([0], [0], [0])
        ppm_len, S_len = ppm.shape[0], S_one_hot_na.shape[0]
        for ppm_start in range(ppm_len):
            for overlap_len in range(ppm_len - ppm_start + 1):
                for S_start in range(S_len - overlap_len + 1):
                    sm = S_non_x_mask[S_start:S_start + overlap_len]
                    if overlap_len < min_olap or np.count_nonzero(sm) < min_olap:
                        continue
                    pc = ppm[ppm_start:ppm_start + overlap_len][sm]
                    sc = S_one_hot_na[S_start:S_start + overlap_len][sm]
                    score = ppm_alignment_score(pc, sc)
                    if score > max_score:
                        max_score = score
                        opt = ([ppm_start], [S_start], [overlap_len])
                    elif score == max_score:
                        opt[0].append(ppm_start)
                        opt[1].append(S_start)
                        opt[2].append(overlap_len)
        return max_score, opt[0], opt[1], opt[2]

    def align_ppms(self, ppms, S, chain_labels, protein_mask, dna_mask, rna_mask):
        """Align every PPM against every compatible NA chain and write the
        winning columns into an aligned [L, 33] PPM
        (reference na_data_utils.py:579-716)."""
        L = S.shape[0]
        nl = len(constants.RESTYPES)
        aligned_ppm = np.zeros((L, nl), np.float64)
        ppm_mask = np.zeros_like(S, np.int32)
        S_one_hot = np.zeros((L, nl), np.float64)
        S_one_hot[np.arange(L), S] = 1

        t = self.restype_to_int
        for ppm, ppm_type in ppms:
            na_cols = ([t["DA"], t["DC"], t["DG"], t["DT"]] if ppm_type == "dna"
                       else [t["A"], t["C"], t["G"], t["U"]])
            S_oh_na = S_one_hot[:, na_cols]
            S_non_x = S_oh_na.sum(-1) > 0

            max_score, opt_p, opt_s, opt_o = -np.inf, [], [], []
            for cl in np.unique(chain_labels):
                idx = np.where(chain_labels == cl)[0]
                start = idx[0]
                if protein_mask[start] == 1:
                    continue
                if dna_mask[start] == 1 and ppm_type == "rna":
                    continue
                if rna_mask[start] == 1 and ppm_type == "dna":
                    continue
                sc, ps, ss, os_ = self.weighted_align(ppm, S_oh_na[idx], S_non_x[idx])
                ss = [s + start for s in ss]
                if sc > max_score:
                    max_score, opt_p, opt_s, opt_o = sc, list(ps), list(ss), list(os_)
                elif sc == max_score:
                    opt_p.extend(ps)
                    opt_s.extend(ss)
                    opt_o.extend(os_)

            if max_score > -np.inf:
                for p0, s0, olap in zip(opt_p, opt_s, opt_o):
                    for j in range(olap):
                        pi, si = p0 + j, s0 + j
                        if ppm_mask[si] == 0:
                            aligned_ppm[si, na_cols] = ppm[pi]
                            ppm_mask[si] = 1
                        else:
                            # Column conflict: keep the higher-scoring column
                            # (vs the sequence) or, at DX positions, the higher
                            # information content (na_data_utils.py:704-714).
                            if S_non_x[si]:
                                new = ppm_alignment_score(ppm[pi][None], S_oh_na[si][None])
                                old = ppm_alignment_score(
                                    aligned_ppm[si, na_cols][None], S_oh_na[si][None])
                                if new > old:
                                    aligned_ppm[si, na_cols] = ppm[pi]
                            else:
                                new = ppm_information_content(ppm[pi][None])
                                old = ppm_information_content(aligned_ppm[si, na_cols][None])
                                if new > old:
                                    aligned_ppm[si, na_cols] = ppm[pi]
        return aligned_ppm, ppm_mask

    # -- assembly ----------------------------------------------------------

    def load_assembly(self, chain_dict, asmb, assembly_id, ppms) -> Dict:
        """Apply assembly transforms, build masks/tokens, apply occupancy
        cutoffs (reference na_data_utils.py:764-904)."""
        c = self.cfg
        parts = {k: [] for k in ["X", "occ", "R_idx", "chain_labels",
                                 "protein_mask", "dna_mask", "rna_mask", "S"]}
        chain_counter = 0
        for letter, transform in asmb[assembly_id]:
            if letter not in chain_dict:
                continue
            ch = chain_dict[letter]
            R = np.asarray(transform)[:3, :3]
            tvec = np.asarray(transform)[:3, 3]
            xyz = np.einsum("ij,raj->rai", R, ch["xyz"]) + tvec[None, None, :]
            n = ch["residue_idx"].shape[0]
            parts["X"].append(xyz)
            parts["occ"].append(ch["occ"])
            parts["R_idx"].append(ch["residue_idx"])
            parts["chain_labels"].append(np.full(n, chain_counter, np.int32))
            chain_counter += 1

            pm = np.zeros(n, np.int32)
            dm = np.zeros(n, np.int32)
            rm = np.zeros(n, np.int32)
            if ch["type"] == "polypeptide(L)":
                unk, pm = "UNK", np.ones(n, np.int32)
            elif ch["type"] == "polydeoxyribonucleotide":
                unk, dm = "DX", np.ones(n, np.int32)
            elif ch["type"] == "polyribonucleotide":
                unk, rm = "RX", np.ones(n, np.int32)
            else:  # hybrid: residue-wise masks; unknowns excluded from both
                unk = "DX"
                for i, aa in enumerate(ch["seq"]):
                    if aa in constants.DNA_RESTYPES:
                        dm[i] = 1
                    elif aa in constants.RNA_RESTYPES:
                        rm[i] = 1
            parts["protein_mask"].append(pm)
            parts["dna_mask"].append(dm)
            parts["rna_mask"].append(rm)
            parts["S"].append(np.array(
                [self.restype_to_int.get(aa, self.restype_to_int[unk])
                 for aa in ch["seq"]], np.int32))

        X = np.concatenate(parts["X"], 0)
        X_occ = np.concatenate(parts["occ"], 0)
        R_idx = np.concatenate(parts["R_idx"], 0)
        chain_labels = np.concatenate(parts["chain_labels"], 0)
        protein_mask = np.concatenate(parts["protein_mask"], 0)
        dna_mask = np.concatenate(parts["dna_mask"], 0)
        rna_mask = np.concatenate(parts["rna_mask"], 0)
        S = np.concatenate(parts["S"], 0)

        aligned_ppm, ppm_mask = self.align_ppms(
            ppms, S, chain_labels, protein_mask, dna_mask, rna_mask)

        pt = self.polytype_to_int
        R_polymer_type = (protein_mask * pt["PP"] + dna_mask * pt["DNA"]
                          + rna_mask * pt["RNA"]
                          + (1 - protein_mask - dna_mask - rna_mask) * pt["UNK"])

        sc_cut = (protein_mask * c.protein_side_chain_occ_cutoff
                  + dna_mask * c.dna_side_chain_occ_cutoff
                  + rna_mask * c.rna_side_chain_occ_cutoff)
        X_m = (X_occ > sc_cut[:, None]).astype(np.int32)

        bb_cut = (protein_mask * c.protein_backbone_occ_cutoff
                  + dna_mask * c.dna_backbone_occ_cutoff
                  + rna_mask * c.rna_backbone_occ_cutoff)
        bb_ok = (X_occ > bb_cut[:, None]).astype(np.int32)
        protein_mask = protein_mask * np.prod(bb_ok[:, self.protein_bb_idx], -1)
        dna_mask = dna_mask * np.prod(bb_ok[:, self.dna_bb_idx], -1)
        rna_mask = rna_mask * np.prod(bb_ok[:, self.rna_bb_idx], -1)

        if c.parse_rna_as_dna:
            dna_mask = np.bitwise_or(dna_mask, rna_mask)
            rna_mask = np.zeros_like(dna_mask)

        keep = np.zeros_like(protein_mask)
        out: Dict = {}
        for flag, m, key in [(c.parse_protein, protein_mask, "protein_L"),
                             (c.parse_dna, dna_mask, "dna_L"),
                             (c.parse_rna, rna_mask, "rna_L")]:
            if flag:
                keep = np.bitwise_or(keep, m)
                out[key] = int(np.count_nonzero(m))
            else:
                out[key] = 0
        out["macromolecule_L"] = int(np.count_nonzero(keep))
        keep = keep.astype(bool)

        out.update({
            "protein_mask": protein_mask[keep], "dna_mask": dna_mask[keep],
            "rna_mask": rna_mask[keep], "X": X[keep], "X_m": X_m[keep],
            "S": S[keep], "R_idx": R_idx[keep],
            "chain_labels": chain_labels[keep],
            "R_polymer_type": R_polymer_type[keep],
            "aligned_ppm": aligned_ppm[keep], "ppm_mask": ppm_mask[keep],
        })
        return out

    def load_preprocessed_data(self, out, example, assembly_id):
        """Attach precomputed per-assembly .npy side files
        (reference na_data_utils.py:906-957)."""
        for out_key, col, dt in [
            ("interface_mask", "asmb_interface_masks_path", np.int32),
            ("side_chain_interface_mask", "asmb_side_chain_interface_masks_path", np.int32),
            ("nearest_protein_side_chain_index", "asmb_nearest_protein_side_chain_index_path", np.int64),
            ("base_pair_mask", "asmb_base_pair_masks_path", np.int32),
            ("base_pair_index", "asmb_base_pair_index_path", np.int64),
            ("canonical_base_pair_mask", "asmb_canonical_base_pair_masks_path", np.int32),
            ("canonical_base_pair_index", "asmb_canonical_base_pair_index_path", np.int64),
        ]:
            out[out_key] = np.load(example[col], allow_pickle=True).item()[assembly_id].astype(dt)

    # -- augmentations -------------------------------------------------------

    def apply_crop_mask(self, out, mask_to_keep):
        """Crop arrays + remap index features (reference na_data_utils.py:959-1012)."""
        for k in list(out.keys()):
            if isinstance(out[k], np.ndarray):
                out[k] = out[k][mask_to_keep]
        removed = np.logical_not(mask_to_keep)
        removed_idx = np.where(removed)[0]
        shift = np.concatenate([[0], np.cumsum(removed.astype(np.int64))[:-1]])
        for idx_key, mask_key in [
            ("base_pair_index", "base_pair_mask"),
            ("canonical_base_pair_index", "canonical_base_pair_mask"),
            ("nearest_protein_side_chain_index", "side_chain_interface_mask"),
        ]:
            gone = np.isin(out[idx_key], removed_idx)
            out[mask_key][gone] = 0
            out[idx_key] = out[idx_key] - shift[out[idx_key]]
            out[idx_key] = out[idx_key] * out[mask_key]
        out["protein_L"] = int(np.count_nonzero(out["protein_mask"]))
        out["dna_L"] = int(np.count_nonzero(out["dna_mask"]))
        out["rna_L"] = int(np.count_nonzero(out["rna_mask"]))
        out["macromolecule_L"] = out["protein_L"] + out["dna_L"] + out["rna_L"]

    def drop_protein(self, out):
        """Drop all protein residues w.p. drop_protein_probability
        (reference na_data_utils.py:1014-1035)."""
        if self.rng.uniform() < self.cfg.drop_protein_probability:
            self.apply_crop_mask(out, np.logical_not(out["protein_mask"] == 1))
            out["interface_mask"] = np.zeros_like(out["interface_mask"])
            out["side_chain_interface_mask"] = np.zeros_like(out["side_chain_interface_mask"])

    def random_crop_na(self, out):
        """Spatial crop to batch_tokens around a random NA residue
        (reference na_data_utils.py:1037-1071)."""
        CA = self.atom_dict["CA"]
        ref = self.atom_dict[self.cfg.na_ref_atom]
        ref_X = out["X"][:, CA, :] + out["X"][:, ref, :]
        na_mask = out["dna_mask"] + out["rna_mask"]
        center = self.rng.choice(np.where(na_mask == 1)[0])
        d = np.sqrt(np.sum((ref_X - ref_X[center]) ** 2, -1))
        keep_idx = np.argsort(d)[: self.cfg.batch_tokens]
        keep = np.zeros_like(out["S"], bool)
        keep[keep_idx] = True
        self.apply_crop_mask(out, keep)

    def uniformize_ppm_at(self, out, mask_to_uniformize):
        """Uniform (0.25 over the 4 NA letters) PPM at masked NA positions
        (reference na_data_utils.py:1073-1124)."""
        na = np.logical_or(out["dna_mask"] == 1, out["rna_mask"] == 1)
        assert np.all(na[mask_to_uniformize])
        ap = out["aligned_ppm"].copy()
        pm = out["ppm_mask"].copy()
        ap[mask_to_uniformize] = 0
        t = self.restype_to_int
        for m, cols in [(np.logical_and(mask_to_uniformize, out["dna_mask"] == 1),
                         [t["DA"], t["DC"], t["DG"], t["DT"]]),
                        (np.logical_and(mask_to_uniformize, out["rna_mask"] == 1),
                         [t["A"], t["C"], t["G"], t["U"]])]:
            for col in cols:
                ap[m, col] = 0.25
        pm[mask_to_uniformize] = 1
        out["aligned_ppm"], out["ppm_mask"] = ap, pm

    def uniformize_ppm_all_na(self, out):
        na = np.logical_or(out["dna_mask"] == 1, out["rna_mask"] == 1)
        self.uniformize_ppm_at(out, na)

    def uniformize_ppm_non_interface(self, out):
        na = np.logical_or(out["dna_mask"] == 1, out["rna_mask"] == 1)
        m = np.logical_and.reduce((na, out["ppm_mask"] != 1,
                                   out["side_chain_interface_mask"] != 1))
        self.uniformize_ppm_at(out, m)

    def mutate_interface_at(self, out, mask_to_mutate):
        """Mutate selected interface protein residues; uniformize contacting
        NA PPMs (reference na_data_utils.py:1174-1249)."""
        prot_sc = np.logical_and(out["protein_mask"] == 1,
                                 out["side_chain_interface_mask"] == 1)
        assert np.all(prot_sc[mask_to_mutate])
        na = np.logical_or(out["dna_mask"] == 1, out["rna_mask"] == 1)
        na_sc = np.logical_and(na, out["side_chain_interface_mask"] == 1)
        t = self.restype_to_int
        for pi in np.where(mask_to_mutate)[0]:
            contacting = list(np.where(
                np.logical_and(na_sc, out["nearest_protein_side_chain_index"] == pi))[0])
            if self.cfg.mutate_base_pair_together:
                extra = [out["base_pair_index"][j] for j in contacting
                         if out["base_pair_mask"][j] == 1]
                contacting = list(set(contacting + extra))
            if not contacting:
                continue
            choices = [r for r in self.protein_restype_ints
                       if r != out["S"][pi] and r != t["UNK"]]
            out["S"][pi] = self.rng.choice(choices)
            for j in contacting:
                if out["dna_mask"][j] == 1:
                    out["aligned_ppm"][j, [t["DA"], t["DC"], t["DG"], t["DT"]]] = 0.25
                elif out["rna_mask"][j] == 1:
                    out["aligned_ppm"][j, [t["A"], t["C"], t["G"], t["U"]]] = 0.25
                out["ppm_mask"][j] = 1

    def mutate_entire_side_chain_interface(self, out):
        if self.rng.uniform() < self.cfg.mutate_entire_side_chain_interface_probability:
            m = np.logical_and(out["protein_mask"] == 1,
                               out["side_chain_interface_mask"] == 1)
            self.mutate_interface_at(out, m)
            self.uniformize_ppm_all_na(out)

    def mutate_random_side_chain_interface(self, out):
        m = np.logical_and(out["protein_mask"] == 1,
                           out["side_chain_interface_mask"] == 1)
        bern = self.rng.uniform(size=out["macromolecule_L"]) < \
            self.cfg.protein_interface_residue_mutation_probability
        self.mutate_interface_at(out, np.logical_and(bern, m))

    # -- loader ------------------------------------------------------------

    def loader(self, example: Dict, assembly_id: str):
        """Load one (structure, assembly) example; defensive skip on failure
        returns None (reference na_data_utils.py:1319-1378 returns
        ("pass","pass"))."""
        c = self.cfg
        try:
            chains, asmb, covale, meta = self.parse_structure(example["structure_path"])
        except Exception:
            print("bad_structure: ", example["structure_path"])
            return None
        try:
            if c.parse_ppms:
                ppms, chosen = load_ppms(example["ppm_paths"], True, self.rng)
            else:
                ppms, chosen = [], []
        except Exception:
            print("bad_ppms: ", example["structure_path"], example.get("ppm_paths"))
            return None
        if assembly_id not in asmb:
            print("bad_assembly_id: ", example["structure_path"], assembly_id)
            return None

        chain_dict = self.load_chains(chains)
        out = self.load_assembly(chain_dict, asmb, assembly_id, ppms)
        if "asmb_interface_masks_path" in example:
            self.load_preprocessed_data(out, example, assembly_id)
        else:
            L = out["S"].shape[0]
            for k in ["interface_mask", "side_chain_interface_mask",
                      "base_pair_mask", "canonical_base_pair_mask"]:
                out[k] = np.zeros(L, np.int32)
            for k in ["nearest_protein_side_chain_index", "base_pair_index",
                      "canonical_base_pair_index"]:
                out[k] = np.zeros(L, np.int64)

        if c.drop_protein_probability > 0 and out["macromolecule_L"] > out["protein_L"]:
            self.drop_protein(out)
        if c.na_only_as_uniform_ppm and out["protein_L"] == 0:
            self.uniformize_ppm_all_na(out)
        if c.na_non_interface_as_uniform_ppm:
            self.uniformize_ppm_non_interface(out)
        if c.protein_interface_residue_mutation_probability > 0 and out["protein_L"] > 0:
            self.mutate_random_side_chain_interface(out)
        if c.mutate_entire_side_chain_interface_probability > 0 and out["protein_L"] > 0:
            self.mutate_entire_side_chain_interface(out)
        if c.crop_large_structures and out["macromolecule_L"] > c.batch_tokens:
            self.random_crop_na(out)

        out["structure_path"] = example["structure_path"]
        out["assembly_id"] = assembly_id
        out["ppm_paths"] = example.get("ppm_paths")
        out["ppm_paths_chosen"] = chosen
        return out

    def load_for_structure_preprocessing(self, example: Dict):
        """All assemblies + chain sequences for the offline preprocessor
        (reference na_data_utils.py:1380-1403)."""
        try:
            chains, asmb, covale, meta = self.parse_structure(example["structure_path"])
        except Exception:
            print("bad_structure: ", example["structure_path"])
            return None, None
        chain_sequences = [(ch.id, ch.type, ch.sequence) for ch in chains.values()]
        chain_dict = self.load_chains(chains)
        assemblies = [(aid, self.load_assembly(chain_dict, asmb, aid, []))
                      for aid in asmb.keys()]
        return assemblies, chain_sequences


# ---------------------------------------------------------------------------
# Token-bucketed batching
# ---------------------------------------------------------------------------

DATE_FORMAT = "%Y-%m-%d"


def parse_date(text: str) -> datetime.date:
    return datetime.datetime.strptime(text, DATE_FORMAT).date()


def read_examples_csv(path: str) -> List[Dict]:
    """A table of training examples as row dicts, rows in file order:
    ``sampling_probability`` a float, ``date`` a ``datetime.date``, every
    other column the string in the file (an empty cell is "")."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        if "sampling_probability" in row:
            row["sampling_probability"] = float(row["sampling_probability"])
        if "date" in row:
            row["date"] = parse_date(row["date"])
    return rows

def pack_by_tokens(items: List, lengths: List[int], max_tokens: int) -> List[List]:
    """Sort-by-length greedy packing into <=max_tokens batches
    (reference StructureLoader, na_data_utils.py:1405-1426)."""
    order = np.argsort(lengths)
    clusters, batch = [], []
    for ix in order:
        size = lengths[ix]
        if size > max_tokens:
            continue
        if size * (len(batch) + 1) <= max_tokens:
            batch.append(items[ix])
        else:
            if batch:
                clusters.append(batch)
            batch = [items[ix]]
    if batch:
        clusters.append(batch)
    return clusters


def make_batch_iter(rows: List[Dict], batch_tokens: int, length_cutoff: int,
                    date_cutoff, crop_large_structures: bool,
                    max_number_of_pdbs: int, rng=np.random):
    """Cluster-probability Bernoulli sampling + date filter + random assembly
    pick + token packing (reference make_batch_iter,
    na_data_utils.py:1438-1499) over the row dicts of ``read_examples_csv``;
    ``date_cutoff`` a ``datetime.date``. Yields lists of (example_dict,
    assembly_id)."""
    samples = []
    for i in rng.permutation(len(rows)):
        example = dict(rows[int(i)])
        if rng.uniform() < example["sampling_probability"] and \
                example["date"] < date_cutoff:
            samples.append(example)

    items, lengths = [], []
    for example in samples:
        asmb_lengths = np.load(example["asmb_lengths_path"], allow_pickle=True).item()
        ids = list(asmb_lengths.keys())
        aid = ids[rng.randint(0, len(ids))] if len(ids) > 1 else ids[0]
        macro_L, protein_L, dna_L, rna_L = asmb_lengths[aid]
        if macro_L >= length_cutoff and len(items) < max_number_of_pdbs:
            if macro_L > batch_tokens and crop_large_structures and (dna_L + rna_L) > 0:
                macro_L = batch_tokens
            items.append((example, aid))
            lengths.append(macro_L)

    clusters = pack_by_tokens(items, lengths, batch_tokens)
    rng.shuffle(clusters)
    return iter(clusters)
