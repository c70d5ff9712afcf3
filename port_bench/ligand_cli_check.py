"""LigandMPNN through the CLI's score mode against the plain reference, on
the card:

    python3 -m port_bench.ligand_cli_check --seeds 1,2,3

For each seed: a protein-DNA complex with a small molecule and waters
written as a PDB (``traffic.write_pdb``'s protein and DNA chains, a
ligand of 30 heavy atoms and its hydrogens), random LigandMPNN weights
from the seed written as a ``ligandmpnn_v_32_010_25``-style ``.pt``, the
CLI (``--model_type ligand_mpnn --mode score``, 10 orders) on the card;
then the reference reads the file with its own reader and computes the
log-probabilities of the native sequence under each order the CLI used,
and the unconditional ones, in float32 with TF32 off, and in TF32 (the
control). One JSON line a seed: ``logp_gap`` (the largest absolute gap
over the orders' protein positions), ``uncond_gap``, and the control's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from . import traffic, weights_ligand
from .reference import ligand_model as LM
from .reference import model as M
from .run import ROOT, forbidden_modules

CHAINS = [("A", "protein", 150), ("B", "protein", 120), ("C", "dna", 20), ("D", "dna", 20)]


def write_complex(path, seed):
    """The complex of ``CHAINS`` with a 30-atom ligand (and a hydrogen on
    each of its carbons) near a protein residue, and three waters."""
    traffic.write_pdb(path, CHAINS, seed, 0)
    rng = traffic.rng_for(seed, 11)
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln != "END"]
    ca = [ln for ln in lines if ln[12:16] == " CA "]
    anchor = np.array([float(ca[len(ca) // 2][30 + 8 * k:38 + 8 * k]) for k in range(3)])
    pos = anchor + 5.0 * rng.standard_normal(3) / np.sqrt(3)
    serial = 90000
    for i in range(30):
        pos = pos + 1.5 * rng.standard_normal(3) / np.sqrt(3)
        el = "CNOSCCPC"[i % 8]
        for name, e, xyz in ((f"{el}{i}", el, pos), (f"H{i}", "H", pos + 1.0)):
            if e == "H" and el != "C":
                continue
            lines.append(f"HETATM{serial % 100000:>5} {name[:4]:<4} LIG L   1    "
                         f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00 10.00          {e:>2}")
            serial += 1
    for k in range(3):
        xyz = anchor + 8.0 + k
        lines.append(f"HETATM{serial + k:>5}  O   HOH W{k + 1:>4}    {xyz[0]:8.3f}{xyz[1]:8.3f}"
                     f"{xyz[2]:8.3f}  1.00 10.00           O")
    with open(path, "w") as f:
        f.write("\n".join(lines + ["END"]) + "\n")


def check(seed, cfg, out, device="cuda"):
    from na_mpnn_tpu_torch.cli.run import cli_entry

    pdb = os.path.join(out, f"complex_{seed}.pdb")
    write_complex(pdb, seed)
    sd = weights_ligand.make(cfg, seed, device)
    ckpt = os.path.join(out, f"ligand_{seed}.pt")
    torch.save({"model_state_dict": {k: v.cpu() for k, v in sd.items()},
                "num_edges": cfg["NUM_NEIGHBORS"],
                "atom_context_num": cfg["ATOM_CONTEXT_NUM"]}, ckpt)
    folder = os.path.join(out, f"out_{seed}")
    cli_entry(["--model_type", "ligand_mpnn", "--checkpoint_na_mpnn", ckpt,
               "--pdb_path", pdb, "--out_folder", folder, "--mode", "score",
               "--device", device, "--seed", str(seed), "--stats_format", "npz",
               "--output_pdbs", "0"])
    stats = np.load(os.path.join(folder, "stats", f"complex_{seed}.npz"))
    r = LM.read_pdb(pdb)
    ref = {k: torch.as_tensor(v, device=device)[None] for k, v in r.items()}
    orders = torch.as_tensor(stats["decoding_order"], device=device)
    k = cfg["NUM_NEIGHBORS"]
    result = {"seed": seed, "residues": int(len(r["S"])), "context_atoms": int(len(r["Y"]))}
    with torch.no_grad(), M.exact_float32():
        for prec in ("fp32", "tf32"):
            p = M.Precision(prec)
            gap = 0.0
            for row in range(orders.shape[0]):
                want = LM.log_probs(sd, ref, k, p, ref["S"], orders[row:row + 1])
                gap = max(gap, float(np.abs(stats["log_probs"][row]
                                            - want[0].cpu().numpy()).max()))
            unc = LM.log_probs(sd, ref, k, p, None, orders[:1])
            ugap = float(np.abs(stats["unconditional_log_probs"] - unc[0].cpu().numpy()).max())
            tag = "" if prec == "fp32" else "tf32_"
            result[tag + "logp_gap"], result[tag + "uncond_gap"] = gap, ugap
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="1,2,3")
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "port_bench", "configs", "ligand_mpnn.json")) as f:
        cfg = json.load(f)
    with tempfile.TemporaryDirectory() as out:
        for seed in [int(s) for s in args.seeds.split(",")]:
            print(json.dumps(check(seed, cfg, out)), flush=True)
    if forbidden_modules():
        print("forbidden modules loaded: " + ", ".join(forbidden_modules()), file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
