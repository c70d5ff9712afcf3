"""NA-MPNN inference CLI on PyTorch: sequence design, specificity prediction
and scoring.

The same flags, mode defaults (design: B=1, T=0.1; specificity: B=30,
T=0.6; score: B=10) and outputs (FASTA, backbone PDBs, specificity ``.npz``,
stats) as the JAX package's ``cli/run.py``, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions of the kernels). Reads PDB and
mmCIF structures (``.cif``, ``.mmcif``, gzipped or not), ``.npz``
checkpoints in the JAX layout and reference ``.pt`` checkpoints.
``--model_type ligand_mpnn`` runs a LigandMPNN checkpoint given as
``--checkpoint_na_mpnn`` (a ``ligandmpnn_v_32_*.pt`` by its own key names or
the port's ``.npz``; ``models/ligand.py``): the protein residues are designed
with its 21 letters and every other heavy atom (ligands, metals, DNA/RNA) is
context (``data/ligand_input.py``). The flags are the JAX CLI's, plus
``--device``.
``--symmetry_residues "A1,B1|A2,B2"`` (with optional ``--symmetry_weights``
of the same shape) ties positions: each group decodes together and draws
one token (``models/mpnn.py::sample_tied``).

    python -m na_mpnn_tpu_torch.cli.run --mode design \\
        --checkpoint_na_mpnn model.npz --pdb_path 1am9.pdb --out_folder out
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import trace


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model_type", type=str, default="na_mpnn")
    p.add_argument("--checkpoint_na_mpnn", type=str, default=None,
                   help="Path to model weights (.pt or .npz).")
    p.add_argument("--out_folder", type=str, help="Output folder.")
    p.add_argument("--file_ending", type=str, default="")
    p.add_argument("--pdb_path", type=str, default="")
    p.add_argument("--fixed_pos_by_pdb", type=str, default="",
                   help="JSON mapping pdb path -> fixed residues 'A12 A13 ...'")
    p.add_argument("--zero_indexed", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--number_of_batches", type=int, default=1)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--save_stats", type=int, default=0)
    p.add_argument("--chains_to_design", type=str, default=None)
    p.add_argument("--omit_AA", type=str, default="X")
    p.add_argument("--fixed_residues", type=str, default="")
    p.add_argument("--redesigned_residues", type=str, default="")
    p.add_argument("--parse_these_chains_only", type=str, default="")
    p.add_argument("--bias_AA", type=str, default="")
    p.add_argument("--pair_bias_AA", type=str, default="")
    p.add_argument("--symmetry_residues", type=str, default="")
    p.add_argument("--symmetry_weights", type=str, default="")
    p.add_argument("--na_shared_tokens", type=int, default=1)
    p.add_argument("--parse_na_only", type=int, default=0)
    p.add_argument("--design_na_only", type=int, default=0)
    p.add_argument("--k_neighbors", type=int, default=None)
    p.add_argument("--catch_failed_inferences", type=int, default=0)
    p.add_argument("--output_pdbs", type=int, default=1)
    p.add_argument("--output_sequences", type=int, default=1)
    p.add_argument("--output_specificity", type=int, default=0)
    p.add_argument("--load_residues_with_missing_atoms", type=int, default=0)
    p.add_argument("--mode", type=str, default=None,
                   help="design | specificity | score; sets checkpoint/batch/"
                        "temperature defaults. score = teacher-forced "
                        "per-position log-probs of the native sequence under "
                        "random decode orders + unconditional probs")
    p.add_argument("--pad_to_bucket", type=int, default=0,
                   help="Pad each structure to the next multiple of this "
                        "length (padded rows are inert; outputs are truncated "
                        "back to the true length). 0 disables.")
    p.add_argument("--stats_format", type=str, default="pt",
                   help="pt (torch, reference-compatible) or npz")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def apply_mode_defaults(args):
    """Checkpoint, batch size and temperature defaults of each mode."""
    if args.model_type == "ligand_mpnn" and args.checkpoint_na_mpnn is None:
        args.checkpoint_na_mpnn = "./model_params/ligandmpnn_v_32_010_25.pt"
    if args.checkpoint_na_mpnn is None:
        if args.mode in ("design", "score"):
            args.checkpoint_na_mpnn = "./models/design_model/s_19137.pt"
        elif args.mode == "specificity":
            args.checkpoint_na_mpnn = "./models/specificity_model/s_70114.pt"
        else:
            print("Choose mode from: design, specificity, score")
            sys.exit(1)
    if args.batch_size is None:
        args.batch_size = {"design": 1, "specificity": 30, "score": 10}.get(args.mode)
        if args.batch_size is None:
            print("Choose mode from: design, specificity, score")
            sys.exit(1)
    if args.temperature is None:
        args.temperature = {"design": 0.1, "specificity": 0.6,
                            "score": 0.1}.get(args.mode)
        if args.temperature is None:
            print("Choose mode from: design, specificity, score")
            sys.exit(1)
    if args.mode == "score":
        args.save_stats = 1
    return args


def _save_stats(path, out_dict, stats_format):
    if stats_format == "pt":
        torch.save({k: (torch.from_numpy(np.asarray(v))
                        if isinstance(v, np.ndarray) else v)
                    for k, v in out_dict.items()}, path + ".pt")
    else:
        np.savez(path + ".npz", **out_dict)


def _np(t):
    return t.detach().cpu().numpy()


@torch.no_grad()
def main(args):
    """Run the CLI on parsed, defaulted arguments. The stages are spans
    (``trace.py``): ``cli.load`` (checkpoint, folders, specs), then per
    structure ``cli.structure`` over ``cli.parse``, ``cli.featurize``,
    ``cli.model`` (the model calls only) and ``cli.outputs``, which holds
    ``cli.pdbs`` (the backbone PDBs; counts ``files`` written and
    ``templates`` built). Called without ``cli_entry``, no ``cli.call``
    encloses them, and each stage starts a request of its own."""
    from .. import constants
    from ..data import seq_format
    from ..data.featurize import (featurize_inference, get_score, get_seq_rec,
                                  make_pair_bias_ctx, resolve_device)
    from ..data.pdb import BackboneTemplate, parse_pdb
    from ..models.config import ModelConfig, ligand_config
    from ..models.mpnn import (build_decode_groups, sample,
                               sample_decoding_order, sample_tied, score,
                               unconditional_probs)
    from ..params import load_params_any

    with trace.span("cli.load"):
        if args.model_type not in ("na_mpnn", "ligand_mpnn"):
            print("Choose --model_type flag from currently available models")
            sys.exit(1)
        ligand = args.model_type == "ligand_mpnn"
        device = resolve_device(args.device)

        if ligand:
            from ..data.ligand_input import ligand_view
            from ..models.ligand import ALPHABET
            restype_STRtoINT = {c: i for i, c in enumerate(ALPHABET)}
            restype_INTtoSTR = dict(enumerate(ALPHABET))
            dna_char_to_rna_char = {}
            restype_to_int = {constants.RESTYPE_1_TO_3[c]: i
                              for i, c in enumerate(ALPHABET)}
            num_letters = len(ALPHABET)
        else:
            restype_to_int = constants.restype_to_int_table(bool(args.na_shared_tokens))
            restype_STRtoINT, restype_INTtoSTR, dna_char_to_rna_char = \
                seq_format.token_maps(bool(args.na_shared_tokens))
            num_letters = constants.NUM_LETTERS

        seed = args.seed if args.seed else int(np.random.randint(0, 99999))
        np.random.seed(seed)
        generator = torch.Generator(device=device).manual_seed(seed)

        base_folder = args.out_folder
        if base_folder[-1] != "/":
            base_folder += "/"
        os.makedirs(base_folder, exist_ok=True)
        if args.output_sequences:
            os.makedirs(base_folder + "seqs", exist_ok=True)
        if args.output_pdbs:
            os.makedirs(base_folder + "backbones", exist_ok=True)
        if args.output_specificity:
            os.makedirs(base_folder + "specificity", exist_ok=True)
        if args.save_stats:
            os.makedirs(base_folder + "stats", exist_ok=True)

        k_neighbors = args.k_neighbors if args.k_neighbors is not None else 32
        if ligand:
            import dataclasses
            cfg = ligand_config(k_neighbors=k_neighbors, dropout=0.0)
            params, meta = load_params_any(args.checkpoint_na_mpnn, cfg, device=device)
            cfg = dataclasses.replace(
                cfg, atom_context_num=int(meta.get("atom_context_num", 25)),
                k_neighbors=(k_neighbors if args.k_neighbors is not None
                             else int(meta.get("num_edges", 32))))
        else:
            cfg = ModelConfig(k_neighbors=k_neighbors, dropout=0.0)
            params, _ = load_params_any(args.checkpoint_na_mpnn, cfg, device=device)

        bias_AA = seq_format.parse_bias_spec(args.bias_AA, restype_STRtoINT)
        pair_bias_AA = seq_format.parse_pair_bias_spec(args.pair_bias_AA,
                                                       restype_STRtoINT)
        if ligand:
            bias_AA, pair_bias_AA = (bias_AA[:num_letters],
                                     pair_bias_AA[:num_letters, :num_letters])
            omit_AA = np.array([a in args.omit_AA for a in ALPHABET], np.float32)
        else:
            omit_AA = seq_format.omit_vector(args.omit_AA, bool(args.na_shared_tokens))

        if args.fixed_pos_by_pdb:
            with open(args.fixed_pos_by_pdb) as fh:
                fixed_pos_by_pdb = json.load(fh)
        else:
            fixed_pos_by_pdb = {args.pdb_path: args.fixed_residues.split()}

    for pdb, fixed_residues in fixed_pos_by_pdb.items():
        with trace.span("cli.structure"):
            with trace.span("cli.parse"):
                name = seq_format.structure_name(pdb)
                chains = ((args.parse_these_chains_only.split(",")
                           if "," in args.parse_these_chains_only
                           else list(args.parse_these_chains_only))
                          if args.parse_these_chains_only else None)
                parsed = parse_pdb(
                    pdb,
                    chains=chains,
                    parse_na_only=bool(args.parse_na_only),
                    na_shared_tokens=bool(args.na_shared_tokens),
                    load_residues_with_missing_atoms=bool(
                        args.load_residues_with_missing_atoms),
                )
                if ligand:
                    parsed = ligand_view(pdb, parsed, chains)

                L = len(parsed["S"])
                encoded_residues = [
                    f"{parsed['chain_letters'][i]}{parsed['R_idx'][i]}{parsed['icodes'][i]}"
                    for i in range(L)
                ]
                encoded_residue_dict = {r: i for i, r in enumerate(encoded_residues)}

            with trace.span("cli.featurize"):
                fixed_positions = np.array(
                    [int(r not in fixed_residues) for r in encoded_residues], np.int32)
                if args.redesigned_residues:
                    redesigned = args.redesigned_residues.split()
                    redesigned_positions = np.array(
                        [int(r not in redesigned) for r in encoded_residues], np.int32)
                else:
                    redesigned_positions = np.zeros_like(fixed_positions)

                if isinstance(args.chains_to_design, str):
                    chains_to_design_list = args.chains_to_design.split(",")
                else:
                    chains_to_design_list = parsed["chain_letters"]
                if args.design_na_only:
                    chains_to_design_list = [c for c in chains_to_design_list
                                             if c in parsed["na_chain_letters"]]
                chain_sel = np.array([c in chains_to_design_list
                                      for c in parsed["chain_letters"]], np.int32)
                chain_mask = chain_sel * fixed_positions * (1 - redesigned_positions)

                sym_lists = ([[encoded_residue_dict[t] for t in x.split(",")]
                              for x in args.symmetry_residues.split("|")]
                             if args.symmetry_residues else [[]])
                if args.symmetry_weights:
                    sym_weights = [[float(v) for v in x.split(",")]
                                   for x in args.symmetry_weights.split("|")]
                else:
                    sym_weights = [[1.0] * len(x) for x in sym_lists]
                use_symmetry = any(len(x) > 0 for x in sym_lists)

                pad_L = 0
                if args.pad_to_bucket:
                    pad_L = -(-L // args.pad_to_bucket) * args.pad_to_bucket
                batch = featurize_inference(parsed, chain_mask, pad_to=pad_L, device=device)
                if ligand:
                    batch.update({k: torch.from_numpy(parsed[k])[None].to(device)
                                  for k in ("Y", "Y_t", "Y_m")})
                L_run = max(pad_L, L)
                bias = torch.as_tensor(np.tile(-1e8 * omit_AA + bias_AA, (L_run, 1)),
                                       device=device)
                pair_bias_ctx = None
                if args.pair_bias_AA:
                    pair_bias_ctx = make_pair_bias_ctx(
                        _np(batch["chain_labels"][0]), _np(batch["R_idx"][0]),
                        pair_bias_AA, device=device)

                mask_f = batch["mask"].float()
                rec_mask = mask_f * batch["chain_mask"].float()       # [1, L_run]
                chain_mask_np = _np(rec_mask[0])
                if args.mode == "score":
                    tiled = {k: v.repeat_interleave(args.batch_size, dim=0)
                             for k, v in batch.items()}

            if args.mode == "score":
                with trace.span("cli.model"):
                    outs = [score(params, cfg, tiled, generator=generator)
                            for _ in range(args.number_of_batches)]
                    uncond_t = unconditional_probs(params, cfg, batch)["log_probs"]
                with trace.span("cli.outputs"):
                    log_probs_t = torch.cat([out["log_probs"].float() for out in outs], 0)
                    uncond = _np(uncond_t.float())[0]
                    N_total = log_probs_t.shape[0]
                    loss, loss_pr = get_score(batch["S"][:1].expand(N_total, -1),
                                              log_probs_t, rec_mask.expand(N_total, -1),
                                              num_letters)
                    rec_argmax = _np(get_seq_rec(batch["S"][:1], log_probs_t.argmax(-1),
                                                 rec_mask))
                    log_probs_stack = _np(log_probs_t)
                    order_stack = _np(torch.cat([out["decoding_order"] for out in outs], 0))
                    loss_pr = _np(loss_pr)
                    if L_run > L:
                        log_probs_stack = log_probs_stack[:, :L]
                        uncond = uncond[:L]
                        loss_pr = loss_pr[:, :L]
                        order_stack = np.stack(
                            [row[row < L] for row in order_stack.reshape(-1, L_run)]
                        ).reshape(order_stack.shape[:-1] + (L,))
                    out_dict = {
                        "log_probs": log_probs_stack,
                        "mean_probs": np.mean(np.exp(log_probs_stack.astype(np.float64)), 0),
                        "unconditional_log_probs": uncond,
                        "decoding_order": order_stack,
                        "native_sequence": _np(batch["S"][0])[:L],
                        "loss": _np(loss),
                        "loss_per_residue": loss_pr,
                        "recovery_argmax": rec_argmax,
                        "mask": _np(batch["mask"][0])[:L],
                        "chain_mask": _np(batch["chain_mask"][0])[:L],
                        "seed": seed,
                    }
                    _save_stats(base_folder + "stats/" + name, out_dict, args.stats_format)
                continue

            with trace.span("cli.model"):
                outs = []
                for _ in range(args.number_of_batches):
                    if use_symmetry:
                        base_order = _np(sample_decoding_order(rec_mask, generator))[0]
                        groups, gweights, flat = build_decode_groups(
                            base_order, sym_lists, sym_weights, L_run)
                        outs.append(sample_tied(
                            params, cfg, batch, generator, groups, gweights, flat,
                            num_samples=args.batch_size, temperature=args.temperature,
                            bias=bias, pair_bias_ctx=pair_bias_ctx))
                    else:
                        outs.append(sample(
                            params, cfg, batch, generator, num_samples=args.batch_size,
                            temperature=args.temperature, bias=bias,
                            pair_bias_ctx=pair_bias_ctx))

            with trace.span("cli.outputs"):
                S_list, log_probs_list, probs_list, order_list = [], [], [], []
                loss_list, loss_pr_list = [], []
                for out in outs:
                    loss, loss_per_residue = get_score(out["S"], out["log_probs"],
                                                       rec_mask, num_letters)
                    S_list.append(_np(out["S"]))
                    log_probs_list.append(_np(out["log_probs"]))
                    probs_list.append(_np(out["sampling_probs"]))
                    order_list.append(_np(out["decoding_order"]))
                    loss_list.append(_np(loss))
                    loss_pr_list.append(_np(loss_per_residue))

                S_stack = np.concatenate(S_list, 0)
                log_probs_stack = np.concatenate(log_probs_list, 0)
                sampling_probs_stack = np.concatenate(probs_list, 0)
                decoding_order_stack = np.concatenate(order_list, 0)
                loss_stack = np.concatenate(loss_list, 0)
                loss_per_residue_stack = np.concatenate(loss_pr_list, 0)
                rec_stack = _np(get_seq_rec(batch["S"][:1].long(),
                                            torch.as_tensor(S_stack, device=device),
                                            rec_mask))

                if L_run > L:
                    S_stack = S_stack[:, :L]
                    log_probs_stack = log_probs_stack[:, :L]
                    sampling_probs_stack = sampling_probs_stack[:, :L]
                    loss_per_residue_stack = loss_per_residue_stack[:, :L]
                    decoding_order_stack = np.stack(
                        [row[row < L] for row in
                         decoding_order_stack.reshape(-1, L_run)]).reshape(
                             decoding_order_stack.shape[:-1] + (L,))

                S_native = _np(batch["S"][0])[:L]
                rna_conv = _np(batch["rna_mask_for_token_conversion"][0])[:L]

                def ints_to_seq(S_ints):
                    return seq_format.ints_to_seq(S_ints, rna_conv, restype_INTtoSTR,
                                                  dna_char_to_rna_char)

                def seq_by_chains(seq):
                    return seq_format.seq_by_chains(seq, parsed["mask_c"])

                native_seq = ints_to_seq(S_native)
                out_dict = {
                    "generated_sequences": S_stack,
                    "sampling_probs": sampling_probs_stack,
                    "log_probs": log_probs_stack,
                    "decoding_order": decoding_order_stack,
                    "native_sequence": S_native,
                    "mask": _np(batch["mask"][0])[:L],
                    "chain_mask": _np(batch["chain_mask"][0])[:L],
                    "seed": seed,
                    "temperature": args.temperature,
                }
                if args.save_stats:
                    _save_stats(base_folder + "stats/" + name, out_dict, args.stats_format)

                if args.output_specificity:
                    predicted_ppm = np.mean(sampling_probs_stack.astype(np.float64), axis=0)
                    np.savez(os.path.join(base_folder, "specificity", name + ".npz"),
                             predicted_ppm=predicted_ppm,
                             true_sequence=S_native.astype(np.int64),
                             chain_labels=_np(batch["chain_labels"][0])[:L],
                             mask=_np(batch["mask"][0])[:L],
                             protein_mask=_np(batch["protein_mask"][0])[:L],
                             dna_mask=_np(batch["dna_mask"][0])[:L],
                             rna_mask=_np(batch["rna_mask"][0])[:L],
                             encoded_residues=encoded_residues,
                             encoded_residues_dict=encoded_residue_dict,
                             restype_to_int=restype_to_int)

                fasta_entries = [seq_format.native_fasta_entry(
                    name, args.temperature, seed, int(np.sum(chain_mask_np)),
                    args.batch_size, args.number_of_batches, args.checkpoint_na_mpnn,
                    seq_by_chains(native_seq))]
                seqs = [ints_to_seq(row) for row in S_stack]
                suffixes = [ix if args.zero_indexed else ix + 1 for ix in range(len(seqs))]
                if args.output_pdbs:
                    # the structure's fixed columns are formatted once, in
                    # the template; each file fills its names and B-factors
                    with trace.span("cli.pdbs", files=0, templates=0) as pdbs:
                        template = BackboneTemplate(parsed)
                        pdbs.add(templates=1)
                        for seq, ix_suffix, bf in zip(seqs, suffixes,
                                                      loss_per_residue_stack):
                            new_resnames = [constants.RESTYPE_1_TO_3.get(c, "UNK")
                                            for c in seq]
                            bfactors = np.exp(-bf) * (bf > 0.01).astype(np.float32)
                            template.write(
                                base_folder + "backbones/" + name + f"_{ix_suffix}.pdb"
                                + args.file_ending, new_resnames, bfactors)
                            pdbs.add(files=1)
                for ix, (seq, ix_suffix) in enumerate(zip(seqs, suffixes)):
                    fasta_entries.append(seq_format.sample_fasta_entry(
                        name, ix_suffix, args.temperature, seed,
                        np.exp(-loss_stack[ix]), rec_stack[ix], seq_by_chains(seq)))

                if args.output_sequences:
                    with open(base_folder + "seqs/" + name + ".fa" + args.file_ending,
                              "w") as f:
                        f.write("\n".join(fasta_entries))


def cli_entry(argv=None):
    """The command line: arguments, mode defaults, ``main``; the whole call
    is the span ``cli.call``, its argument parsing a ``cli.load`` before
    the one in ``main``."""
    with trace.span("cli.call"):
        with trace.span("cli.load"):
            args = apply_mode_defaults(build_argparser().parse_args(argv))
        if not args.catch_failed_inferences:
            main(args)
            return
        try:
            main(args)
        except Exception as e:  # noqa: BLE001 — per-structure failure record
            base_folder = args.out_folder
            if base_folder[-1] != "/":
                base_folder += "/"
            os.makedirs(base_folder + "failed_inferences", exist_ok=True)
            if args.fixed_pos_by_pdb:
                with open(args.fixed_pos_by_pdb) as fh:
                    fixed_pos_by_pdb = json.load(fh)
            else:
                fixed_pos_by_pdb = {args.pdb_path: []}
            from ..data.seq_format import structure_name
            for pdb in fixed_pos_by_pdb:
                with open(base_folder + "failed_inferences/" + structure_name(pdb)
                          + ".txt", "w") as f:
                    f.write(str(e))

if __name__ == "__main__":
    cli_entry()
