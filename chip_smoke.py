#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``na_mpnn_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit. Phases, each of which raises on failure:

1. device check: prints the card's name and power limit, turns TF32 off;
2. build: compiles ``na_mpnn_tpu_torch/csrc/*.cu`` (one nvcc per source, in
   parallel) and prints the seconds; then the host side of the data path
   (``host_reader_phase``): whether the native structure tokenizer
   (``native/na_parse.cc``, ``g++`` at first use) built, where and in how
   many seconds, or the compiler's error (the pure-Python reader then
   serves); where it built, its records against the Python reader's on the
   synthetic PDB and its gzipped copy, ``parse_pdb``'s features bitwise
   from both, and ms per read and per parse of each; ``utils/geometry.py``
   on CUDA tensors against the CPU; topology and 1D features of every
   entry of the packaged residue library; the phase's seconds;
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: kNN (E_idx and D exact, also with the masked rows of
   ``--pad_to_bucket 32``, and on ``_knn_cases``: exact ties, masked rows
   and interleaved masked keys, Lk < k, Lk = k, k = 48, 200 and Lk = 150,
   9000 keys streamed in tiles, fractional masks; non-finite coordinates
   against the rule the kernel's header states), class-specialised RBF, the message table in
   its three modes and the fused layer updates (encoder node, decoder node,
   encoder edge; fp32 and bf16 at design's, score's and a packed
   batch-design group's shape and on key rows) (relative error < 1e-5;
   random masks, m1d = 0 on some decoder edges, masked nodes in the group);
4. main path: the port's CLI on a synthetic protein-DNA PDB of 389
   residues with random full-width weights (H=128, K=32, 3+3 layers) in
   design, specificity and score mode, in design mode with
   ``--pad_to_bucket 32``, with ``--symmetry_residues`` (tied positions
   draw equal tokens) and on the same structure written as mmCIF (the PDB
   run's fields, shapes and native sequence), printing which reader read
   each run's structure; checks the outputs and that
   each run took the fused route (3 encoder node and 3 edge updates per
   encode, 3 decoder node updates per parallel decoder, no message-table
   launch); then the time of encode, sample, score and unconditional
   probs at that shape; encode and score on the fused route against the
   message-table route, in turns; ``eval.batch_design`` on 5 structures
   (design and specificity); the evaluation path (``eval_phase``): random
   weights as ``s_1000.npz`` and their ``.pt`` export ``s_2000.pt``,
   ``cli/sweep.py::run_sweep`` over both in score and design mode (10
   samples; the two rows bitwise equal), ``predict_nucleic_acid_ppm`` (30
   samples) and ``score_specificity_prediction`` against a PPM written for
   DNA chain C (a finite Pearson), seconds per structure of each, rows 1,
   3, 11 and 12 launched; then score and unconditional probs with the
   kernels against the plain path (``kernels="torch"``) on the card at
   that structure padded to 416 rows, and against the CPU on a small
   structure;
5. training: 8 synthetic protein-DNA structures of 600-768 residues through
   ``parse_pdb`` and ``collate_batch`` (B=8, L=768, K=32: 196,608 edges);
   at that shape, the kernels of the training step against their plain
   versions (kNN's E_idx and D exact, and ``torch.topk`` on the prebuilt
   masked distance matrix timed beside it as the selection alone by a
   library call; the RBF projection, the message table with
   its saved ``x``, its backward in three modes, the RBF weight gradient;
   relative error < 1e-5 on rows and nodes, < 1e-4 on sums over
   all edges; every output of the two backward kernels bitwise equal
   across two launches; the RBF dW's edge groups and both kernels' scratch
   bytes printed), then the full-width
   ``Trainer`` (dropout 0.1, noise 0.1 A): 5 train steps and 1 eval step,
   with the launches of every step counted, loss, gradients and parameters
   checked, ms per step and peak memory printed, save -> restore bitwise,
   and one step's loss and gradients with the kernels against
   ``kernels="torch"`` on the card;
6. the pre-gathered message MLP (rows 7, 8: ``csrc/message_mlp.cu``,
   ``csrc/message_mlp_bwd.cu``, on rows 9 and 10's tile walks) against its
   plain versions in all four (contract_e, aggregate) variants, at N = 203
   for K = 1, 30, 48, 64 (H = 128) and H = 32, 64 (K = 32), then timed at
   N = 6000, K = 32, H = 128, every output of both bitwise equal across two
   launches; 5 full-width Trainer steps
   on a batch collated with ``use_buckets=False`` (B=8, L=750), where the
   decoder takes the gathered route (launches per step: kNN 1, RBF 1, RBF
   dW 1, message table 6 and its backward 6, ``message_mlp`` 3 and its
   backward 3), one such step against ``kernels="torch"``, and a
   ``torch.profiler`` trace of 3 more steps (rows 7 and 8's device ms per
   step, the busy share), each at fp32 and bf16, the step's ms and peak
   memory beside the classed L=768 step's;
7. the training loop: 16 synthetic PDBs through the port's
   ``cli/preprocess``, then ``run_training`` for 2 epochs (2 loader
   workers, 6000-token batches, a ``torch.profiler`` capture of 3 steps)
   and resumed for 1; logs, checkpoint, resumed step, no ``message_mlp``
   launch on the bucketed batches; seconds per epoch, ms per step, the
   loader's wait, the profile's top device operations and idle share;
8. the bf16 trunk (``MIXED_PRECISION: 1``, the JAX training default): the
   bf16 variants of rows 3, 4, 9-12 (``*_bf16`` entries of the same
   sources) against their plain bf16 versions at the training shape
   (relative error < 2^-8 on the RBF's fp32 sums, < 2^-6 on bf16 outputs;
   the RBF weight gradient and every output of row 10 bitwise equal
   across two launches; both nearer their plain bf16 versions than the
   fp32 kernels, ``_check_rounding``; bounds at the bf16 tensor-core
   peak); 5 bf16 ``Trainer`` steps of ``model_config_from_params({})``
   at B=8 x L=768 (launches per step: kNN 1 and the bf16 variants only:
   RBF 1, RBF dW 1, message table 9, its
   backward 9), ms per step and peak memory against the fp32 step, a bf16
   eval step (fused route: 3 + 3 + 3 launches), one step against
   ``kernels="torch"`` at bf16; and ``run_training`` for 1 epoch from a
   config without ``MIXED_PRECISION``, with a profile beside the fp32
   loop's;
9. the rest of the bf16 trunk: the bf16 variants of rows 5-8 against their
   plain bf16 versions (the dense RBF and its weight gradient at the
   training shape, < 1e-3; rows 3-6 at bf16 also for a 192-row shard
   against the structure's 768 key rows, the graph-parallel route's
   operands; the message MLP and its backward at N = 6000 in all four
   variants, < 2^-6; the weight gradients of rows 4, 6, 8 bitwise equal
   across two launches); 5 bf16 Trainer steps with ``rbf_mode="dense"``
   (rows 5, 6 bf16: 1 + 1 per step) and 5 on the unbucketed batch (rows 7,
   8 bf16: 3 + 3 per step), each with ms per step and peak memory beside
   its fp32 counterpart of this run and one step against ``kernels="torch"``
   at bf16; 3 bf16 steps of ``Trainer(mesh=(1,1))`` on the one-rank NCCL
   mesh (the G = 1 policy: the one-device trunk) and one deterministic step
   against the one-device bf16 step;
10. one JSON line of the kernels (launches on the main paths, error, times,
   bound), then the card's name and power limit as ``nvidia-smi`` gives
   them and, last, the device JSON.

Rows 3 and 9 (the classed RBF and the message-table forward, both on the
tensor cores) are held at both dtypes wherever they are held: row 3 at B=1
and B=10 of the design structure, at the training shape and for the
192-row key shard; row 9 at N = 389 and 3890, at the training shape with
and without x, and for the 192-row shard against the 768-row table. Every
such output is bitwise equal across two launches, row 9's output without x
equal to its output with x, both bf16 variants pass ``_check_rounding``
(row 9 for x too), the classify kernel of row 3 gives the plain
``edge_list_codes``, and the new kernels' dynamic shared memory is
printed beside ``ptxas``'s registers and spills. The token embedding's
gradient (a one-hot product) is held bitwise equal across two backward
passes, and the whole flat gradient of one step is held bitwise equal
across two passes from the same state and generator (``_grads_twice``,
which raises naming the leaves that differ) on the classed B=8 x L=768
step and the unbucketed B=8 x L=750 step (the gathered decoder, whose
context gather sums its gradient in a fixed order), each at fp32 and bf16. The
earlier scalar-FMA times of rows 3, 4, 9 and 10 are printed as text beside
this run's (``SCALAR_MS``), never in the kernels JSON line.

Rows 11 and 12 (the fused layer updates, on row 9's tile walk with
epilogues of their own) are held at both dtypes at B=1 and B=10 of the
design structure, a packed group with masked nodes and edges, a 100-row
shard against the structure's 389 key rows and eval_step's B=8 x L=768
(bf16, and fp32 on the same widened operands): every output, and the node
update's fp32 dh between its two launches, bitwise equal across two
launches, both bf16 variants passing ``_check_rounding``, the bf16 dh
off the bf16 grid (unrounded); the kernels' dynamic shared memory
printed, and ``ptxas``'s
registers and spills of every kernel by name. ``torch.profiler`` traces
one encode at B=1 and one score call at B=10 (fp32) and one bf16 eval
step: device ms per operation, the busy share, and rows 11 and 12's
share and the kNN's. The query/key kNN (row 2) meets ``_knn_cases`` too,
for a shard of query rows a third of the way into each structure. Their earlier
scalar-FMA times are printed as text (``FMA_FUSED_MS``).

Rows 5 and 6 (the dense RBF projection and its weight gradient) run rows 3
and 4's tensor-core walks over each edge's atom-pair groups
(``csrc/rbf_tile.cuh``), at fp32 the same instantiations: their fp32
outputs are held bitwise equal to rows 3 and 4's on the training operands
and on the 192-row shard, and row 5's to row 3's at B=1 and B=10 of the
design structure, where row 5 is timed at both dtypes (the dense inference
path's shapes), and held to their plain versions at B=1 at every width
their walks are built for. Every output of rows 5 and 6 at both dtypes is
bitwise equal across two launches, the forward's too. A ``torch.profiler`` trace of
3 dense steps at fp32 and at bf16 gives rows 5 and 6's device ms per step,
and the dense step's ms and peak memory are printed beside the classed
step's of the same run at both dtypes. Their earlier scalar-FMA times are
printed as text (``SCALAR_MS``).

Inside the one-rank NCCL group of the mesh phase run the paths that need
no kernel of their own: ``sample_graph_parallel`` against the one-device
``sample`` from the same generator seed (design B=1 and specificity B=30
on the 389-residue complex, design on a 6144-residue structure; tokens and
orders equal, probabilities within JAX's bars; the encode's launches; s
per structure and peak memory of both), the key-chunked plain kNN bitwise
the one-shot at L = 6144; ``remat="layer"`` against ``"none"`` (one
classed step at fp32 and bf16 and one unbucketed step at fp32: loss,
flat gradient and launches the same; ms and peak of 3 steps of each);
and the frames the RBF kernels do not take (the 65-atom table on the
(1,1) mesh with ``gp_rbf_row_chunk=32`` at fp32 and bf16 and on one
device at B=2 x L=384; ``include_pred_na_N=False`` at B=8 x L=768), each
against ``kernels="torch"``, with ms, peak and launches.

Outputs go to ``build/chip_smoke/`` in the checkout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
REL_TOL = 1e-5
PEAK_FP32_FLOPS = 67e12      # H100 SXM, outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM, bf16 tensor cores, dense
PEAK_BYTES = 3.35e12         # H100 SXM HBM3

PROTEIN_ATOMS = ["N", "CA", "C", "O"]
DNA_ATOMS = ["OP1", "OP2", "P", "O5'", "C5'", "C4'", "O4'", "C3'", "O3'",
             "C2'", "C1'"]
RNA_ATOMS = DNA_ATOMS[:10] + ["O2'", "C1'"]
RESNAMES = {"protein": ["GLY", "ALA", "SER", "LEU", "LYS", "ASP"],
            "dna": ["DA", "DC", "DG", "DT"], "rna": ["A", "C", "G", "U"]}
ATOMS = {"protein": PROTEIN_ATOMS, "dna": DNA_ATOMS, "rna": RNA_ATOMS}
DESIGN_CHAINS = (("A", "protein", 150), ("B", "protein", 150),
                 ("C", "dna", 45), ("D", "dna", 44))


def write_synthetic_pdb(path, chains=DESIGN_CHAINS, seed=0):
    """Write a random but compact protein / nucleic-acid structure as PDB:
    chains of (id, kind, length), kind in protein | dna | rna, residue
    centres on a random walk of 4 A steps, every backbone atom (O2' on RNA)
    placed around its centre. Returns the number of residues."""
    rng = np.random.RandomState(seed)
    lines, serial, pos, n_res = [], 1, np.zeros(3), 0
    for chain, kind, n in chains:
        for i in range(n):
            step = rng.randn(3)
            pos = pos + 4.0 * step / np.linalg.norm(step)
            resname = RESNAMES[kind][i % len(RESNAMES[kind])]
            for name in ATOMS[kind]:
                xyz = pos + rng.randn(3) * 1.2
                nm = name if len(name) == 4 else " " + name
                element = name.strip("'0123456789")[0]
                lines.append(
                    f"ATOM  {serial:>5} {nm:<4} {resname:>3} {chain}{i + 1:>4}    "
                    f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00 10.00          "
                    f"{element:>2}")
                serial += 1
            n_res += 1
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return n_res


SIDE_FILES = ("interface_masks", "side_chain_interface_masks",
              "nearest_protein_side_chain_index", "base_pair_masks",
              "base_pair_index", "canonical_base_pair_masks",
              "canonical_base_pair_index")


def write_training_set(folder, structures, seed=0):
    """A training set on disk: one synthetic PDB per entry of ``structures``
    (the chains of each, as ``write_synthetic_pdb`` takes them), the port's
    ``cli/preprocess`` over them (backbone atoms), and the training CSV that
    ``run_training`` reads (the side files' paths, sampling probability 1,
    date 2020-01-01, no PPMs). Returns the CSV's path."""
    from na_mpnn_tpu_torch.cli.preprocess import main as preprocess

    os.makedirs(os.path.join(folder, "structures"), exist_ok=True)
    names = [f"s{i}" for i in range(len(structures))]
    paths = [os.path.join(folder, "structures", f"{n}.pdb") for n in names]
    for i, (path, chains) in enumerate(zip(paths, structures)):
        write_synthetic_pdb(path, chains, seed=seed + i)
    csv_in = os.path.join(folder, "input.csv")
    with open(csv_in, "w") as f:
        f.write("structure_path\n" + "\n".join(paths) + "\n")
    pp = os.path.join(folder, "preprocess.json")
    with open(pp, "w") as f:
        json.dump({"ATOMS_TO_LOAD": "backbone"}, f)
    out = os.path.join(folder, "preprocessed")
    preprocess([csv_in, out, "1", "0", pp])
    bad = os.listdir(os.path.join(out, "bad"))
    if bad:
        raise AssertionError(f"preprocessing failed for {bad}")
    cols = (["structure_path", "sampling_probability", "date", "ppm_paths",
             "asmb_lengths_path"] + [f"asmb_{s}_path" for s in SIDE_FILES])
    lines = [",".join(cols)]
    for name, path in zip(names, paths):
        side = [f"{out}/asmb_{s}/{name}.npy" for s in ("lengths",) + SIDE_FILES]
        lines.append(",".join([path, "1.0", "2020-01-01", "[]"] + side))
    train_csv = os.path.join(folder, "train.csv")
    with open(train_csv, "w") as f:
        f.write("\n".join(lines) + "\n")
    return train_csv


def training_config(train_csv, base, **overrides):
    """A ``run_training`` config at the reference regime (H=128, K=32, 3+3
    layers, 6000-token batches, dropout 0.1, noise 0.1 A, fp32), validating
    on the training CSV; ``overrides`` replace any key."""
    cfg = {
        "VOCAB_SIZE": 33, "NUM_LETTERS": 33,
        "PARSE_PROTEIN": 1, "PARSE_DNA": 1, "PARSE_RNA": 1,
        "PARSE_RNA_AS_DNA": 0, "NA_SHARED_TOKENS": 1, "NA_REF_ATOM": "C1'",
        "INCLUDE_PRED_NA_N": 1,
        "PROTEIN_BACKBONE_OCC_CUTOFF": 0.8, "PROTEIN_SIDE_CHAIN_OCC_CUTOFF": 0.5,
        "DNA_BACKBONE_OCC_CUTOFF": 0.8, "DNA_SIDE_CHAIN_OCC_CUTOFF": 0.5,
        "RNA_BACKBONE_OCC_CUTOFF": 0.8, "RNA_SIDE_CHAIN_OCC_CUTOFF": 0.5,
        "DATE_CUTOFF": "2030-01-01",
        "MAX_NUMBER_OF_PDBS_TRAIN": 1000, "MAX_NUMBER_OF_PDBS_VALID": 1000,
        "BATCH_TOKENS": 6000, "LOSS_TOKENS": 6000, "LABEL_SMOOTHING": 0.1,
        "EXCLUDE_RES": ["HOH"], "MIN_PROTEIN_LENGTH_CUTOFF": 1,
        "NUM_WORKERS": 0, "TOTAL_STEPS": 100000, "RANDOMIZE_NMR_MODEL": 0,
        "CROP_LARGE_STRUCTURES": 0, "MIN_OVERLAP_LENGTH": 5,
        "DF_PATH_TRAIN": train_csv, "DF_PATH_VALID": train_csv,
        "BASE_FOLDER": base, "PREV_CHECKPOINT": "",
        "HIDDEN_DIM": 128, "NUM_ENCODER_LAYERS": 3, "NUM_DECODER_LAYERS": 3,
        "NUM_NEIGHBORS": 32, "DROPOUT": 0.1, "DECODE_PROTEIN_FIRST": 0,
        "PROTEIN_BACKBONE_NOISE": 0.1, "DNA_BACKBONE_NOISE": 0.1,
        "RNA_BACKBONE_NOISE": 0.1, "PARSE_PPMS": 0,
        "NA_ONLY_AS_UNIFORM_PPM": 0, "DROP_PROTEIN_PROBABILITY": 0,
        "PROTEIN_INTERFACE_RESIDUE_MUTATION_PROBABILITY": 0,
        "MUTATE_BASE_PAIR_TOGETHER": 0,
        "MUTATE_ENTIRE_SIDE_CHAIN_INTERFACE_PROBABILITY": 0,
        "NA_NON_INTERFACE_AS_UNIFORM_PPM": 0, "GRADIENT_NORM": 1.0,
        "MIXED_PRECISION": 0, "SAVE_EVERY_N_STEPS": 1000,
        "ATOMS_TO_LOAD": "backbone", "METRICS_TO_COMPUTE": "basic",
    }
    cfg.update(overrides)
    return cfg


def _sync_time(fn, iters):
    """Mean ms per call on the card (CUDA events, after 2 warm-up calls)."""
    import torch
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel_err(a, b):
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)


def _bound_ms(ops, nbytes, peak=PEAK_FP32_FLOPS):
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _knn_bound(B, L, K, Lk=None):
    """kNN's least work per pair: the masked distance (12 operations), the
    row max and about one comparison to select the k smallest; with ``Lk``
    (the query/key form) L query rows against Lk key rows."""
    if Lk is None:
        return _bound_ms(B * L * L * 14, B * L * 16 + B * L * K * 12)
    return _bound_ms(B * L * Lk * 14, B * (L + Lk) * 16 + B * L * K * 12)


def _rbf_bound(X_aug, X_m_aug, E_idx, H, num_rbf=16, w_bytes=4,
               peak=PEAK_FP32_FLOPS):
    """The RBF projection (classed or dense) and its weight gradient: 16 *
    (2H + 8) operations per present atom pair of each edge (the data decides
    how many); bytes: coordinates, masks, neighbours, one [E, H] fp32 tensor
    and one [5184, H] of ``w_bytes`` per element (the bf16 forward's
    weight)."""
    import torch
    B, L, K = E_idx.shape
    nq = X_m_aug.sum(-1)                                         # [B,L]
    nn = torch.gather(nq, 1, E_idx.reshape(B, -1)).reshape(B, L, K)
    pairs = float((nq[:, :, None] * nn).sum())
    nbytes = ((X_aug.numel() + X_m_aug.numel() + B * L * K * H) * 4
              + 18 * 18 * num_rbf * H * w_bytes + E_idx.numel() * 8)
    return _bound_ms(pairs * num_rbf * (2 * H + 8), nbytes, peak)


def _message_table_bound(mode, N, K, H, C, save_x=False, esize=4,
                         peak=PEAK_FP32_FLOPS):
    """The message table's least work: h_V@Wa per node; e_in@Wb, W2 and
    about 30 elementwise operations per edge element; W3 per edge only in
    enc_edge, since in the summing modes sum_k w_k (W3 g_k + b3) =
    W3 (sum_k w_k g_k) + b3 sum_k w_k. With ``save_x`` x is written too.
    ``esize``: bytes per activation, mask and weight element (2 for bf16)."""
    if mode == "enc_edge":
        ops = N * K * (6 * H * H + 30 * H) + N * 2 * H * H
    else:
        ops = N * K * (4 * H * H + 30 * H) + N * 4 * H * H
    out = N * K * H if mode == "enc_edge" else N * H
    nbytes = (esize * (N * H + N * K * H + N * C + 2 * N * K + 4 * H * H + 3 * H
                       + out + (N * K * H if save_x else 0)) + 8 * N * K)
    return _bound_ms(ops, nbytes, peak)


def _fused_bound(kind, N, K, H, C, esize=4, peak=PEAK_FP32_FLOPS):
    """Least work of the fused layer updates: the message table's count for
    its mode (``_message_table_bound``), plus in the node update the
    feed-forward block (16 H^2 per node) and two LayerNorms with their
    residuals (about 10 operations per element each), in the edge update
    LN3 and its residual (about 8 per edge element). Bytes: every input
    once (node and edge rows, table, masks, indices, weights) and the
    output once, ``esize`` bytes per float element."""
    w = 4 * H * H + 3 * H
    if kind == "edge":
        ops = N * K * (6 * H * H + 38 * H) + N * 2 * H * H
        nbytes = esize * (N * H + 2 * N * K * H + N * C + w + 2 * H) + 8 * N * K
    else:
        ops = N * K * (4 * H * H + 30 * H) + N * (20 * H * H + 20 * H)
        nbytes = (esize * (2 * N * H + N * K * H + N * C + 2 * N * K + N + w
                           + 8 * H * H + 9 * H) + 8 * N * K)
    return _bound_ms(ops, nbytes, peak)


def _random_layer(cfg, seed, dev):
    """An encoder and a decoder layer of random weights, with random biases
    and LayerNorm scales/offsets (the initial zeros and ones would hide a
    misplaced term)."""
    import torch
    from na_mpnn_tpu_torch.models import init_params
    params = init_params(seed, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for p in (params["encoder"][0], params["decoder"][0]):
        for name, sub in p.items():
            for leaf in (sub["W_in"], sub["W_out"]) if name == "dense" else (sub,):
                for k in ("b", "bias"):
                    if k in leaf:
                        leaf[k].copy_(0.3 * torch.randn(leaf[k].shape, generator=gen,
                                                        device=dev))
                if "scale" in leaf:
                    leaf["scale"].copy_(1.0 + 0.3 * torch.randn(
                        leaf["scale"].shape, generator=gen, device=dev))
        out.append(p)
    return out


# Rows 11 and 12 in their earlier scalar-FMA form, from PERF.md's kernel
# table (chip_smoke on an NVIDIA H100 80GB HBM3, 700 W; fp32 at the design,
# score and group shapes, bf16 at eval_step's): printed beside this run's
# times as text, never part of the kernels JSON line.
FMA_FUSED_MS = {
    "fused_node_update_enc": {"design": 0.1164, "score": 0.5540, "group": 0.1552},
    "fused_node_update_dec": {"design": 0.1125, "score": 0.5635, "group": 0.1589},
    "fused_edge_update": {"design": 0.0706, "score": 0.5201, "group": 0.1309},
    "fused_node_update_enc_bf16": {"eval_step": 0.8323},
    "fused_node_update_dec_bf16": {"eval_step": 0.8393},
    "fused_edge_update_bf16": {"eval_step": 0.8069},
}


def _fused_cases(pe, pd, ops, eidx2, K, L, Lk):
    """The three fused layer updates on one set of operands (``ops``: h_V2,
    h_E2, the H- and 2H-wide tables, m_att, m1d, mbw and the node mask) ->
    {name: (call, kernel, plain, kind, C, message)}: ``call(f)`` runs ``f``
    (the kernel's wrapper or its plain version) on them; ``message(plain)``
    gives the node update's message part: the kernel's fp32 dh, the scratch
    its second launch reads, or the plain message sum (None for the edge
    update)."""
    from na_mpnn_tpu_torch.ops import fused_layers as fl
    h_V2, h_E2, tab, tab2, m_att, m1d, mbw, mask2 = ops
    H = h_V2.shape[1]
    kw = dict(K=K, L=L, Lk=Lk)

    def node(args):
        def message(plain):
            if plain:
                return fl.fused_node_message_plain(*args[:8], **kw)
            return fl.fused_node_update_launch(*args, **kw)[1]
        return (lambda f: f(*args, **kw)), message

    enc, enc_msg = node(("enc", pe, h_V2, h_E2, tab, eidx2, m_att, None, mask2))
    dec, dec_msg = node(("dec", pd, h_V2, h_E2, tab2, eidx2, m1d, mbw, mask2))
    return {
        "fused_node_update_enc": (enc, fl.fused_node_update_cuda,
                                  fl.fused_node_update_plain, "node", H, enc_msg),
        "fused_node_update_dec": (dec, fl.fused_node_update_cuda,
                                  fl.fused_node_update_plain, "node", 2 * H, dec_msg),
        "fused_edge_update": (lambda f: f(pe, h_V2, h_E2, tab, eidx2, **kw),
                              fl.fused_edge_update_cuda, fl.fused_edge_update_plain,
                              "edge", H, None),
    }


def _check_fused(name, tag, case, tol, fp32=None):
    """One fused update held on the card: its output within ``tol`` of its
    plain version (relative to the plain output's largest magnitude) and
    bitwise equal across two launches; the node update's message part (its
    fp32 dh) within ``tol`` of the plain message sum and bitwise across two
    launches; at bf16 (``fp32``: the same update of
    fp32 parameters on the widened operands) nearer its plain bf16 version
    than the fp32 kernel (``_check_rounding``). Returns (relative error,
    note, largest absolute error)."""
    import torch
    call, kernel, plain, _, _, message = case
    out_k = call(kernel)
    if not torch.equal(out_k, call(kernel)):
        raise AssertionError(f"{name} {tag}: two launches differ")
    out_p = call(plain)
    err = _rel_err(out_k.float(), out_p.float())
    if not err < tol:
        raise AssertionError(f"{name} {tag}: relative error {err:.3g} (tol {tol:.3g})")
    note = ", bitwise across two launches"
    if message is not None:
        dh = message(False)
        if not torch.equal(dh, message(False)):
            raise AssertionError(f"{name} {tag}: two launches of the message part differ")
        dh_err = _rel_err(dh, message(True).float())
        if not dh_err < tol:
            raise AssertionError(f"{name} {tag}: message part (fp32 dh) relative "
                                 f"error {dh_err:.3g} (tol {tol:.3g})")
        note += f"; message part (fp32 dh) rel err {dh_err:.3g}, bitwise"
        if fp32 is not None:
            # at bf16 dh must reach the tail unrounded, as JAX carries it
            # into LN1: an fp32 value is its own bf16 rounding about once in
            # 2^16, so a dh rounded on the way out would show here as 1.0
            kept = float((dh != dh.to(torch.bfloat16).float()).float().mean())
            if not (dh.dtype == torch.float32 and kept > 0.5):
                raise AssertionError(f"{name} {tag}: dh {dh.dtype}, only {kept:.3f} "
                                     f"of it off the bf16 grid (rounded?)")
            note += f", {kept:.3f} of dh off the bf16 grid (unrounded)"
    if fp32 is not None:
        note += ("; rms {:.3g} from plain vs {:.3g} from the fp32 kernel"
                 .format(*_check_rounding(name, out_k, out_p, fp32[0](fp32[1]))))
    return err, note, float((out_k.float() - out_p.float()).abs().max())


def fused_kernel_phase(pdb):
    """The fused layer updates (rows 11, 12) against their plain versions on
    the card, fp32 and bf16: the encoder node update, the decoder node
    update and the edge update at design's shape (B=1, L=389), score's (N =
    3890), one packed batch-design group (two copies of the structure padded
    to 400 rows, so masked nodes and masked edges) and a 100-row shard of
    the design structure against its 389 key rows (the graph-parallel
    route's table of Lk rows); random operands, decoder masks m1d and mbw
    random with mbw <= m1d. Each output is held by ``_check_fused``: fp32
    at a relative error < 1e-5, bf16 < 2^-6 and ``_check_rounding``, every
    output (and the node update's fp32 dh) bitwise across two launches, the
    bf16 dh off the bf16 grid. Prints the kernels' dynamic shared memory. Returns the rows of the
    kernels JSON line (fp32, design's shape)."""
    import torch
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.models.modules import cast_tree
    from na_mpnn_tpu_torch.ops import fused_layers as fl
    from na_mpnn_tpu_torch.ops import knn
    from na_mpnn_tpu_torch.ops._build import library

    dev = torch.device("cuda")
    bf = torch.bfloat16
    cfg = ModelConfig()
    H, K = cfg.hidden_dim, cfg.k_neighbors
    pe, pd = _random_layer(cfg, 6, dev)
    pe16, pd16 = cast_tree(pe, bf), cast_tree(pd, bf)
    gen = torch.Generator(device=dev).manual_seed(6)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for tag, n_copies, pad_to, shard in (("design", 1, 0, None), ("score", 10, 0, None),
                                         ("group", 2, 400, None),
                                         ("key rows", 1, 0, (100, 200))):
        _, _, _, X_ref, mask = _structure(pdb, dev, n_copies, pad_to)
        B, Lk = mask.shape
        _, E_idx = knn.knn_graph_cuda(X_ref, mask, K)
        nb_mask = torch.gather(mask, 1, E_idx.reshape(B, -1)).reshape(B, Lk, K)
        qmask = mask
        if shard is not None:
            E_idx, nb_mask, qmask = (t[:, shard[0]:shard[1]].contiguous()
                                     for t in (E_idx, nb_mask, mask))
        L = E_idx.shape[1]
        N = B * L
        eidx2 = E_idx.reshape(-1).contiguous()
        mask2 = qmask.reshape(-1).contiguous()
        m_att = (mask2.repeat_interleave(K) * nb_mask.reshape(-1)).contiguous()
        m1d = mask2.repeat_interleave(K).contiguous()
        mbw = (m1d * (torch.rand((N * K,), generator=gen, device=dev) > 0.5)).contiguous()
        if pad_to and not (float(mask2.min()) == 0.0 and float(m_att.min()) == 0.0):
            raise AssertionError("fused group case: no masked rows to check")
        ops = [torch.randn((N, H), generator=gen, device=dev),
               torch.randn((N * K, H), generator=gen, device=dev),
               torch.randn((B * Lk, H), generator=gen, device=dev),
               torch.randn((B * Lk, 2 * H), generator=gen, device=dev),
               m_att, m1d, mbw, mask2]
        ops16 = [t.to(bf) for t in ops]
        cases = _fused_cases(pe, pd, ops, eidx2, K, L, Lk)
        cases16 = _fused_cases(pe16, pd16, ops16, eidx2, K, L, Lk)
        wide = _fused_cases(pe, pd, [t.float() for t in ops16], eidx2, K, L, Lk)
        shape = f"B={B} L={L}" + (f" of Lk={Lk}" if shard else "") + f" N={N} K={K} H={H}"
        for name, case in cases.items():
            for low in (False, True):
                c = cases16[name] if low else case
                call, kernel, plain, kind, C, _ = c
                err, note, max_err = _check_fused(
                    name + ("_bf16" if low else ""), tag, c, BF16_TOL if low else REL_TOL,
                    fp32=(wide[name][0], wide[name][1]) if low else None)
                ms = _sync_time(lambda: call(kernel), 20)
                plain_ms = _sync_time(lambda: call(plain), 5)
                bound = (_fused_bound(kind, N, K, H, C, esize=2, peak=PEAK_BF16_FLOPS)
                         if low else _fused_bound(kind, N, K, H, C))
                if kind == "node":
                    note += f"; tail tiles of {fl.tail_tile_rows(N, H, n_sm)} nodes"
                earlier = FMA_FUSED_MS.get(name + ("_bf16" if low else ""), {}).get(tag)
                if earlier is not None:
                    note += f" (scalar-FMA form, PERF.md: {earlier} ms)"
                print(f"{name}{'_bf16' if low else ''} {tag} {shape}: rel err {err:.3g} "
                      f"(< {BF16_TOL if low else REL_TOL:.3g}){note}; {ms:.4f} ms "
                      f"(plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]}"
                      f"{' at the bf16 peak' if low else ''}, {ms / bound[0]:.1f}x the "
                      f"bound)", flush=True)
                if tag == "design" and not low:
                    rows[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound[0], bound_by=bound[1])
    mt, fz = library("message_table"), library("fused_layers")
    tail = {low: " / ".join(str(fz.fused_node_tail_smem(H, r, low)) for r in (16, 32, 64))
            for low in (0, 1)}
    print(f"fused layer updates, dynamic shared memory per block (H = {H}): the "
          f"message walk (message_tile.cuh, as row 9's) fp32 "
          f"{mt.message_table_forward_smem(H, H, 0)} B (dec "
          f"{mt.message_table_forward_smem(H, 2 * H, 0)} B), bf16 "
          f"{mt.message_table_forward_smem(H, H, 1)} B (dec "
          f"{mt.message_table_forward_smem(H, 2 * H, 1)} B); the node update's tail "
          f"at 16 / 32 / 64 nodes per tile fp32 {tail[0]} B, bf16 {tail[1]} B",
          flush=True)
    return rows


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build_phase():
    from na_mpnn_tpu_torch.ops import _build
    t0 = time.time()
    out = _build.build_all()
    print(f"build: {time.time() - t0:.1f} s into {os.path.relpath(out, ROOT)}",
          flush=True)
    for name in _build.SOURCES:
        log = (out / f"{name}.log").read_text(errors="replace")
        for kernel, regs, spill in _ptxas_kernels(log):
            print(f"  ptxas {name} {kernel}: {regs}; {spill}")


def _ptxas_kernels(log):
    """(kernel, registers, spills) of every entry function in an ``nvcc
    -Xptxas -v`` log, the names demangled by ``c++filt`` where the machine
    has it."""
    import re
    found, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name is not None:
            found.append([name, line.split(":", 1)[-1].strip(), spill])
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(f[0] for f in found),
                               capture_output=True, text=True, check=True).stdout.split("\n")
        for f, n in zip(found, names):
            f[0] = n.replace("(anonymous namespace)::", "")
    except (OSError, subprocess.CalledProcessError):
        pass
    return found


def _structure(pdb, device, n_copies=1, pad_to=0):
    """(batch, X_aug, X_m_aug, X_ref, mask) of a PDB, padded to ``pad_to``
    residues with masked rows and tiled n_copies times."""
    from na_mpnn_tpu_torch.data.featurize import featurize_inference
    from na_mpnn_tpu_torch.data.pdb import parse_pdb
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.models.features import build_augmented_atoms
    parsed = parse_pdb(pdb)
    batch = featurize_inference(parsed, np.ones(len(parsed["S"]), np.int32),
                                pad_to=pad_to, device=device)
    batch = {k: v.repeat_interleave(n_copies, 0) for k, v in batch.items()}
    X_aug, X_m_aug, X_ref = build_augmented_atoms(batch["X"], batch["X_m"],
                                                  batch, ModelConfig())
    return batch, X_aug, X_m_aug, X_ref, batch["mask"].float()


def _walk(B, L, seed, step=3.8):
    """``[B, L, 3]`` float32 random walks of ``step`` A (a chain's residue
    centres)."""
    rng = np.random.RandomState(seed)
    d = rng.randn(B, L, 3)
    return np.cumsum(step * d / np.linalg.norm(d, axis=-1, keepdims=True),
                     1).astype(np.float32)


def _knn_cases():
    """The kNN's tie-heavy and edge cases, (tag, X [B,L,3], mask [B,L], K)
    in numpy float32: duplicated coordinates on an integer grid (exact ties)
    with masked query rows (padding of B=3 structures of 300, 257 and 100
    residues) and every fifth key masked; Lk < k and Lk = k; k = 48 (four
    slots a lane), k = 200 and k = Lk = 150 (rounds of 128); Lk = 9000
    (keys streamed in tiles); fractional masks (the general form)."""
    rng = np.random.RandomState(11)
    grid = rng.randint(0, 4, (3, 300, 3)).astype(np.float32)
    m = np.zeros((3, 300), np.float32)
    for b, n in enumerate((300, 257, 100)):
        m[b, :n] = 1
    m[:, ::5] = 0
    cases = [("ties, masked rows and keys, B=3", grid, m, 32)]
    short = _walk(2, 20, 1)
    ms = np.ones((2, 20), np.float32)
    ms[1, 13:] = 0
    cases.append(("Lk < k (L=20)", short, ms, 32))
    cases.append(("Lk = k (L=32)", _walk(1, 32, 2), np.ones((1, 32), np.float32), 32))
    walk = _walk(2, 389, 3)
    mw = np.ones((2, 389), np.float32)
    mw[0, 300:] = 0
    mw[1, 7::11] = 0
    cases.append(("k=48", walk, mw, 48))
    cases.append(("k=200", walk, mw, 200))
    cases.append(("k = Lk = 150", walk[:, :150].copy(), mw[:, :150].copy(), 150))
    big = _walk(1, 9000, 4)
    mb = np.ones((1, 9000), np.float32)
    mb[0, 8500:] = 0
    mb[0, 100::97] = 0
    cases.append(("tiled keys (Lk=9000)", big, mb, 32))
    cases.append(("fractional masks", walk, rng.rand(2, 389).astype(np.float32), 32))
    return cases


def knn_hard_cases(qk=False):
    """The kNN kernel against its plain version on the card on
    ``_knn_cases``: ``knn_forward``, or with ``qk`` ``knn_qk_forward`` for a
    shard of query rows a third of the way into each structure (a shard
    that starts mid-structure); ``E_idx`` and ``D`` equal exactly."""
    import torch
    from na_mpnn_tpu_torch.ops import knn
    dev = torch.device("cuda")
    name = "knn_qk" if qk else "knn"
    for tag, X, mask, K in _knn_cases():
        X, mask = torch.from_numpy(X).to(dev), torch.from_numpy(mask).to(dev)
        B, L = mask.shape
        if qk:
            s0, n = L // 3, max(1, L // 3)
            Xq, mq = X[:, s0:s0 + n].contiguous(), mask[:, s0:s0 + n].contiguous()
        else:
            Xq, mq = X, mask
        D_k, E_k = knn.knn_graph_qk_cuda(Xq, X, mq, mask, K) if qk else \
            knn.knn_graph_cuda(X, mask, K)
        D_p, E_p = knn.knn_graph_qk_plain(Xq, X, mq, mask, K)
        if not (torch.equal(E_k, E_p) and torch.equal(D_k, D_p)):
            raise AssertionError(f"{name} {tag}: E_idx or D differs from the plain version")
        print(f"{name} {tag}: B={B} Lq={Xq.shape[1]} Lk={L} K={K} (k={E_k.shape[-1]}): "
              f"E_idx and D exact", flush=True)


def _knn_rule(X, mask, k, eps=1e-6):
    """What the kNN kernel's header states for non-finite values: the
    finite adjusted values ascending (ties to the lower key), then (+inf,
    j*) for every slot left, j* the lowest key whose value is not NaN."""
    import torch
    inf = float("inf")
    m2 = mask[:, :, None] * mask[:, None, :]
    dX = X[:, :, None, :] - X[:, None, :, :]
    d2 = dX[..., 0] * dX[..., 0] + dX[..., 1] * dX[..., 1]
    d2 = d2 + dX[..., 2] * dX[..., 2]
    D = m2 * torch.sqrt(d2 + eps)
    D_max = torch.where(torch.isnan(D), -inf, D).amax(-1, keepdim=True)
    v = D + (1.0 - m2) * D_max
    finite = v < inf
    vals, idx = torch.sort(torch.where(finite, v, inf), dim=-1, stable=True)
    L = X.shape[1]
    keys = torch.arange(L, device=X.device)
    jstar = torch.where(torch.isnan(v), L, keys).amin(-1, keepdim=True)
    slot = torch.arange(k, device=X.device)
    fill = slot < finite.sum(-1, keepdim=True)
    return (torch.where(fill, vals[..., :k], inf),
            torch.where(fill, idx[..., :k], jstar))


def knn_nonfinite_check():
    """The kNN kernel on coordinates with NaN and inf (rows with fewer
    finite values than k among them) against ``_knn_rule``, exactly."""
    import torch
    from na_mpnn_tpu_torch.ops import knn
    X = torch.from_numpy(_walk(2, 64, 5)).cuda()
    mask = torch.ones((2, 64), device="cuda")
    X[0, 3, 0] = float("nan")
    X[0, 17, 1] = float("inf")
    X[1, :50, 2] = float("nan")
    mask[1, 60] = 0
    for K in (8, 40):
        D_k, E_k = knn.knn_graph_cuda(X, mask, K)
        D_r, E_r = _knn_rule(X, mask, K)
        if not (torch.equal(E_k, E_r) and torch.equal(D_k, D_r)):
            raise AssertionError(f"knn non-finite K={K}: differs from the stated rule")
        print(f"knn non-finite coordinates B=2 L=64 K={K}: E_idx and D as the "
              "kernel's header states", flush=True)


def kernel_phase(pdb):
    """Each kernel against its plain version on the card; returns the
    measured numbers of each kernel at the design shape (B=1)."""
    import torch
    from na_mpnn_tpu_torch.models import init_params
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.ops import knn, message_kernels, rbf_classed, rbf_edge

    dev = torch.device("cuda")
    cfg = ModelConfig()
    H, K = cfg.hidden_dim, cfg.k_neighbors
    params = init_params(1, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # kNN: the design structure, the same padded to 416 rows as
    # --pad_to_bucket 32 pads it (masked pairs) and a 6144-residue chain.
    long_pdb = os.path.join(OUT, "long.pdb")
    write_synthetic_pdb(long_pdb, (("A", "protein", 6144),), seed=3)
    for tag, path, pad_to in (("design", pdb, 0), ("design_pad416", pdb, 416),
                              ("L6144", long_pdb, 0)):
        _, _, _, X_ref, mask = _structure(path, dev, pad_to=pad_to)
        B, L = mask.shape
        if pad_to and float(mask.sum()) >= L:
            raise AssertionError(f"knn {tag}: no masked rows to check")
        D_k, E_k = knn.knn_graph_cuda(X_ref, mask, K)
        D_p, E_p = knn.knn_graph_plain(X_ref, mask, K)
        if not (torch.equal(E_k, E_p) and torch.equal(D_k, D_p)):
            raise AssertionError(f"knn {tag}: E_idx or D differs from the plain version")
        err = float((D_k - D_p).abs().max())
        ms = _sync_time(lambda: knn.knn_graph_cuda(X_ref, mask, K), 20)
        plain_ms = _sync_time(lambda: knn.knn_graph_plain(X_ref, mask, K), 5)
        bound = _knn_bound(B, L, K)
        print(f"knn {tag} B={B} L={L} K={K}: E_idx and D exact, max|dD|={err:.3g}, "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms)",
              flush=True)
        if tag == "design":
            rows["knn"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound[0], bound_by=bound[1])
    knn_hard_cases()
    knn_nonfinite_check()

    # RBF at the design shape (B=1) and the score shape (B=10); its bf16
    # variant (the fold-scaled weight) beside it, both bitwise across two
    # launches.
    W = params["features"]["edge_embedding"]["w"][cfg.num_positional_embeddings:]
    W_fold = rbf_classed.fold_scaled(W)
    for n_copies in (1, 10):
        _, X_aug, X_m_aug, X_ref, mask = _structure(pdb, dev, n_copies)
        _, E_idx = knn.knn_graph_cuda(X_ref, mask, K)
        out_k = rbf_classed.rbf_edge_features_classed_cuda(X_aug, X_m_aug, E_idx, W)
        out_p = rbf_classed.rbf_edge_features_classed_plain(X_aug, X_m_aug, E_idx, W)
        rel = _rel_err(out_k, out_p)
        if not rel < REL_TOL:
            raise AssertionError(f"rbf B={n_copies}: relative error {rel:.3g}")
        if not torch.equal(out_k, rbf_classed.rbf_edge_features_classed_cuda(
                X_aug, X_m_aug, E_idx, W)):
            raise AssertionError(f"rbf B={n_copies}: two launches differ")
        lo_k = rbf_classed.rbf_classed_bf16_cuda(X_aug, X_m_aug, E_idx, W_fold)
        lo_rel = _rel_err(lo_k, rbf_classed.rbf_classed_bf16_plain(
            X_aug, X_m_aug, E_idx, W_fold))
        if not (lo_rel < RBF_BF16_TOL and torch.equal(lo_k, rbf_classed.rbf_classed_bf16_cuda(
                X_aug, X_m_aug, E_idx, W_fold))):
            raise AssertionError(f"rbf_classed_bf16 B={n_copies}: relative error "
                                 f"{lo_rel:.3g}, or two launches differ")
        lo_ms = _sync_time(lambda: rbf_classed.rbf_classed_bf16_cuda(
            X_aug, X_m_aug, E_idx, W_fold), 20)
        print(f"rbf_classed_bf16 B={n_copies}: rel err {lo_rel:.3g} (< "
              f"{RBF_BF16_TOL:.3g}), two launches bitwise equal, {lo_ms:.4f} ms",
              flush=True)
        del lo_k
        ms = _sync_time(lambda: rbf_classed.rbf_edge_features_classed_cuda(
            X_aug, X_m_aug, E_idx, W), 20)
        plain_ms = _sync_time(lambda: rbf_classed.rbf_edge_features_classed_plain(
            X_aug, X_m_aug, E_idx, W), 3)
        B, L = mask.shape
        bound = _rbf_bound(X_aug, X_m_aug, E_idx, H)
        print(f"rbf_classed B={B} L={L} K={K}: rel err {rel:.3g} (< {REL_TOL}), "
              f"two launches bitwise equal, {ms:.4f} ms ("
              + (f"scalar-FMA form, PERF.md: {SCALAR_MS['rbf_classed_B1']} ms; "
                 if n_copies == 1 else "")
              + f"plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms)", flush=True)
        if n_copies == 1:
            rows["rbf_classed"] = dict(max_abs_err=float((out_k - out_p).abs().max()),
                                       ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound[0], bound_by=bound[1])
        del out_p
        # row 5 (the dense forward) at the dense inference path's shapes: at
        # fp32 the classed walk's instantiation, so row 3's bits
        for name, fn, plain, w, tol in (
                ("rbf_edge", rbf_edge.rbf_edge_cuda, rbf_edge.rbf_edge_features_plain,
                 W, REL_TOL),
                ("rbf_edge_bf16", rbf_edge.rbf_edge_bf16_cuda,
                 rbf_edge.rbf_edge_bf16_plain, W, RBF_EDGE_BF16_TOL)):
            d_k = fn(X_aug, X_m_aug, E_idx, w)
            d_rel = _rel_err(d_k, plain(X_aug, X_m_aug, E_idx, w))
            if not (d_rel < tol and torch.equal(d_k, fn(X_aug, X_m_aug, E_idx, w))):
                raise AssertionError(f"{name} B={n_copies}: relative error {d_rel:.3g}, "
                                     "or two launches differ")
            if name == "rbf_edge" and not torch.equal(d_k, out_k):
                raise AssertionError(f"rbf_edge B={n_copies}: differs from rbf_classed "
                                     "(one instantiation, the same operands)")
            d_ms = _sync_time(lambda: fn(X_aug, X_m_aug, E_idx, w), 20)
            print(f"{name} (dense) B={B} L={L} K={K}: rel err {d_rel:.3g} (< {tol:.3g}), "
                  f"two launches bitwise equal"
                  + (", bitwise rbf_classed's output" if name == "rbf_edge" else "")
                  + f", {d_ms:.4f} ms", flush=True)
            del d_k

    # rows 5 and 6 at every width their walks are built for (B=1): a random
    # weight and cotangent of that width, each against its plain version
    _, X_aug, X_m_aug, X_ref, mask = _structure(pdb, dev)
    _, E_idx = knn.knn_graph_cuda(X_ref, mask, K)
    checked = []
    for Hw in rbf_edge.FORWARD_WIDTHS:
        Ww = 0.05 * torch.randn((18 * 18 * 16, Hw), generator=gen, device=dev)
        gw = torch.randn(E_idx.shape + (Hw,), generator=gen, device=dev)
        cases = [(rbf_edge.rbf_edge_cuda, rbf_edge.rbf_edge_features_plain, Ww, REL_TOL),
                 (rbf_edge.rbf_edge_bf16_cuda, rbf_edge.rbf_edge_bf16_plain, Ww,
                  RBF_EDGE_BF16_TOL)]
        if Hw in rbf_edge.DW_WIDTHS:
            cases += [(rbf_edge.rbf_edge_dw_cuda, rbf_edge.rbf_edge_dw_plain, gw, 1e-4),
                      (rbf_edge.rbf_edge_dw_bf16_cuda, rbf_edge.rbf_edge_dw_bf16_plain, gw,
                       RBF_EDGE_BF16_TOL)]
        for fn, plain, arg, tol in cases:
            got = fn(X_aug, X_m_aug, E_idx, arg)
            rel = _rel_err(got, plain(X_aug, X_m_aug, E_idx, arg))
            if not (rel < tol and torch.equal(got, fn(X_aug, X_m_aug, E_idx, arg))):
                raise AssertionError(f"{fn.__name__} H={Hw}: relative error {rel:.3g} "
                                     f"(tol {tol:.3g}), or two launches differ")
            checked.append(f"{fn.__name__} H={Hw} {rel:.2g}")
    print(f"rows 5 and 6 at every width (B=1, relative error against the plain "
          f"version, two launches bitwise equal): {', '.join(checked)}", flush=True)

    # Message table, three modes, at N = 389 and N = 10*389.
    p = params["encoder"][0]
    pd = params["decoder"][0]
    for n_copies in (1, 10):
        _, _, _, X_ref, mask = _structure(pdb, dev, n_copies)
        B, L = mask.shape
        N = B * L
        _, E_idx = knn.knn_graph_cuda(X_ref, mask, K)
        eidx2 = E_idx.reshape(-1).contiguous()
        h_V2 = torch.randn((N, H), generator=gen, device=dev)
        h_E2 = torch.randn((N * K, H), generator=gen, device=dev)
        tab = torch.randn((N, H), generator=gen, device=dev)
        tab2 = torch.randn((N, 2 * H), generator=gen, device=dev)
        m_att = (torch.rand((N * K,), generator=gen, device=dev) > 0.1).float()
        # Decoder masks as on a padded batch: m1d = 0 on some edges, and
        # mbw <= m1d.
        m1d = (torch.rand((N * K,), generator=gen, device=dev) > 0.2).float()
        mbw = m1d * (torch.rand((N * K,), generator=gen, device=dev) > 0.5).float()
        ones = torch.ones_like(m_att)
        for mode, w, table, ma, mb in (("enc_node", p, tab, m_att, ones),
                                       ("enc_edge", p, tab, ones, ones),
                                       ("dec", pd, tab2, m1d, mbw)):
            wa, wb, _, w2, _, w3, _ = message_kernels._weights(w, H, "W1", "W2", "W3")
            # Random biases: the initial ones are zero and would hide a
            # misplaced bias term.
            b1, b2, b3 = (torch.randn((H,), generator=gen, device=dev) for _ in range(3))
            args = (mode, h_V2, h_E2, table, eidx2, ma, mb,
                    wa, wb, b1, w2, b2, w3, b3)
            out_k = message_kernels.message_table_cuda(*args, K=K, L=L)
            out_p = message_kernels.message_table_plain(*args, K=K, L=L)
            rel = _rel_err(out_k, out_p)
            if not rel < REL_TOL:
                raise AssertionError(f"message_table {mode} N={N}: rel err {rel:.3g}")
            if not torch.equal(out_k, message_kernels.message_table_cuda(*args, K=K, L=L)):
                raise AssertionError(f"message_table {mode} N={N}: two launches differ")
            # the bf16 variant on the same operands rounded to bf16
            lo = [t.to(torch.bfloat16) if torch.is_tensor(t) and t.is_floating_point()
                  else t for t in args]
            lo_k = message_kernels.message_table_cuda(*lo, K=K, L=L)
            lo_rel = _rel_err(lo_k.float(), message_kernels.message_table_plain(
                *lo, K=K, L=L).float())
            if not (lo_rel < BF16_TOL and torch.equal(
                    lo_k, message_kernels.message_table_cuda(*lo, K=K, L=L))):
                raise AssertionError(f"message_table {mode} bf16 N={N}: rel err "
                                     f"{lo_rel:.3g}, or two launches differ")
            print(f"message_table {mode} bf16 N={N}: rel err {lo_rel:.3g} "
                  f"(< {BF16_TOL:.3g}), two launches bitwise equal (fp32 too)",
                  flush=True)
            ms = _sync_time(lambda: message_kernels.message_table_cuda(*args, K=K, L=L), 20)
            plain_ms = _sync_time(lambda: message_kernels.message_table_plain(
                *args, K=K, L=L), 5)
            bound = _message_table_bound(mode, N, K, H, table.shape[1])
            print(f"message_table {mode} N={N} K={K} H={H}: rel err {rel:.3g} "
                  f"(< {REL_TOL}), {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                  f"bound {bound[0]:.5f} ms)", flush=True)
            if n_copies == 1:
                rows[f"message_table_{mode}"] = dict(
                    max_abs_err=float((out_k - out_p).abs().max()), ms=ms,
                    plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1])
    return rows


def _check_finite(arr, shape, what):
    arr = np.asarray(arr)
    if arr.shape != shape or not np.all(np.isfinite(arr)):
        raise AssertionError(f"{what}: shape {arr.shape} (want {shape}) "
                             f"finite={bool(np.all(np.isfinite(arr)))}")


def write_synthetic_cif(pdb, path):
    """The atoms of a PDB file written again as an mmCIF ``atom_site``
    table (the same names, residues, chains, numbers and coordinates)."""
    from na_mpnn_tpu_torch.data.pdb import read_pdb_atoms
    rows = []
    for a in read_pdb_atoms(pdb):
        name = f'"{a.name}"' if "'" in a.name else a.name
        rows.append(f"ATOM {a.element} {name} {a.resname} {a.chain} {a.resnum} ? . "
                    f"{a.xyz[0]:.3f} {a.xyz[1]:.3f} {a.xyz[2]:.3f} "
                    f"{a.occupancy:.2f} {a.bfactor:.2f} 1")
    cols = ("group_PDB", "type_symbol", "label_atom_id", "label_comp_id",
            "auth_asym_id", "auth_seq_id", "pdbx_PDB_ins_code", "label_alt_id",
            "Cartn_x", "Cartn_y", "Cartn_z", "occupancy", "B_iso_or_equiv",
            "pdbx_PDB_model_num")
    with open(path, "w") as f:
        f.write("data_synthetic\n#\nloop_\n"
                + "".join(f"_atom_site.{c}\n" for c in cols)
                + "\n".join(rows) + "\n")


# Two tied groups of the DNA chains: C1 (residue 300) with D44 (388), and
# C2, C3 (301, 302) with D43 (387).
SYMMETRY = ("C1,D44|C2,C3,D43", "1.0,0.5|1.0,1.0,2.0", ((300, 388), (301, 302, 387)))


def _fused_launches_ok(counts, n_dec):
    """The fused route's launches: per encode (one kNN each) 3 encoder node
    and 3 edge updates, 3 decoder node updates per parallel decoder, and no
    message-table launch."""
    n_enc = counts.get("knn", 0)
    return (n_enc >= 1 and counts.get("rbf_classed", 0) == n_enc
            and counts.get("fused_node_update_enc", 0) == 3 * n_enc
            and counts.get("fused_edge_update", 0) == 3 * n_enc
            and counts.get("fused_node_update_dec", 0) == 3 * n_dec
            and not any(k.startswith("message_table") for k in counts))


def main_path_phase(pdb, L):
    """The port's CLI on the card, per mode (design, specificity, score,
    design padded to 416 rows, symmetry-tied design, design from mmCIF);
    checks the outputs and the fused route's launches; prints which reader
    read each run's structure; returns the launches."""
    import torch
    from na_mpnn_tpu_torch.cli.run import cli_entry
    from na_mpnn_tpu_torch.data.native_loader import native_available
    from na_mpnn_tpu_torch.models import init_params
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches
    from na_mpnn_tpu_torch.params import save_checkpoint_npz

    reader = "native tokenizer" if native_available() else "pure-Python"
    ckpt = os.path.join(OUT, "random_weights.npz")
    save_checkpoint_npz(ckpt, init_params(0, ModelConfig(), device="cpu"))
    cif = os.path.join(OUT, "synthetic.cif")
    write_synthetic_cif(pdb, cif)
    total = {}
    runs = (("design", pdb, []),
            ("specificity", pdb, ["--output_specificity", "1"]),
            ("score", pdb, []),
            ("design_pad32", pdb, ["--pad_to_bucket", "32"]),
            ("symmetry", pdb, ["--symmetry_residues", SYMMETRY[0],
                               "--symmetry_weights", SYMMETRY[1],
                               "--batch_size", "2"]),
            ("cif", cif, []))
    for tag, path, extra in runs:
        mode = tag if tag in ("specificity", "score") else "design"
        name = os.path.basename(path).rsplit(".", 1)[0]
        out = os.path.join(OUT, tag)
        argv = ["--mode", mode, "--checkpoint_na_mpnn", ckpt, "--pdb_path", path,
                "--out_folder", out, "--seed", "7", "--save_stats", "1",
                "--stats_format", "npz", "--device", "cuda", *extra]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        cli_entry(argv)
        torch.cuda.synchronize()
        dt = time.time() - t0
        counts = dict(LAUNCHES)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        stats = np.load(os.path.join(out, "stats", f"{name}.npz"))
        if not _fused_launches_ok(counts, 2 if mode == "score" else 0):
            raise AssertionError(f"{tag}: launches {counts} are not the fused "
                                 "route's (3 + 3 per encode, 3 per decoder)")
        if mode == "score":
            _check_finite(stats["log_probs"], (10, L, 33), "score log_probs")
            _check_finite(stats["unconditional_log_probs"], (L, 33), "uncond")
            if not np.allclose(np.exp(stats["log_probs"]).sum(-1), 1.0, atol=1e-4):
                raise AssertionError("score: probabilities do not sum to 1")
        else:
            B = {"specificity": 30, "symmetry": 2}.get(tag, 1)
            _check_finite(stats["log_probs"], (B, L, 33), f"{tag} log_probs")
            _check_finite(stats["sampling_probs"], (B, L, 33), f"{tag} probs")
            S = stats["generated_sequences"]
            if S.shape != (B, L) or S.min() < 0 or S.max() >= 33:
                raise AssertionError(f"{tag}: bad sequences {S.shape}")
            with open(os.path.join(out, "seqs", f"{name}.fa")) as f:
                if f.read().count(">") != B + 1:
                    raise AssertionError(f"{tag}: FASTA records missing")
            if mode == "specificity":
                spec = np.load(os.path.join(out, "specificity", "synthetic.npz"),
                               allow_pickle=True)
                _check_finite(spec["predicted_ppm"], (L, 33), "predicted_ppm")
            if tag == "symmetry":
                for tied in SYMMETRY[2]:
                    if not (S[:, list(tied)] == S[:, tied[:1]]).all():
                        raise AssertionError(f"symmetry: tied positions {tied} "
                                             f"differ: {S[:, list(tied)]}")
            if tag == "cif":
                ref = np.load(os.path.join(OUT, "design", "stats", "synthetic.npz"))
                if sorted(ref.files) != sorted(stats.files) or any(
                        ref[k].shape != stats[k].shape for k in ref.files) or not \
                        np.array_equal(ref["native_sequence"], stats["native_sequence"]):
                    raise AssertionError("cif: outputs differ from the PDB run's "
                                         "fields, shapes or native sequence")
        served = ("the mmCIF atom_site reader" if path.endswith(".cif")
                  else f"the {reader} PDB reader")
        print(f"main path {tag}: {dt:.2f} s, read by {served}, "
              f"launches {counts}", flush=True)
    return total


def _records_match(got, want):
    """True if two ``read_pdb_atoms`` results hold the same records (names,
    numbers, chains, codes, elements; coordinates within 1e-4; occupancy
    and B-factor within 1e-6, relative to the value where it is below 1)."""
    keys = ("record", "serial", "name", "altloc", "resname", "chain", "resnum",
            "icode", "element")

    def close(x, y):
        return abs(x - y) <= 1e-6 * min(1.0, abs(y))

    return len(got) == len(want) and all(
        all(getattr(a, k) == getattr(b, k) for k in keys)
        and np.abs(a.xyz - b.xyz).max() <= 1e-4
        and close(a.occupancy, b.occupancy) and close(a.bfactor, b.bfactor)
        for a, b in zip(got, want))


def _parsed_equal(a, b):
    """True if two ``parse_pdb`` results give the same model inputs bit for
    bit (the atom lists are compared as ``_records_match`` compares)."""
    if sorted(a) != sorted(b):
        return False
    for k in a:
        if k.endswith("_atoms"):
            flat = [[x] if hasattr(x, "xyz") else x for x in a[k]]
            want = [[x] if hasattr(x, "xyz") else x for x in b[k]]
            if not _records_match(sum(flat, []), sum(want, [])):
                return False
            continue
        pairs = zip(a[k], b[k]) if isinstance(a[k], list) else [(a[k], b[k])]
        if len(a[k]) != len(b[k]) or any(
                np.asarray(x).dtype != np.asarray(y).dtype
                or np.asarray(x).tobytes() != np.asarray(y).tobytes() for x, y in pairs):
            return False
    return True


def _parse_pdb_with(path, native):
    """``parse_pdb(path)`` with its records read by the native tokenizer
    (``native``) or by the pure-Python reader."""
    from na_mpnn_tpu_torch.data import pdb as pdb_mod

    orig = pdb_mod.read_pdb_atoms
    pdb_mod.read_pdb_atoms = lambda path, fmo=True, use_native=True: \
        orig(path, fmo, native)
    try:
        return pdb_mod.parse_pdb(path)
    finally:
        pdb_mod.read_pdb_atoms = orig


def host_reader_phase(pdb):
    """The host side of the data path, which the main path runs first: the
    native structure tokenizer (``native/na_parse.cc``, built with ``g++``
    at first use) — whether it built, where, in how many seconds, or the
    compiler's error; where it built, its records against the pure-Python
    reader's on the synthetic PDB and its gzipped copy, ``parse_pdb``'s
    features bitwise from both readers, and ms per read and per parse of
    each; ``utils/geometry.py`` on CUDA tensors against the CPU; topology
    and 1D features of every entry of the packaged residue library (no
    networkx on this machine)."""
    import gzip
    import shutil

    import torch
    from na_mpnn_tpu_torch.data import native_loader
    from na_mpnn_tpu_torch.data import pdb as pdb_mod
    from na_mpnn_tpu_torch.data.ligands import (MolFeaturizer, ResidueLibrary,
                                                get_topology)
    from na_mpnn_tpu_torch.utils import geometry

    t_phase = time.time()
    if native_loader.native_available():
        b = native_loader.BUILD
        reader = "native"
        print(f"host reader: native tokenizer built in {b['seconds']:.2f} s "
              f"(0 = found built) at {os.path.relpath(b['path'], ROOT)}", flush=True)
    else:
        reader = "python"
        print("host reader: the native tokenizer did not build; the pure-Python "
              f"reader serves. Error: {native_loader.BUILD['error']}", flush=True)
    gz = os.path.join(OUT, "synthetic.pdb.gz")
    with open(pdb, "rb") as f, gzip.open(gz, "wb") as g:
        shutil.copyfileobj(f, g)
    if reader == "native":
        for path in (pdb, gz):
            nat = pdb_mod.read_pdb_atoms(path)
            py = pdb_mod.read_pdb_atoms(path, use_native=False)
            if not nat or nat[0].line != "" or not _records_match(nat, py):
                raise AssertionError(f"native against Python records differ on {path}")
        orig = pdb_mod.read_pdb_atoms

        def parse(native):
            return _parse_pdb_with(pdb, native)

        if not _parsed_equal(parse(True), parse(False)):
            raise AssertionError("parse_pdb features differ between the native "
                                 "and the Python reader")
        # three rounds in turns (the host is shared), 30 calls each, so that
        # every reading carries its share of the garbage collector's full
        # passes (one per ~70,000 objects made); the median of each
        ms = {}
        for _ in range(3):
            for name, native in (("native", True), ("python", False)):
                for path in (pdb, gz):
                    ms.setdefault((name, path), []).append(_host_ms(
                        lambda: orig(path, use_native=native), 30))
                ms.setdefault((name, "parse"), []).append(
                    _host_ms(lambda: parse(native), 30))
        ms = {k: float(np.median(v)) for k, v in ms.items()}
        print(f"host reader: {len(nat)} records, native = Python (plain and .gz); "
              "parse_pdb features bitwise equal", flush=True)
        print(f"host reader ms per read of the 389-residue PDB (median of 3 rounds "
              f"in turns): native {ms['native', pdb]:.3f} (.gz {ms['native', gz]:.3f}), "
              f"Python {ms['python', pdb]:.3f} (.gz {ms['python', gz]:.3f}); per "
              f"parse_pdb: native {ms['native', 'parse']:.3f}, Python "
              f"{ms['python', 'parse']:.3f}", flush=True)

    rng = np.random.default_rng(0)
    pts = [rng.standard_normal((8, 768, 3)).astype(np.float32) * 3 for _ in range(4)]
    worst = {}
    for name, n in (("get_ang", 3), ("get_dih", 4), ("get_frames", 3), ("triple_prod", 3)):
        fn = getattr(geometry, name)
        cpu = fn(*[torch.from_numpy(p) for p in pts[:n]])
        dev = fn(*[torch.from_numpy(p).cuda() for p in pts[:n]])
        if not (dev.is_cuda and dev.dtype == torch.float32 and dev.shape == cpu.shape):
            raise AssertionError(f"{name}: {dev.device}, {dev.dtype}, {tuple(dev.shape)}")
        worst[name] = float((dev.cpu() - cpu).abs().max())
        if not worst[name] < 1e-4:
            raise AssertionError(f"{name}: cuda against cpu max |d| {worst[name]:.3g}")
    print("host geometry (B=8 x L=768, fp32) cuda against cpu, max |d| (< 1e-4): "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()), flush=True)

    t0 = time.time()
    lib, feat = ResidueLibrary.standard(), MolFeaturizer()
    n_bonds = 0
    for name, raw in lib._raw.items():
        topo = get_topology(raw)
        f1d, emb = feat.features_1d(raw), feat.embed_features_1d(raw)
        n = len(raw["atoms"])
        if (len(topo["bonds"]) != len(raw["bonds"]) or f1d.shape != (n, 4)
                or emb.shape != (n, feat.num_features_1d())
                or not np.isfinite(topo["bondlen"]).all()):
            raise AssertionError(f"residue library entry {name}: bad topology or features")
        n_bonds += len(topo["bonds"])
    print(f"host ligands: topology and 1D features of {len(lib._raw)} packaged "
          f"entries ({n_bonds} bonds) in {time.time() - t0:.2f} s", flush=True)
    print(f"host reader phase: {time.time() - t_phase:.1f} s; PDB input is read "
          f"by the {reader} reader", flush=True)


def _host_ms(fn, iters):
    """Mean ms per call by the host clock, each call ending in a synchronise
    (after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def breakdown_phase(pdb):
    """Where a design and a score call spend their time at the main path's
    shape: encode (the three kernels and the trunk around them), the
    autoregressive sampler, teacher-forced scoring of 10 samples and the
    unconditional probs. Host clock around synchronised calls."""
    import torch
    from na_mpnn_tpu_torch.data.featurize import featurize_inference
    from na_mpnn_tpu_torch.data.pdb import parse_pdb
    from na_mpnn_tpu_torch.models import (encode, init_params, sample, score,
                                          unconditional_probs)
    from na_mpnn_tpu_torch.models.config import ModelConfig

    dev = torch.device("cuda")
    cfg = ModelConfig()
    params = init_params(0, cfg, device=dev)
    parsed = parse_pdb(pdb)
    L = len(parsed["S"])
    batch = featurize_inference(parsed, np.ones(L, np.int32), device=dev)
    tiled = {k: v.repeat_interleave(10, 0) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = {
        "encode_B1": _host_ms(lambda: encode(params, cfg, batch), 10),
        "sample_B1": _host_ms(lambda: sample(params, cfg, batch, gen,
                                             num_samples=1), 2),
        "sample_B30": _host_ms(lambda: sample(params, cfg, batch, gen,
                                              num_samples=30, temperature=0.6), 1),
        "score_B10": _host_ms(lambda: score(params, cfg, tiled, generator=gen), 5),
        "unconditional_B1": _host_ms(lambda: unconditional_probs(params, cfg, batch), 5),
    }
    step = (ms["sample_B1"] - ms["encode_B1"]) / L
    print(f"breakdown L={L}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
          + f"; sampler {step:.3f} ms per decode step at B=1", flush=True)


def _fused_profile_keys(H):
    """The fused layer updates' kernels by their names in a profile, at
    width H: row 11's two launches (the message walk with its fp32 K-sum
    epilogue, the tail) and row 12's walk (the LayerNorm epilogue), the
    walk's template arguments read from ``csrc/message_tile.cuh``."""
    import re
    src = open(os.path.join(ROOT, "na_mpnn_tpu_torch", "csrc", "message_tile.cuh")).read()
    epi = {}
    for name in ("kEpiSumF32", "kEpiEdgeLN"):
        m = re.search(rf"\b{name} = (\d+)", src)
        if m is None:
            raise AssertionError(f"message_tile.cuh: no epilogue constant {name}")
        epi[name] = int(m.group(1))
    return {"row 11 message sum": f"fused_message_kernel<{H}, {epi['kEpiSumF32']},",
            "row 11 tail": f"node_tail_kernel<{H},",
            "row 12": f"fused_message_kernel<{H}, {epi['kEpiEdgeLN']},"}


def _profile_call(fn, name, tag):
    """One call of ``fn``, which runs the fused route at H = 128, under
    ``torch.profiler`` (CPU and CUDA activity, after a warm-up call, ending
    in a synchronise), its Chrome trace written to
    ``build/chip_smoke/<name>.json``: prints the window, the device-busy
    time and share, the top device operations, and the device ms and share
    of busy time of rows 11 and 12 (``_fused_profile_keys``), failing when
    one of them has no launch in the trace, and the kNN's device ms (which
    must be there too). Returns the device ms of each
    of those groups."""
    import torch
    fn()
    torch.cuda.synchronize()
    window, busy, by_name = _traced(fn, name, 1)
    print(f"{tag} profile (torch.profiler, one call): window {window:.3f} ms, device "
          f"busy {busy:.3f} ms ({100 * busy / window:.1f}%), idle "
          f"{100 * (1 - busy / window):.1f}%; top device operations:", flush=True)
    for op, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 1e3:8.3f} ms  {n:4d}x  {op[:90]}", flush=True)
    groups = {}
    for group, key in _fused_profile_keys(128).items():
        hits = [(n, us) for op, (n, us) in by_name.items() if key in op]
        if not hits:
            raise AssertionError(f"{tag} profile: no {group} kernel ({key!r}) in the trace")
        groups[group] = sum(us for _, us in hits) / 1e3
        print(f"  {tag} {group}: {groups[group]:.3f} ms over {sum(n for n, _ in hits)} "
              f"launches, {100 * groups[group] / busy:.1f}% of device busy", flush=True)
    hits = [(n, us) for op, (n, us) in by_name.items() if "knn_kernel" in op]
    if not hits:
        raise AssertionError(f"{tag} profile: no knn_kernel in the trace")
    knn_ms = sum(us for _, us in hits) / 1e3
    print(f"  {tag} kNN: {knn_ms:.4f} ms over {sum(n for n, _ in hits)} launches, "
          f"{100 * knn_ms / busy:.1f}% of device busy", flush=True)
    return groups


def fused_vs_table_phase(pdb):
    """Encode at B=1 and score at B=10 (host clock, synchronised) on the
    fused route, and in turns the same calls with every layer sent to the
    message-table route (the route of layers with dropout or a gradient,
    here under no gradient; the decoder's gathered route, which such layers
    take at L % 32 != 0 on one device, is turned off too), fused / table /
    table / fused; the two routes' score log-probs within 1e-4. Returns the
    launches of the first fused pair of calls."""
    import torch
    from na_mpnn_tpu_torch.data.featurize import featurize_inference
    from na_mpnn_tpu_torch.data.pdb import parse_pdb
    from na_mpnn_tpu_torch.models import encode, init_params, mpnn, score
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.ops import LAUNCHES, message_kernels, reset_launches

    cfg = ModelConfig()
    params = init_params(0, cfg, device="cuda")
    parsed = parse_pdb(pdb)
    L = len(parsed["S"])
    batch = featurize_inference(parsed, np.ones(L, np.int32), device="cuda")
    tiled = {k: v.repeat_interleave(10, 0) for k, v in batch.items()}
    order = torch.stack([torch.randperm(L, generator=torch.Generator().manual_seed(i))
                         for i in range(10)]).to("cuda")
    fused_route = mpnn.fused_route
    table_gather_ok = message_kernels.table_gather_ok

    def calls():
        encode(params, cfg, batch)
        return score(params, cfg, tiled, decoding_order=order)["log_probs"]

    def run(route):
        if route == "table":
            mpnn.fused_route = lambda *a: False
            message_kernels.table_gather_ok = lambda L: True
        try:
            torch.cuda.synchronize()
            reset_launches()
            lp = calls()
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            ms = (_host_ms(lambda: encode(params, cfg, batch), 10),
                  _host_ms(lambda: score(params, cfg, tiled, decoding_order=order), 5))
        finally:
            mpnn.fused_route = fused_route
            message_kernels.table_gather_ok = table_gather_ok
        return lp, counts, ms

    res = [run(r) for r in ("fused", "table", "table", "fused")]
    for (lp, counts, _), route in zip(res, ("fused", "table", "table", "fused")):
        fused = _fused_launches_ok(counts, 1)
        table = (counts.get("message_table_enc_node") == 6
                 and counts.get("message_table_dec") == 3
                 and not any(k.startswith("fused") for k in counts))
        if not (fused if route == "fused" else table):
            raise AssertionError(f"{route} route: launches {counts}")
    d = float((res[0][0] - res[1][0]).abs().max())
    if not d < 1e-4:
        raise AssertionError(f"fused vs table route: max |d log p| {d:.3g}")
    f_ms = [res[0][2], res[3][2]]
    t_ms = [res[1][2], res[2][2]]
    print(f"fused vs table route L={L} (host clock, synchronised; in turns "
          f"fused/table/table/fused): encode B=1 fused "
          f"{f_ms[0][0]:.3f}, {f_ms[1][0]:.3f} ms vs table {t_ms[0][0]:.3f}, "
          f"{t_ms[1][0]:.3f} ms; score B=10 fused {f_ms[0][1]:.3f}, "
          f"{f_ms[1][1]:.3f} ms vs table {t_ms[0][1]:.3f}, {t_ms[1][1]:.3f} ms; "
          f"score log-probs of the two routes max |d| {d:.3g} (< 1e-4)",
          flush=True)
    _profile_call(lambda: encode(params, cfg, batch), "encode_profile",
                  f"encode B=1 L={L} fp32 (fused route)")
    _profile_call(lambda: score(params, cfg, tiled, decoding_order=order),
                  "score_profile", f"score B=10 L={L} fp32 (fused route)")
    return res[0][1]


BATCH_LENGTHS = (165, 170, 260, 270, 390)


def batch_design_phase():
    """``eval.batch_design`` on the card at full width: 5 synthetic
    protein-DNA PDBs of 165-390 residues, ``--bucket 16`` and 2 structures
    per group (groups padded to 176, 272 and 400 rows, none a multiple of
    32; the last group holds a dummy row), design (1 sample) and
    specificity (30 samples, T = 0.6); checks the FASTA records, the PPMs
    and the fused route's launches (one encode per group). Returns the
    launches."""
    import torch
    from na_mpnn_tpu_torch.eval.batch_design import main as batch_design
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches

    folder = os.path.join(OUT, "batch")
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, n in enumerate(BATCH_LENGTHS):
        d = 20 + 2 * i
        paths.append(os.path.join(folder, f"b{i}.pdb"))
        write_synthetic_pdb(paths[-1], (("A", "protein", n - 2 * d), ("B", "dna", d),
                                        ("C", "dna", d)), seed=30 + i)
    csv_path = os.path.join(folder, "structures.csv")
    with open(csv_path, "w") as f:
        f.write("structure_path\n" + "\n".join(paths) + "\n")
    ckpt = os.path.join(OUT, "random_weights.npz")
    total = {}
    for mode, extra in (("design", ["--samples", "1"]),
                        ("specificity", ["--samples", "30", "--temperature", "0.6"])):
        out = os.path.join(folder, mode)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        batch_design(["--csv", csv_path, "--checkpoint", ckpt, "--out_folder", out,
                      "--mode", mode, "--bucket", "16", "--batch_structures", "2",
                      "--seed", "5", "--device", "cuda", *extra])
        torch.cuda.synchronize()
        dt = time.time() - t0
        counts = dict(LAUNCHES)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if not (counts.get("knn") == 3 and _fused_launches_ok(counts, 0)):
            raise AssertionError(f"batch {mode}: launches {counts}, want the fused "
                                 "route and one encode per group (3)")
        for i, n in enumerate(BATCH_LENGTHS):
            if mode == "design":
                with open(os.path.join(out, "seqs", f"b{i}.fa")) as f:
                    lines = f.read().splitlines()
                if len(lines) != 4 or len(lines[3].replace("/", "")) != n:
                    raise AssertionError(f"batch design b{i}: FASTA {lines[::2]}")
            else:
                ppm = np.load(os.path.join(out, "specificity", f"b{i}.npz"))["predicted_ppm"]
                _check_finite(ppm, (n, 33), f"batch specificity b{i}")
        print(f"batch {mode} (5 structures of {min(BATCH_LENGTHS)}-{max(BATCH_LENGTHS)} "
              f"residues, bucket 16, 2 per group): {dt:.2f} s, "
              f"{dt / len(BATCH_LENGTHS):.3f} s per structure, launches {counts}",
              flush=True)
    return total


def _eval_call(tag, fn, n_structures, total):
    """Run one evaluation entry point on the card with the launches counted
    from zero; print its seconds per structure; add its launches to
    ``total``. Returns (result, launches)."""
    import torch
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = dict(LAUNCHES)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    print(f"eval {tag}: {dt:.2f} s, {dt / n_structures:.3f} s per structure "
          f"(each call loads its checkpoint and featurises again), launches "
          f"{counts}", flush=True)
    return out, counts


def eval_phase(pdb, L):
    """The evaluation path (``cli/sweep.py``, ``eval/harness.py``) on the card
    at the released width: random full-width weights written as
    ``s_1000.npz`` and, through the ``.pt`` export, as ``s_2000.pt``;
    ``run_sweep`` over both in score mode (10 decode orders) and design mode
    (10 samples at T = 0.1), one seed: in each mode the two rows must be
    bitwise equal; ``predict_nucleic_acid_ppm`` (30 samples at T = 0.6) and
    ``score_specificity_prediction`` against a PPM CSV written for DNA chain
    C (a finite Pearson correlation). Every call takes the fused route, and
    rows 1, 3, 11 and 12 must be launched. Returns the launches."""
    import shutil

    from na_mpnn_tpu_torch import constants
    from na_mpnn_tpu_torch.cli.sweep import run_sweep
    from na_mpnn_tpu_torch.eval.harness import (predict_nucleic_acid_ppm,
                                                score_specificity_prediction)
    from na_mpnn_tpu_torch.models import init_params
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.params import save_checkpoint_npz, save_torch_checkpoint

    folder = os.path.join(OUT, "eval")
    shutil.rmtree(folder, ignore_errors=True)
    ckpts = os.path.join(folder, "ckpts")
    os.makedirs(ckpts)
    params = init_params(11, ModelConfig(), device="cpu")
    save_checkpoint_npz(os.path.join(ckpts, "s_1000.npz"), params, meta={"step": 1000})
    save_torch_checkpoint(os.path.join(ckpts, "s_2000.pt"), params, ModelConfig(),
                          meta={"step": 2000})
    csv_path = os.path.join(folder, "structures.csv")
    with open(csv_path, "w") as f:
        f.write(f"structure_path\n{pdb}\n")
    total = {}
    # per CLI call: score encodes twice (score, unconditional probs) and runs
    # two parallel decoders; design encodes once and samples
    for mode, extra, n_enc, n_dec in (("score", {}, 2, 2),
                                      ("design", {"temperature": 0.1}, 1, 0)):
        res, counts = _eval_call(
            f"run_sweep {mode} (2 checkpoints x 1 structure, 10 samples, padded "
            f"to 64)", lambda: run_sweep(
                ckpts, csv_path, mode, num_samples=10, seed=7, device="cuda",
                workdir=os.path.join(folder, f"sweep_{mode}"),
                out=os.path.join(folder, f"sweep_{mode}.json"), **extra), 2, total)
        rows = [dict(r) for r in res["table"]]
        names = [os.path.basename(r.pop("checkpoint")) for r in rows]
        if names != ["s_1000.npz", "s_2000.pt"] or rows[0] != rows[1] or \
                not np.isfinite(rows[0]["value"]):
            raise AssertionError(f"sweep {mode}: the .npz and .pt rows differ or "
                                 f"are not finite: {res['table']}")
        if not (counts.get("knn") == 2 * n_enc and _fused_launches_ok(counts, 2 * n_dec)):
            raise AssertionError(f"sweep {mode}: launches {counts}, want the fused "
                                 f"route and {n_enc} encode(s) per call (2 calls)")
        print(f"eval sweep {mode}: .npz and .pt rows bitwise equal: {rows[0]}",
              flush=True)

    npz = os.path.join(ckpts, "s_1000.npz")
    subject, counts = _eval_call(
        "predict_nucleic_acid_ppm (30 samples, T = 0.6)",
        lambda: predict_nucleic_acid_ppm(pdb, os.path.join(folder, "spec"), 30, 0.6,
                                         na_mpnn_model_path=npz, seed=7,
                                         device="cuda"), 1, total)
    if not (counts.get("knn") == 1 and _fused_launches_ok(counts, 0)):
        raise AssertionError(f"predict_nucleic_acid_ppm: launches {counts}")
    with open(subject) as f:
        spec = json.load(f)
    _check_finite(spec["predicted_ppm_na_mpnn_format"], (L, 33), "eval predicted PPM")
    # a motif on 10 bases of DNA chain C: 0.85 on the native base
    chain = np.asarray(spec["chain_labels"])
    true_seq = np.asarray(spec["true_sequence_na_mpnn_format"])
    c_rows = np.flatnonzero(chain == np.unique(chain)[2])[10:20]
    t = constants.restype_to_int_table(True)
    ppm = np.full((len(c_rows), 4), 0.05)
    ppm[np.arange(len(c_rows)), true_seq[c_rows] - t["DA"]] = 0.85
    ppm_csv = os.path.join(folder, "chain_c_ppm.csv")
    with open(ppm_csv, "w") as f:
        f.write("A,C,G,T\n" + "".join(",".join(f"{v:.2f}" for v in r) + "\n"
                                      for r in ppm))
    t0 = time.time()
    scored = score_specificity_prediction(f"[['{ppm_csv}']]", subject,
                                          os.path.join(folder, "scores"))
    with open(scored) as f:
        result = json.load(f)
    if not np.isfinite(result["pearson_dna"]):
        raise AssertionError(f"score_specificity_prediction: pearson_dna "
                             f"{result['pearson_dna']}")
    print(f"eval score_specificity_prediction: {time.time() - t0:.3f} s per "
          f"structure (host, numpy); pearson_dna {result['pearson_dna']:.4f}, "
          f"alignment score {result['alignment_score_dna']:.4f} over "
          f"{result['aligned_dna_length']} positions", flush=True)
    for name in ("knn", "rbf_classed", "fused_node_update_enc", "fused_edge_update",
                 "fused_node_update_dec"):
        if total.get(name, 0) < 1:
            raise AssertionError(f"eval phase: {name} never launched ({total})")
    return total


def _score_and_uncond(cfg, params, batch):
    import torch
    from na_mpnn_tpu_torch.models import score, unconditional_probs
    dev = batch["X"].device
    order = torch.arange(batch["X"].shape[1], device=dev)[None]
    return (score(params, cfg, batch, decoding_order=order)["log_probs"],
            unconditional_probs(params, cfg, batch)["log_probs"])


def reference_check_phase(pdb):
    """Score and unconditional probs with the kernels against the plain path
    (``kernels="torch"``), log-probs within 1e-4: on the card at the main
    path's structure padded to 416 rows (masked rows and pairs, m1d = 0 in
    the decoder), and against the CPU on a small structure."""
    import dataclasses

    import torch
    from na_mpnn_tpu_torch.data.featurize import featurize_inference
    from na_mpnn_tpu_torch.data.pdb import parse_pdb
    from na_mpnn_tpu_torch.models import init_params
    from na_mpnn_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig()
    plain_cfg = dataclasses.replace(cfg, kernels="torch")
    parsed = parse_pdb(pdb)
    L = len(parsed["S"])
    batch = featurize_inference(parsed, np.ones(L, np.int32), pad_to=416,
                                device="cuda")
    params = init_params(2, cfg, device="cuda")
    outs = (_score_and_uncond(cfg, params, batch),
            _score_and_uncond(plain_cfg, params, batch))
    worst = max(float((a[0, :L] - b[0, :L]).abs().max()) for a, b in zip(*outs))
    if not worst < 1e-4:
        raise AssertionError(f"kernels vs plain on the card: max |d log p| {worst:.3g}")
    print(f"reference check L={L} padded to 416: kernels vs plain (both cuda) "
          f"max |d log p| = {worst:.3g} (< 1e-4)", flush=True)

    small = os.path.join(OUT, "small.pdb")
    write_synthetic_pdb(small, (("A", "protein", 40), ("B", "dna", 14),
                                ("C", "rna", 10)), seed=5)
    parsed = parse_pdb(small)
    outs = {}
    for dev in ("cuda", "cpu"):
        batch = featurize_inference(parsed, np.ones(len(parsed["S"]), np.int32),
                                    device=dev)
        outs[dev] = _score_and_uncond(cfg, init_params(2, cfg, device=dev), batch)
    worst = max(float((a.cpu() - b).abs().max())
                for a, b in zip(outs["cuda"], outs["cpu"]))
    if not worst < 1e-4:
        raise AssertionError(f"kernel path vs plain path: max |d log p| {worst:.3g}")
    print(f"reference check L={len(parsed['S'])}: kernels (cuda) vs plain (cpu) "
          f"max |d log p| = {worst:.3g} (< 1e-4)", flush=True)


TRAIN_STRUCTURES = 8
TRAIN_KEYS = ("X", "X_m", "mask", "S", "R_idx", "chain_labels", "protein_mask",
              "dna_mask", "rna_mask", "R_polymer_type")
MODES = ("enc_node", "enc_edge", "dec")


def training_batch():
    """8 synthetic protein-DNA structures of 600-768 residues, parsed and
    collated to the 768 bucket (the reference regime of about 6000 tokens)."""
    from na_mpnn_tpu_torch.data.pdb import parse_pdb
    from na_mpnn_tpu_torch.train.collate import collate_batch
    structs = []
    for i in range(TRAIN_STRUCTURES):
        n = 600 + 24 * i
        n_dna = 40 + 2 * i
        chains = (("A", "protein", (n - 2 * n_dna) // 2),
                  ("B", "protein", n - 2 * n_dna - (n - 2 * n_dna) // 2),
                  ("C", "dna", n_dna), ("D", "dna", n_dna))
        path = os.path.join(OUT, f"train{i}.pdb")
        write_synthetic_pdb(path, chains, seed=10 + i)
        parsed = parse_pdb(path)
        structs.append({k: parsed[k] for k in TRAIN_KEYS})
    batch = collate_batch(structs)
    if batch["S"].shape != (TRAIN_STRUCTURES, 768):
        raise AssertionError(f"training batch {batch['S'].shape}, want (8, 768)")
    return batch


def _bwd_bound(mode, N, K, H, C, g_rows, esize=4, peak=PEAK_FP32_FLOPS):
    """Least work of the message-table backward: per edge the recomputed W2
    product, dW2, g_x, g_ein and dWb (10 H^2), in enc_edge also dW3 and
    g_m@W3^T (14 H^2), and about 40 H elementwise (GELU and its derivative);
    per node g_hV and dWa, and in the summing modes (g/30)@W3^T and dW3 too,
    since g_m is a per-node vector times a mask (8 H^2). Bytes: h_V, e_in,
    x, g, masks and indices read once; g_hV, g_ein, the table gradient and
    the weight gradients written once, ``esize`` bytes per float element."""
    per_edge = 14 if mode == "enc_edge" else 10
    per_node = 4 if mode == "enc_edge" else 8
    ops = N * K * (per_edge * H * H + 40 * H) + N * per_node * H * H
    nbytes = (esize * (N * H + 3 * N * K * H + g_rows * H + 2 * N * K + N * H
                       + N * C + 4 * H * H + H + 4 * H * H + 3 * H) + 8 * N * K)
    return _bound_ms(ops, nbytes, peak)


# The times of rows 3-10 in their earlier scalar-FMA form, from PERF.md's
# kernel table (chip_smoke on an NVIDIA H100 80GB HBM3, 700 W; at the
# training shape, row 3 also at B=1 x L=389, row 9 with x, rows 5 and 6
# bf16 also for the 192-row shard, rows 7 and 8 at N = 6000 in the
# decoder's variant): reference values printed beside this run's times,
# never part of the kernels JSON line.
SCALAR_MS = {"rbf_edge": 14.9462, "rbf_edge_bf16": 14.9361, "rbf_edge_dw": 18.1993,
             "rbf_edge_dw_bf16": 18.9127, "rbf_edge_bf16_shard": 3.7499,
             "rbf_edge_dw_bf16_shard": 4.8752,
             "rbf_classed_dw": 8.8538, "rbf_classed_dw_bf16": 11.9795,
             "message_table_bwd_enc_node": 3.7350, "message_table_bwd_enc_edge": 3.6429,
             "message_table_bwd_dec": 3.8073, "message_table_bwd_enc_node_bf16": 3.8616,
             "message_table_bwd_enc_edge_bf16": 3.8230,
             "message_table_bwd_dec_bf16": 3.9768,
             "rbf_classed": 4.1096, "rbf_classed_bf16": 5.1675, "rbf_classed_B1": 1.3518,
             "message_table_enc_node": 0.7693, "message_table_enc_edge": 0.8056,
             "message_table_dec": 0.7934, "message_table_enc_node_bf16": 0.7605,
             "message_table_enc_edge_bf16": 0.7961, "message_table_dec_bf16": 0.7793,
             # rows 7 / 8 at N = 6000 by (contract_e, aggregate), forward / backward
             "message_mlp_01": (0.5043, 2.8953), "message_mlp_bf16_01": (0.5076, 2.5890)}


def _launch_bytes(fn):
    """``fn()`` and the bytes of scratch it allocated: its peak beyond what
    was allocated before, less its outputs."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    outs = out if isinstance(out, (tuple, list)) else (out,)
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    return out, torch.cuda.max_memory_allocated() - base - out_bytes


def _print_edge_groups(X_aug, X_m_aug, E_idx):
    """The RBF weight gradient's per-edge groups on these operands: edges
    per group (PP, PN, NP, NN), those with a residue in both blocks, and the
    rows x edges the kernel multiplies against all four tables for all."""
    import torch
    from na_mpnn_tpu_torch.ops import rbf_common
    _, Mq, _, Mk, nbr = rbf_common.edge_operands(X_aug, X_m_aug, E_idx, None, None)
    K = E_idx.shape[2]
    counts = rbf_common.edge_groups(Mq, Mk, nbr, K).sum(1).tolist()
    edge_node = torch.arange(nbr.shape[0], device=nbr.device) // K
    sq = rbf_common.residue_sides(Mq)[edge_node]
    mixed = int(((sq == 2) | (rbf_common.residue_sides(Mk)[nbr] == 2)).sum())
    rows = [16 * len(q) * len(n) for q, n in rbf_common.GROUP_SELS]
    work = sum(c * r for c, r in zip(counts, rows))
    print(f"rbf_classed_dw edge groups (E={nbr.shape[0]}): PP {counts[0]}, PN "
          f"{counts[1]}, NP {counts[2]}, NN {counts[3]}, with a residue in both "
          f"blocks {mixed}; rows x edges {work} ({work / (nbr.shape[0] * 5184):.3f} "
          f"of all four tables for every edge)", flush=True)


def _table_fwd_bitwise(tag, args, out_k, x_k, **kw):
    """The message-table forward's outputs bitwise the same in a second
    launch, and its output without x the same as with x."""
    import torch
    from na_mpnn_tpu_torch.ops import message_kernels as mk
    out2, x2 = mk.message_table_cuda(*args, save_x=True, **kw)
    if not (torch.equal(out_k, out2) and torch.equal(x_k, x2)):
        raise AssertionError(f"{tag}: two launches differ")
    if not torch.equal(out_k, mk.message_table_cuda(*args, **kw)):
        raise AssertionError(f"{tag}: the output without x differs from the one with x")


def _check_edge_codes(X_aug, X_m_aug, E_idx):
    """The classed RBF forward's per-edge lists on the card: its classify
    kernel's code of every edge equal to the plain ``edge_list_codes``;
    prints the edges of each list and the kernels' shared memory."""
    import torch
    from na_mpnn_tpu_torch.ops import rbf_common
    from na_mpnn_tpu_torch.ops._build import library
    _, Mq, _, Mk, nbr = rbf_common.edge_operands(X_aug, X_m_aug, E_idx, None, None)
    K = E_idx.shape[2]
    code = rbf_common.edge_list_codes_cuda(Mq, Mk, nbr, K)
    if not torch.equal(code, rbf_common.edge_list_codes(Mq, Mk, nbr, K)):
        raise AssertionError("rbf_classed classify: codes differ from edge_list_codes")
    counts = torch.bincount(code, minlength=5).tolist()
    rc, mt = library("rbf_classed"), library("message_table")
    print(f"rbf_classed lists (E={nbr.numel()}): PP {counts[0]}, PN {counts[1]}, "
          f"NP {counts[2]}, NN {counts[3]}, several groups {counts[4]}; classify "
          f"kernel's codes equal the plain ones; dynamic shared memory per block "
          f"(H = 128): rbf_classed fp32 {rc.rbf_classed_forward_smem(128, 0)} B, "
          f"bf16 {rc.rbf_classed_forward_smem(128, 1)} B; message_table fp32 "
          f"{mt.message_table_forward_smem(128, 128, 0)} B (dec "
          f"{mt.message_table_forward_smem(128, 256, 0)} B), bf16 "
          f"{mt.message_table_forward_smem(128, 128, 1)} B (dec "
          f"{mt.message_table_forward_smem(128, 256, 1)} B)", flush=True)


def train_kernel_phase(nb):
    """The training kernels against their plain versions on the card at
    the training shape, and the forward kernels' times there; returns the
    rows of the new kernels and the forward kernels' ms at this shape."""
    import torch
    from na_mpnn_tpu_torch.models import init_params
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.models.features import build_augmented_atoms
    from na_mpnn_tpu_torch.ops import knn, message_kernels as mk, rbf_classed
    from na_mpnn_tpu_torch.train.trainer import to_device

    dev = torch.device("cuda")
    cfg = ModelConfig()
    H, K = cfg.hidden_dim, cfg.k_neighbors
    batch = to_device(nb, dev)
    X_aug, X_m_aug, X_ref = build_augmented_atoms(
        batch["X"], batch["X_m"], batch, cfg)
    mask = batch["mask"].float()
    B, L = mask.shape
    N = B * L
    D_k, E_idx = knn.knn_graph_cuda(X_ref, mask, K)
    D_p, E_p = knn.knn_graph_plain(X_ref, mask, K)
    if not (torch.equal(E_idx, E_p) and torch.equal(D_k, D_p)):
        raise AssertionError("knn at the training shape: E_idx or D differs")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, fwd_ms = {}, {}

    def forward_row(name, kernel, plain, bound, iters, checked):
        fwd_ms[name] = _sync_time(kernel, iters)
        plain_ms = _sync_time(plain, 2)
        print(f"{name} at the training shape: {checked}, {fwd_ms[name]:.4f} ms "
              f"(plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]})",
              flush=True)

    forward_row("knn", lambda: knn.knn_graph_cuda(X_ref, mask, K),
                lambda: knn.knn_graph_plain(X_ref, mask, K),
                _knn_bound(B, L, K), 10, "E_idx and D exact")
    D_adj = knn.masked_distances(X_ref, X_ref, mask, mask)
    topk_ms = _sync_time(lambda: torch.topk(D_adj, K, dim=-1, largest=False), 10)
    print(f"knn selection alone by a library call at the training shape: "
          f"torch.topk(D_adjust, {K}, largest=False) on the prebuilt [{B}, {L}, {L}] "
          f"matrix {topk_ms:.4f} ms (the distances built beforehand: not a "
          f"one-call counterpart of the kernel)", flush=True)
    del D_adj
    params = init_params(1, cfg, device=dev)
    W = params["features"]["edge_embedding"]["w"][cfg.num_positional_embeddings:]
    out_k = rbf_classed.rbf_edge_features_classed_cuda(X_aug, X_m_aug, E_idx, W)
    rel = _rel_err(out_k, rbf_classed.rbf_edge_features_classed_plain(X_aug, X_m_aug, E_idx, W))
    if not rel < REL_TOL:
        raise AssertionError(f"rbf_classed at the training shape: relative error {rel:.3g}")
    if not torch.equal(out_k, rbf_classed.rbf_edge_features_classed_cuda(
            X_aug, X_m_aug, E_idx, W)):
        raise AssertionError("rbf_classed at the training shape: two launches differ")
    del out_k
    _check_edge_codes(X_aug, X_m_aug, E_idx)
    forward_row("rbf_classed",
                lambda: rbf_classed.rbf_edge_features_classed_cuda(X_aug, X_m_aug, E_idx, W),
                lambda: rbf_classed.rbf_edge_features_classed_plain(X_aug, X_m_aug, E_idx, W),
                _rbf_bound(X_aug, X_m_aug, E_idx, H), 5,
                f"rel err {rel:.3g} (< {REL_TOL}), two launches bitwise equal "
                f"(scalar-FMA form, PERF.md: {SCALAR_MS['rbf_classed']} ms)")

    # RBF weight gradient (row 4)
    _print_edge_groups(X_aug, X_m_aug, E_idx)
    g = torch.randn((B, L, K, H), generator=gen, device=dev)
    dw_k, extra = _launch_bytes(
        lambda: rbf_classed.rbf_classed_dw_cuda(X_aug, X_m_aug, E_idx, g))
    dw_k2 = rbf_classed.rbf_classed_dw_cuda(X_aug, X_m_aug, E_idx, g)
    dw_p = rbf_classed.rbf_classed_dw_plain(X_aug, X_m_aug, E_idx, g)
    rel = _rel_err(dw_k, dw_p)
    if not rel < 1e-4:
        raise AssertionError(f"rbf_classed_dw: relative error {rel:.3g}")
    if not torch.equal(dw_k, dw_k2):
        raise AssertionError("rbf_classed_dw: two launches differ")
    ms = _sync_time(lambda: rbf_classed.rbf_classed_dw_cuda(X_aug, X_m_aug, E_idx, g), 5)
    plain_ms = _sync_time(lambda: rbf_classed.rbf_classed_dw_plain(
        X_aug, X_m_aug, E_idx, g), 2)
    bound = _rbf_bound(X_aug, X_m_aug, E_idx, H)
    print(f"rbf_classed_dw B={B} L={L} K={K}: rel err {rel:.3g} (< 1e-4), "
          f"two launches bitwise equal, {ms:.4f} ms (scalar-FMA form, PERF.md: "
          f"{SCALAR_MS['rbf_classed_dw']} ms; plain {plain_ms:.4f} ms, bound "
          f"{bound[0]:.5f} ms); {extra / 2**20:.1f} "
          f"MiB of scratch per launch", flush=True)
    rows["rbf_classed_dw"] = dict(max_abs_err=float((dw_k - dw_p).abs().max()),
                                  ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                                  bound_by=bound[1])
    del dw_p, g

    # Message table: forward with the saved x (row 9), backward (row 10)
    eidx2 = E_idx.reshape(-1).contiguous()
    h_V2 = torch.randn((N, H), generator=gen, device=dev)
    h_E2 = torch.randn((N * K, H), generator=gen, device=dev)
    m_att = (torch.rand((N * K,), generator=gen, device=dev) > 0.1).float()
    m1d = (torch.rand((N * K,), generator=gen, device=dev) > 0.2).float()
    mbw = m1d * (torch.rand((N * K,), generator=gen, device=dev) > 0.5).float()
    ones = torch.ones_like(m_att)
    names = ("g_hV", "g_ein", "g_table", "dwa", "dwb", "db1", "dw2", "db2",
             "dw3", "db3")
    # the table order, as a stack sorts it once for its layers (two sorts
    # per one-device step: encoder and decoder); timed on its own, outside
    # row 10's ms
    order = mk.table_order(eidx2, K, L, L, N)
    order_ms = _sync_time(lambda: mk.table_order(eidx2, K, L, L, N), 10)
    print(f"table order (torch.argsort + searchsorted, E={N * K}): {order_ms:.4f} "
          f"ms per sort, 2 per one-device training step, not in row 10's ms",
          flush=True)
    for mode, ma, mb in (("enc_node", m_att, ones), ("enc_edge", ones, ones),
                         ("dec", m1d, mbw)):
        C = 2 * H if mode == "dec" else H
        table = torch.randn((N, C), generator=gen, device=dev)
        wa, wb, w2, w3 = (torch.randn((H, H), generator=gen, device=dev) / H ** 0.5
                          for _ in range(4))
        b1, b2, b3 = (torch.randn((H,), generator=gen, device=dev) for _ in range(3))
        args = (mode, h_V2, h_E2, table, eidx2, ma, mb, wa, wb, b1, w2, b2, w3, b3)
        out_k, x_k = mk.message_table_cuda(*args, K=K, L=L, save_x=True)
        out_p, x_p = mk.message_table_plain(*args, K=K, L=L, save_x=True)
        fwd_err = {}
        for what, a, b in (("out", out_k, out_p), ("x", x_k, x_p)):
            fwd_err[what] = _rel_err(a, b)
            if not fwd_err[what] < REL_TOL:
                raise AssertionError(f"message_table {mode} {what}: "
                                     f"rel err {fwd_err[what]:.3g}")
        _table_fwd_bitwise(f"message_table {mode}", args, out_k, x_k, K=K, L=L)
        forward_row(f"message_table_{mode}",
                    lambda: mk.message_table_cuda(*args, K=K, L=L, save_x=True),
                    lambda: mk.message_table_plain(*args, K=K, L=L, save_x=True),
                    _message_table_bound(mode, N, K, H, C, save_x=True), 10,
                    f"rel err out {fwd_err['out']:.3g}, x {fwd_err['x']:.3g} "
                    f"(< {REL_TOL}); bitwise across launches, and without x "
                    f"(scalar-FMA form with x, PERF.md: "
                    f"{SCALAR_MS[f'message_table_{mode}']} ms)")
        g_rows = N * K if mode == "enc_edge" else N
        g = torch.randn((g_rows, H), generator=gen, device=dev)
        bargs = (mode, h_V2, h_E2, x_k, eidx2, ma, mb, wa, wb, b1, w2, b2, w3, b3, g)
        # the first launch sorts for itself, the second takes the stack's order
        got, extra = _launch_bytes(lambda: mk.message_table_bwd_cuda(*bargs, K=K, L=L))
        again = mk.message_table_bwd_cuda(*bargs, K=K, L=L, order=order)
        want = mk.message_table_bwd_plain(*bargs, K=K, L=L)
        errs = {}
        for i, (name, a, b, c) in enumerate(zip(names, got, want, again)):
            errs[name] = _rel_err(a, b)
            tol = REL_TOL if name in ("g_hV", "g_ein") else 1e-4
            if not errs[name] < tol:
                raise AssertionError(f"message_table_bwd {mode} {name}: "
                                     f"rel err {errs[name]:.3g} (tol {tol})")
            if not torch.equal(a, c):
                raise AssertionError(f"message_table_bwd {mode} {name}: two "
                                     "launches differ")
        ms = _sync_time(lambda: mk.message_table_bwd_cuda(*bargs, K=K, L=L,
                                                          order=order), 10)
        plain_ms = _sync_time(lambda: mk.message_table_bwd_plain(*bargs, K=K, L=L), 3)
        bound = _bwd_bound(mode, N, K, H, C, g_rows)
        worst = max(errs, key=errs.get)
        print(f"message_table_bwd {mode} N={N} K={K} H={H}: worst rel err "
              f"{errs[worst]:.3g} ({worst}); g_hV {errs['g_hV']:.3g}, g_ein "
              f"{errs['g_ein']:.3g}, g_table {errs['g_table']:.3g}, dW2 "
              f"{errs['dw2']:.3g}; two launches bitwise equal, g_table "
              f"included, with and without the stack's order; {ms:.4f} ms with "
              f"the order given (scalar-FMA form, PERF.md: "
              f"{SCALAR_MS[f'message_table_bwd_{mode}']} ms; plain {plain_ms:.4f} ms, "
              f"bound {bound[0]:.5f} ms); {extra / 2**20:.1f} MiB of scratch per "
              f"launch", flush=True)
        rows[f"message_table_bwd_{mode}"] = dict(
            max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, want)),
            ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1])
        del got, again, want, out_p, x_p
    return rows, fwd_ms


# bf16 outputs: four bf16 steps of the largest value (2^-6 of it): the two
# sides sum in other orders, so a value near a rounding boundary may round to
# its neighbour on one side and move what it feeds by one step of itself.
BF16_TOL = 2.0 ** -6
# The bf16 RBF's fp32 sums of bf16 products: a bin that rounds apart moves a
# sum by 2^-8 of one term.
RBF_BF16_TOL = 2.0 ** -8
# The dense bf16 RBF (rows 5, 6) against its plain version: the readings on
# an H100 were 1.98e-4 / 4.57e-5 at the training shape (2.35e-4 / 7.08e-5
# with key rows), from bins that lie within an fp32 ulp of a bf16 boundary
# and round apart (``__expf`` against PyTorch's exp); 1e-3 keeps a margin of
# four and stays below what the bf16 rounding moves the sums.
RBF_EDGE_BF16_TOL = 1e-3


def _rms_rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt()) / (float(b.pow(2).mean().sqrt()) + 1e-30)


def _check_rounding(name, got, want, fp32):
    """Holds a bf16 variant to its rounding points: its root-mean-square
    distance from the fp32 kernel on the same (widened) inputs must be more
    than twice its distance from its plain bf16 version, so a variant that
    skipped a bf16 rounding, and so sat nearer the fp32 result, fails. The
    root mean square, not the max, since one flipped rounding moves the max
    as far as the rounding itself does. Returns the two distances."""
    err, sep = _rms_rel(got.float(), want.float()), _rms_rel(got.float(), fp32.float())
    if not sep > 2 * err:
        raise AssertionError(f"{name}: rms distance {sep:.3g} from the fp32 kernel is "
                             f"not twice its {err:.3g} from the plain bf16 version")
    return err, sep


def bf16_kernel_phase(nb):
    """The bf16 variants of rows 3-6 and 9-12 against their plain bf16
    versions on the card at the training shape (B=8, L=768, K=32, H=128;
    6144 nodes, 196,608 edges), TF32 off: the classed and the dense RBF
    projection and their weight gradients (relative error < 2^-8 classed,
    < 1e-3 dense, the dense ones also nearer their plain versions than the
    fp32 kernels, ``_check_rounding``; two weight-gradient launches bitwise
    equal), each also for a 192-row shard
    against the structure's 768 key rows (the graph-parallel route's
    operands; equal to the structure's own rows within 1e-6), the message
    table in three modes with its saved ``x``
    and its backward (< 2^-6 on every output, each nearer its plain bf16
    version than the fp32 kernel's, ``_check_rounding``; two backward
    launches bitwise equal, the table gradient included)
    and the fused node (encoder, decoder) and edge updates of ``eval_step``
    (< 2^-6). Bounds at the bf16 tensor-core peak with bf16 bytes. Returns
    the rows of the kernels JSON line."""
    import torch
    from na_mpnn_tpu_torch.models import init_params
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.models.features import build_augmented_atoms
    from na_mpnn_tpu_torch.models.modules import cast_tree
    from na_mpnn_tpu_torch.ops import fused_layers as fl
    from na_mpnn_tpu_torch.ops import knn, message_kernels as mk, rbf_classed, rbf_edge
    from na_mpnn_tpu_torch.train.trainer import to_device

    dev = torch.device("cuda")
    bf = torch.bfloat16
    cfg = ModelConfig()
    H, K = cfg.hidden_dim, cfg.k_neighbors
    batch = to_device(nb, dev)
    X_aug, X_m_aug, X_ref = build_augmented_atoms(
        batch["X"], batch["X_m"], batch, cfg)
    mask = batch["mask"].float()
    B, L = mask.shape
    N = B * L
    _, E_idx = knn.knn_graph_cuda(X_ref, mask, K)
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = {}

    def row(name, got, want, tol, call, plain_call, bound, iters, note="",
            fp32=None):
        err = _rel_err(got.float(), want.float())
        if not err < tol:
            raise AssertionError(f"{name}: relative error {err:.3g} (tol {tol:.3g})")
        if fp32 is not None:
            note += ("; rms {:.3g} from plain vs {:.3g} from the fp32 kernel"
                     .format(*_check_rounding(name, got, want, fp32)))
        ms = _sync_time(call, iters)
        plain_ms = _sync_time(plain_call, 2)
        print(f"{name} B={B} L={L} K={K} H={H}: rel err {err:.3g} (< {tol:.3g}){note}, "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms by "
              f"{bound[1]} at the bf16 peak, {ms / bound[0]:.1f}x)", flush=True)
        rows[name] = dict(max_abs_err=float((got.float() - want.float()).abs().max()),
                          ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                          bound_by=bound[1])

    # rows 3 and 4: the fold-scaled weight, as the model passes it
    params = init_params(1, cfg, device=dev)
    W0 = params["features"]["edge_embedding"]["w"][cfg.num_positional_embeddings:]
    W = rbf_classed.fold_scaled(W0)
    rbf_args = (X_aug, X_m_aug, E_idx, W)
    rbf_k = rbf_classed.rbf_classed_bf16_cuda(*rbf_args)
    if not torch.equal(rbf_k, rbf_classed.rbf_classed_bf16_cuda(*rbf_args)):
        raise AssertionError("rbf_classed_bf16: two launches differ")
    # the fp32 kernel: exact bins against the unscaled weight, the same
    # function up to the bf16 roundings
    row("rbf_classed_bf16", rbf_k, rbf_classed.rbf_classed_bf16_plain(*rbf_args),
        RBF_BF16_TOL, lambda: rbf_classed.rbf_classed_bf16_cuda(*rbf_args),
        lambda: rbf_classed.rbf_classed_bf16_plain(*rbf_args),
        _rbf_bound(X_aug, X_m_aug, E_idx, H, w_bytes=2, peak=PEAK_BF16_FLOPS), 5,
        f", two launches bitwise equal (scalar-FMA form, PERF.md: "
        f"{SCALAR_MS['rbf_classed_bf16']} ms)",
        fp32=rbf_classed.rbf_edge_features_classed_cuda(X_aug, X_m_aug, E_idx, W0))
    del rbf_k
    g = torch.randn((B, L, K, H), generator=gen, device=dev)
    dw_args = (X_aug, X_m_aug, E_idx, g)
    dw_k = rbf_classed.rbf_classed_dw_bf16_cuda(*dw_args)
    if not torch.equal(dw_k, rbf_classed.rbf_classed_dw_bf16_cuda(*dw_args)):
        raise AssertionError("rbf_classed_dw_bf16: two launches differ")
    row("rbf_classed_dw_bf16", dw_k, rbf_classed.rbf_classed_dw_bf16_plain(*dw_args),
        RBF_BF16_TOL, lambda: rbf_classed.rbf_classed_dw_bf16_cuda(*dw_args),
        lambda: rbf_classed.rbf_classed_dw_bf16_plain(*dw_args),
        _rbf_bound(X_aug, X_m_aug, E_idx, H, peak=PEAK_BF16_FLOPS), 5,
        f", two launches bitwise equal (scalar-FMA form, PERF.md: "
        f"{SCALAR_MS['rbf_classed_dw_bf16']} ms)",
        fp32=rbf_classed.rbf_classed_dw_cuda(*dw_args))

    # rows 5 and 6: the dense RBF on the reference-order weight
    W = params["features"]["edge_embedding"]["w"][cfg.num_positional_embeddings:]
    rbf_args = (X_aug, X_m_aug, E_idx, W)
    rbf_k = rbf_edge.rbf_edge_bf16_cuda(*rbf_args)
    if not torch.equal(rbf_k, rbf_edge.rbf_edge_bf16_cuda(*rbf_args)):
        raise AssertionError("rbf_edge_bf16: two launches differ")
    row("rbf_edge_bf16", rbf_k, rbf_edge.rbf_edge_bf16_plain(*rbf_args),
        RBF_EDGE_BF16_TOL, lambda: rbf_edge.rbf_edge_bf16_cuda(*rbf_args),
        lambda: rbf_edge.rbf_edge_bf16_plain(*rbf_args),
        _rbf_bound(X_aug, X_m_aug, E_idx, H, w_bytes=2, peak=PEAK_BF16_FLOPS), 5,
        f", two launches bitwise equal (scalar-FMA form, PERF.md: "
        f"{SCALAR_MS['rbf_edge_bf16']} ms)", fp32=rbf_edge.rbf_edge_cuda(*rbf_args))
    del rbf_k
    dw_k = rbf_edge.rbf_edge_dw_bf16_cuda(*dw_args)
    if not torch.equal(dw_k, rbf_edge.rbf_edge_dw_bf16_cuda(*dw_args)):
        raise AssertionError("rbf_edge_dw_bf16: two launches differ")
    row("rbf_edge_dw_bf16", dw_k, rbf_edge.rbf_edge_dw_bf16_plain(*dw_args),
        RBF_EDGE_BF16_TOL, lambda: rbf_edge.rbf_edge_dw_bf16_cuda(*dw_args),
        lambda: rbf_edge.rbf_edge_dw_bf16_plain(*dw_args),
        _rbf_bound(X_aug, X_m_aug, E_idx, H, peak=PEAK_BF16_FLOPS), 5,
        f", two launches bitwise equal (scalar-FMA form, PERF.md: "
        f"{SCALAR_MS['rbf_edge_dw_bf16']} ms)", fp32=rbf_edge.rbf_edge_dw_cuda(*dw_args))
    del dw_k

    # rows 3-6 with key rows of their own: the second of four 192-row shards
    # of the graph-parallel route against the whole structure's 768 rows
    s0, Lq = 192, 192
    Xq, Mq = X_aug[:, s0:s0 + Lq].contiguous(), X_m_aug[:, s0:s0 + Lq].contiguous()
    Eq = E_idx[:, s0:s0 + Lq].contiguous()
    gq = g[:, s0:s0 + Lq].contiguous()
    W_fold = rbf_classed.fold_scaled(W)
    keys = (X_aug, X_m_aug)
    row34 = None
    for name, fwd, fwd_plain, dw, dw_plain, w, tol, fwd32, dw32 in (
            ("rbf_classed", rbf_classed.rbf_classed_bf16_cuda,
             rbf_classed.rbf_classed_bf16_plain, rbf_classed.rbf_classed_dw_bf16_cuda,
             rbf_classed.rbf_classed_dw_bf16_plain, W_fold, RBF_BF16_TOL,
             rbf_classed.rbf_edge_features_classed_cuda, rbf_classed.rbf_classed_dw_cuda),
            ("rbf_edge", rbf_edge.rbf_edge_bf16_cuda, rbf_edge.rbf_edge_bf16_plain,
             rbf_edge.rbf_edge_dw_bf16_cuda, rbf_edge.rbf_edge_dw_bf16_plain, W,
             RBF_EDGE_BF16_TOL, rbf_edge.rbf_edge_cuda, rbf_edge.rbf_edge_dw_cuda)):
        out_k = fwd(Xq, Mq, Eq, w, *keys)
        if not torch.equal(out_k, fwd(Xq, Mq, Eq, w, *keys)):
            raise AssertionError(f"{name}_bf16 key rows: two launches differ")
        # the fp32 forward and weight gradient on the same shard (rows 3, 4
        # then rows 5, 6, which must give rows 3 and 4's bits)
        f32, d32 = fwd32(Xq, Mq, Eq, W, *keys), dw32(Xq, Mq, Eq, gq, *keys)
        f32_err = _rel_err(f32, rbf_edge.rbf_edge_features_plain(Xq, Mq, Eq, W, *keys))
        d32_err = _rel_err(d32, rbf_edge.rbf_edge_dw_plain(Xq, Mq, Eq, gq, *keys))
        if not (f32_err < REL_TOL and d32_err < 1e-4
                and torch.equal(f32, fwd32(Xq, Mq, Eq, W, *keys))
                and torch.equal(d32, dw32(Xq, Mq, Eq, gq, *keys))):
            raise AssertionError(f"{name} fp32 key rows: rel err {f32_err:.3g}, dW "
                                 f"{d32_err:.3g}, or two launches differ")
        if row34 is None:
            row34 = (f32, d32)
        elif not (torch.equal(f32, row34[0]) and torch.equal(d32, row34[1])):
            raise AssertionError("rbf_edge / rbf_edge_dw fp32 key rows: not the bits "
                                 "of rbf_classed / rbf_classed_dw")
        f32_ms = _sync_time(lambda: fwd32(Xq, Mq, Eq, W, *keys), 5)
        d32_ms = _sync_time(lambda: dw32(Xq, Mq, Eq, gq, *keys), 5)
        print(f"{name} / {name}_dw (fp32) with key rows (B={B} Lq={Lq} of Lk={L}): "
              f"rel err {f32_err:.3g} (< {REL_TOL}) / {d32_err:.3g} (< 1e-4), two "
              f"launches bitwise equal"
              + (", bitwise rows 3 and 4's" if name == "rbf_edge" else "")
              + f"; {f32_ms:.4f} / {d32_ms:.4f} ms", flush=True)
        del f32, d32
        err = _rel_err(out_k, fwd_plain(Xq, Mq, Eq, w, X_aug, X_m_aug))
        # the same bins and products as the structure's own rows
        same = _rel_err(out_k, fwd(*rbf_args[:3], w)[:, s0:s0 + Lq])
        dw_k = dw(Xq, Mq, Eq, gq, X_aug, X_m_aug)
        if not torch.equal(dw_k, dw(Xq, Mq, Eq, gq, X_aug, X_m_aug)):
            raise AssertionError(f"{name}_dw_bf16 key rows: two launches differ")
        dw_err = _rel_err(dw_k, dw_plain(Xq, Mq, Eq, gq, X_aug, X_m_aug))
        if not (err < tol and dw_err < tol and same < 1e-6):
            raise AssertionError(f"{name}_bf16 key rows: rel err {err:.3g}, dW "
                                 f"{dw_err:.3g}, against the structure's rows {same:.3g}")
        ms = _sync_time(lambda: fwd(Xq, Mq, Eq, w, X_aug, X_m_aug), 5)
        dms = _sync_time(lambda: dw(Xq, Mq, Eq, gq, X_aug, X_m_aug), 5)
        print(f"{name}_bf16 / {name}_dw_bf16 with key rows (B={B} Lq={Lq} of Lk={L}): "
              f"rel err {err:.3g} / {dw_err:.3g} (< {tol:.3g}), against "
              f"the structure's own rows {same:.3g}, forward and dW two launches "
              f"bitwise equal; {ms:.4f} / {dms:.4f} ms"
              + (f" (scalar-FMA form, PERF.md: {SCALAR_MS['rbf_edge_bf16_shard']} / "
                 f"{SCALAR_MS['rbf_edge_dw_bf16_shard']} ms)" if name == "rbf_edge"
                 else ""), flush=True)
        del out_k, dw_k
    del g, gq, params, row34

    # rows 9 and 10: every operand bf16
    eidx2 = E_idx.reshape(-1).contiguous()
    h_V2 = torch.randn((N, H), generator=gen, device=dev).to(bf)
    h_E2 = torch.randn((N * K, H), generator=gen, device=dev).to(bf)
    m_att = (torch.rand((N * K,), generator=gen, device=dev) > 0.1).to(bf)
    m1d = (torch.rand((N * K,), generator=gen, device=dev) > 0.2).to(bf)
    mbw = m1d * (torch.rand((N * K,), generator=gen, device=dev) > 0.5).to(bf)
    ones = torch.ones_like(m_att)
    names = ("g_hV", "g_ein", "g_table", "dwa", "dwb", "db1", "dw2", "db2",
             "dw3", "db3")
    order = mk.table_order(eidx2, K, L, L, N)     # as the kernel phase's
    for mode, ma, mb in (("enc_node", m_att, ones), ("enc_edge", ones, ones),
                         ("dec", m1d, mbw)):
        C = 2 * H if mode == "dec" else H
        table = torch.randn((N, C), generator=gen, device=dev).to(bf)
        wa, wb, w2, w3 = (
            (torch.randn((H, H), generator=gen, device=dev) / H ** 0.5).to(bf)
            for _ in range(4))
        b1, b2, b3 = (torch.randn((H,), generator=gen, device=dev).to(bf)
                      for _ in range(3))
        args = (mode, h_V2, h_E2, table, eidx2, ma, mb, wa, wb, b1, w2, b2, w3, b3)
        out_k, x_k = mk.message_table_cuda(*args, K=K, L=L, save_x=True)
        out_p, x_p = mk.message_table_plain(*args, K=K, L=L, save_x=True)
        err_x = _rel_err(x_k.float(), x_p.float())
        if not err_x < BF16_TOL:
            raise AssertionError(f"message_table {mode} bf16 x: rel err {err_x:.3g}")
        _table_fwd_bitwise(f"message_table {mode} bf16", args, out_k, x_k, K=K, L=L)
        f_out, f_x = mk.message_table_cuda(*[t.float() if torch.is_tensor(t) and
                                             t.dtype == bf else t for t in args],
                                           K=K, L=L, save_x=True)
        sep_x = _check_rounding(f"message_table_{mode}_bf16 x", x_k, x_p, f_x)
        row(f"message_table_{mode}_bf16", out_k, out_p, BF16_TOL,
            lambda: mk.message_table_cuda(*args, K=K, L=L, save_x=True),
            lambda: mk.message_table_plain(*args, K=K, L=L, save_x=True),
            _message_table_bound(mode, N, K, H, C, save_x=True, esize=2,
                                 peak=PEAK_BF16_FLOPS), 10,
            f" (x {err_x:.3g}; x rms {sep_x[0]:.3g} from plain vs {sep_x[1]:.3g} "
            f"from the fp32 kernel); bitwise across launches, and without x "
            f"(scalar-FMA form with x, PERF.md: "
            f"{SCALAR_MS[f'message_table_{mode}_bf16']} ms)", fp32=f_out)
        del f_out, f_x
        g_rows = N * K if mode == "enc_edge" else N
        g = torch.randn((g_rows, H), generator=gen, device=dev).to(bf)
        bargs = (mode, h_V2, h_E2, x_k, eidx2, ma, mb, wa, wb, b1, w2, b2, w3, b3, g)
        # the first launch sorts for itself, the second takes the stack's order
        got, extra = _launch_bytes(lambda: mk.message_table_bwd_cuda(*bargs, K=K, L=L))
        again = mk.message_table_bwd_cuda(*bargs, K=K, L=L, order=order)
        want = mk.message_table_bwd_plain(*bargs, K=K, L=L)
        g32 = mk.message_table_bwd_cuda(*[t.float() if torch.is_tensor(t) and
                                          t.dtype == bf else t for t in bargs],
                                        K=K, L=L)
        errs, seps = {}, {}
        for name, a, b, c, f in zip(names, got, want, again, g32):
            errs[name] = _rel_err(a.float(), b.float())
            if not errs[name] < BF16_TOL:
                raise AssertionError(f"message_table_bwd {mode} bf16 {name}: "
                                     f"rel err {errs[name]:.3g}")
            if not torch.equal(a, c):
                raise AssertionError(f"message_table_bwd {mode} bf16 {name}: two "
                                     "launches differ")
            seps[name] = _check_rounding(f"message_table_bwd_{mode}_bf16 {name}",
                                         a, b, f)
        near = min(seps, key=lambda n: seps[n][1] / (seps[n][0] + 1e-30))
        worst = max(errs, key=errs.get)
        ms = _sync_time(lambda: mk.message_table_bwd_cuda(*bargs, K=K, L=L,
                                                          order=order), 10)
        plain_ms = _sync_time(lambda: mk.message_table_bwd_plain(*bargs, K=K, L=L), 3)
        bound = _bwd_bound(mode, N, K, H, C, g_rows, esize=2, peak=PEAK_BF16_FLOPS)
        print(f"message_table_bwd_{mode}_bf16 N={N} K={K} H={H}: worst rel err "
              f"{errs[worst]:.3g} ({worst}; < {BF16_TOL:.3g}); two launches bitwise "
              f"equal, g_table included; nearest the fp32 kernel: {near}, rms "
              f"{seps[near][0]:.3g} from plain vs {seps[near][1]:.3g} from fp32; "
              f"{ms:.4f} ms with the order given (scalar-FMA form, PERF.md: "
              f"{SCALAR_MS[f'message_table_bwd_{mode}_bf16']} ms; plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]} at the "
              f"bf16 peak, {ms / bound[0]:.1f}x); {extra / 2**20:.1f} MiB of "
              f"scratch per launch", flush=True)
        rows[f"message_table_bwd_{mode}_bf16"] = dict(
            max_abs_err=max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(got, want)),
            ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1])
        del got, again, want, g32, out_k, out_p, x_k, x_p

    # rows 11 and 12 at eval_step's shape, bf16 parameters as the model casts
    # them; and the fp32 kernels on the same (widened) operands
    pe, pd = _random_layer(cfg, 6, dev)
    mask2 = mask.reshape(-1).contiguous()
    nb_mask = torch.gather(mask, 1, E_idx.reshape(B, -1)).reshape(-1)
    m_att = (mask2.repeat_interleave(K) * nb_mask).to(bf).contiguous()
    m1d = mask2.repeat_interleave(K).to(bf).contiguous()
    mbw = (m1d * (torch.rand((N * K,), generator=gen, device=dev) > 0.5).to(bf))
    ops16 = [h_V2, h_E2, torch.randn((N, H), generator=gen, device=dev).to(bf),
             torch.randn((N, 2 * H), generator=gen, device=dev).to(bf),
             m_att, m1d, mbw, mask2.to(bf)]
    cases16 = _fused_cases(cast_tree(pe, bf), cast_tree(pd, bf), ops16, eidx2, K, L, L)
    wide = _fused_cases(pe, pd, [t.float() for t in ops16], eidx2, K, L, L)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, case in cases16.items():
        call, kernel, plain, kind, C, _ = case
        _, note, _ = _check_fused(name + "_bf16", "eval_step", case, BF16_TOL,
                                  fp32=(wide[name][0], wide[name][1]))
        extra = ("" if kind == "edge"
                 else f"; tail tiles of {fl.tail_tile_rows(N, H, n_sm)} nodes")
        row(name + "_bf16", call(kernel), call(plain), BF16_TOL, lambda: call(kernel),
            lambda: call(plain),
            _fused_bound(kind, N, K, H, C, esize=2, peak=PEAK_BF16_FLOPS), 10,
            f"{note}{extra} (scalar-FMA form, PERF.md: "
            f"{FMA_FUSED_MS[name + '_bf16']['eval_step']} ms)")
        call, kernel, plain, kind, C, _ = wide[name]
        err, note, _ = _check_fused(name, "eval_step fp32", wide[name], REL_TOL)
        ms = _sync_time(lambda: call(kernel), 10)
        plain_ms = _sync_time(lambda: call(plain), 2)
        bound = _fused_bound(kind, N, K, H, C)
        print(f"{name} (fp32) B={B} L={L} K={K} H={H}: rel err {err:.3g} (< {REL_TOL})"
              f"{note}; {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{bound[0]:.5f} ms by {bound[1]}, {ms / bound[0]:.1f}x)", flush=True)
    return rows


MLP_FLAGS = ((False, True), (True, True), (True, False), (False, False))


def _message_mlp_bound(N, K, H, contract_e, aggregate, backward=False, esize=4,
                       peak=PEAK_FP32_FLOPS):
    """Least work of the pre-gathered message MLP (rows 7, 8), in the
    convention of ``_message_table_bound``: forward, per edge the W2 product
    (2 H^2), e_in@Wb with ``contract_e`` and W3 without ``aggregate`` (in the
    summing form W3 acts once per node, as there), about 30 H elementwise;
    per node h_V@Wa and, summing, W3. Backward (activations recomputed): per
    edge W2 again, dW2 and g_x (6 H^2), with ``contract_e`` e_in@Wb, g_ein and
    dWb (6 H^2), without ``aggregate`` dW3 and g_m@W3^T (4 H^2), about 40 H
    elementwise; per node h_V@Wa, g_hV and dWa (6 H^2) and, summing, dW3 and
    g_m@W3^T (4 H^2). Bytes: every input read once, every output written
    once, ``esize`` bytes per element (2 for bf16)."""
    ce, agg = int(contract_e), int(aggregate)
    w = 4 * H * H + 3 * H
    out = N * H if agg else N * K * H
    inputs = N * H + 2 * N * K * H + N * K + w
    if backward:
        ops = (N * K * ((6 + 6 * ce + 4 * (1 - agg)) * H * H + 40 * H)
               + N * (6 + 4 * agg) * H * H)
        nbytes = esize * (inputs + out + N * H + 2 * N * K * H + w)
    else:
        ops = (N * K * ((2 + 2 * ce + 2 * (1 - agg)) * H * H + 30 * H)
               + N * (2 + 2 * agg) * H * H)
        nbytes = esize * (inputs + out)
    return _bound_ms(ops, nbytes, peak)


# Rows 7 and 8 beside the training shape: K over 1..64 and the narrower
# widths at N = 203 nodes, a multiple of neither walk's nodes per tile
# (table_tile_nodes, bwd_tile_nodes) where a tile holds more than one node.
MLP_SMALL = ((1, 128), (30, 128), (48, 128), (64, 128), (32, 32), (32, 64))
MLP_SMALL_N = 203
MLP_N = 6000       # the training shape's nodes (B=8 x L=750)
MLP_NAMES = ("g_hV", "g_ein", "g_G", "dwa", "dwb", "db1", "dw2", "db2", "dw3", "db3")


def _mlp_operands(N, K, H, dt, seed):
    """Random operands of rows 7 and 8 on the card: (args, gen) with args
    ``(h_V, e_in, G, mask, wa, wb, b1, w2, b2, w3, b3)`` of type ``dt``, a
    0/1 mask with a fifth of the edges off."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    h_V = torch.randn((N, H), generator=gen, device=dev).to(dt)
    e_in = torch.randn((N * K, H), generator=gen, device=dev).to(dt)
    G = torch.randn((N * K, H), generator=gen, device=dev).to(dt)
    mask = (torch.rand((N * K,), generator=gen, device=dev) > 0.2).to(dt)
    wa, wb, w2, w3 = ((torch.randn((H, H), generator=gen, device=dev) / H ** 0.5).to(dt)
                      for _ in range(4))
    b1, b2, b3 = (torch.randn((H,), generator=gen, device=dev).to(dt) for _ in range(3))
    return (h_V, e_in, G, mask, wa, wb, b1, w2, b2, w3, b3), gen


def _mlp_check(args, g, flags, low, tag):
    """Rows 7 and 8 of one launch against their plain versions (fp32: < 1e-5
    of the max on the output and the per-node and per-edge gradients, < 1e-4
    on the weight and bias sums; bf16: < 2^-6 on every output), each output
    bitwise equal across two launches. Returns (out_k, out_p, got, want,
    errs, rel)."""
    import torch
    from na_mpnn_tpu_torch.ops import message_kernels as mk
    dt = args[0].dtype
    out_tol = BF16_TOL if low else REL_TOL
    out_k = mk.message_mlp_cuda(*args, **flags)
    out_again = mk.message_mlp_cuda(*args, **flags)
    out_p = mk.message_mlp_plain(*args, **flags)
    rel = _rel_err(out_k.float(), out_p.float())
    if out_k.dtype != dt or not rel < out_tol:
        raise AssertionError(f"message_mlp {tag}: {out_k.dtype}, rel err {rel:.3g}")
    if not torch.equal(out_k, out_again):
        raise AssertionError(f"message_mlp {tag}: two launches differ")
    got = [t.clone() for t in mk.message_mlp_bwd_cuda(*args, g, **flags)]
    again = mk.message_mlp_bwd_cuda(*args, g, **flags)
    want = mk.message_mlp_bwd_plain(*args, g, **flags)
    errs = {n: _rel_err(a.float(), b.float()) for n, a, b in zip(MLP_NAMES, got, want)}
    if not flags["contract_e"]:     # dwb: zero, as the JAX VJP returns it
        if bool(got[4].any()):
            raise AssertionError(f"message_mlp_bwd {tag}: dwb is not zero")
        errs["dwb"] = 0.0
    for n, e in errs.items():
        tol = (BF16_TOL if low else
               REL_TOL if n in ("g_hV", "g_ein", "g_G") else 1e-4)
        if not e < tol:
            raise AssertionError(f"message_mlp_bwd {tag} {n}: rel err {e:.3g} (tol {tol})")
    if not all(a.dtype == dt and torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"message_mlp_bwd {tag}: two launches differ (or an "
                             f"output is not {dt})")
    return out_k, out_p, got, want, errs, rel


def message_mlp_phase(low=False):
    """Rows 7 and 8 (``csrc/message_mlp.cu``, ``csrc/message_mlp_bwd.cu``)
    against their plain versions on the card (``_mlp_check``: at fp32
    relative error < 1e-5 on outputs and per-node / per-edge gradients,
    < 1e-4 on the weight and bias gradients, sums over all edges; with
    ``low`` the bf16 variants, every operand bf16, < 2^-6 on every bf16
    output; every output, the forward's too, bitwise equal across two
    launches) in all four (contract_e, aggregate) variants: first at N = 203
    for K in 1, 30, 48, 64 at H = 128 and K = 32 at H = 32 and 64
    (``MLP_SMALL``), then at the training shape N = 6000, K = 32, H = 128,
    where at bf16 every output is also nearer its plain version than the
    fp32 kernel's on the widened inputs (``_check_rounding``), and each
    variant is timed (bounds at the bf16 peak with bf16 bytes for ``low``).
    Returns the JSON rows of the decoder's variant (False, True), the one on
    the training path."""
    import torch
    from na_mpnn_tpu_torch.ops import message_kernels as mk

    dt = torch.bfloat16 if low else torch.float32
    sfx = "_bf16" if low else ""
    peak, esize = (PEAK_BF16_FLOPS, 2) if low else (PEAK_FP32_FLOPS, 4)
    worst = {}
    for K, H in MLP_SMALL:
        args, gen = _mlp_operands(MLP_SMALL_N, K, H, dt, 9 + K + H)
        for ce, agg in MLP_FLAGS:
            flags = dict(K=K, contract_e=ce, aggregate=agg)
            g = torch.randn((MLP_SMALL_N if agg else MLP_SMALL_N * K, H), generator=gen,
                            device="cuda").to(dt)
            *_, errs, rel = _mlp_check(args, g, flags, low, f"{sfx} K={K} H={H} {ce, agg}")
            for n, e in (("out", rel), *errs.items()):
                if n not in worst or e > worst[n][0]:
                    worst[n] = (e, f"K={K} H={H} {int(ce)}{int(agg)}")
    print(f"message_mlp{sfx} and its backward at N={MLP_SMALL_N}, (K, H) in "
          f"{list(MLP_SMALL)}, all four (contract_e, aggregate): within the bars, "
          f"every output bitwise equal across two launches; worst rel err per "
          f"output: " + ", ".join(f"{n} {e:.3g} ({at})" for n, (e, at) in worst.items()),
          flush=True)

    N, K, H = MLP_N, 32, 128
    args, gen = _mlp_operands(N, K, H, dt, 8)
    args32 = tuple(t.float() for t in args)
    rows = {}
    for ce, agg in MLP_FLAGS:
        flags = dict(K=K, contract_e=ce, aggregate=agg)
        g = torch.randn((N if agg else N * K, H), generator=gen, device="cuda").to(dt)
        out_k, out_p, got, want, errs, rel = _mlp_check(args, g, flags, low,
                                                        f"{sfx} {ce, agg}")
        rounding = ""
        if low:     # every output against the fp32 kernel's (dwb is zero
            # without contract_e)
            seps = {"out": _check_rounding(f"message_mlp_bf16 {ce, agg}", out_k, out_p,
                                           mk.message_mlp_cuda(*args32, **flags))}
            g32 = mk.message_mlp_bwd_cuda(*args32, g.float(), **flags)
            seps.update((n, _check_rounding(f"message_mlp_bwd_bf16 {ce, agg} {n}", a, b, c))
                        for n, a, b, c in zip(MLP_NAMES, got, want, g32) if n != "dwb" or ce)
            n = min(seps, key=lambda n: seps[n][1] / (seps[n][0] + 1e-30))
            rounding = (f"; nearest the fp32 kernel: {n}, rms {seps[n][0]:.3g} from "
                        f"plain vs {seps[n][1]:.3g} from fp32")
            del g32
        ms = _sync_time(lambda: mk.message_mlp_cuda(*args, **flags), 10)
        plain_ms = _sync_time(lambda: mk.message_mlp_plain(*args, **flags), 3)
        bms = _sync_time(lambda: mk.message_mlp_bwd_cuda(*args, g, **flags), 10)
        bplain_ms = _sync_time(lambda: mk.message_mlp_bwd_plain(*args, g, **flags), 3)
        fb = _message_mlp_bound(N, K, H, ce, agg, esize=esize, peak=peak)
        bb = _message_mlp_bound(N, K, H, ce, agg, backward=True, esize=esize,
                                peak=peak)
        worst = max(errs, key=errs.get)
        earlier = SCALAR_MS.get(f"message_mlp{sfx}_{int(ce)}{int(agg)}")
        note = (f" (scalar-FMA form, PERF.md: {earlier[0]} / {earlier[1]} ms)"
                if earlier else "")
        print(f"message_mlp{sfx} contract_e={ce} aggregate={agg} N={N} K={K} H={H}: "
              f"rel err {rel:.3g} (< {BF16_TOL if low else REL_TOL:.3g}), two launches "
              f"bitwise equal, {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {fb[0]:.5f} "
              f"ms by {fb[1]}, {ms / fb[0]:.1f}x); backward worst rel err "
              f"{errs[worst]:.3g} ({worst}), g_hV {errs['g_hV']:.3g}, g_G "
              f"{errs['g_G']:.3g}, two launches bitwise equal{rounding}, {bms:.4f} ms "
              f"(plain {bplain_ms:.4f} ms, bound {bb[0]:.5f} ms by {bb[1]}, "
              f"{bms / bb[0]:.1f}x){note}", flush=True)
        if (ce, agg) == (False, True):
            rows["message_mlp" + sfx] = dict(
                max_abs_err=float((out_k.float() - out_p.float()).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=fb[0], bound_by=fb[1])
            rows["message_mlp_bwd" + sfx] = dict(
                max_abs_err=max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(got, want)),
                ms=bms, plain_ms=bplain_ms, bound_ms=bb[0], bound_by=bb[1])
        del out_k, out_p, got, want, g
    return rows


def _expected_train_launches(cfg):
    n_enc, n_dec = cfg.num_encoder_layers, cfg.num_decoder_layers
    want = {"knn": 1, "rbf_classed": 1, "rbf_classed_dw": 1,
            "message_table_enc_node": n_enc, "message_table_enc_edge": n_enc,
            "message_table_dec": n_dec}
    for mode, n in (("enc_node", n_enc), ("enc_edge", n_enc), ("dec", n_dec)):
        want[f"message_table_bwd_{mode}"] = n
    return want


def _train_steps(trainer, nb, want, tag, steps=5, generator=None):
    """``steps`` train steps with the launches of every step held to
    ``want``; returns (ms per step, peak bytes, the steps' launches)."""
    import torch
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches

    flat0 = trainer.flat.clone()
    step_ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for step in range(steps):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        m = trainer.train_step(nb, generator)
        loss = float(m["loss_av"])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        counts = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()}
        counts = {k: v for k, v in counts.items() if v}
        if counts != want:
            raise AssertionError(f"{tag} step {step}: launches {counts}, want {want}")
        if not np.isfinite(loss):
            raise AssertionError(f"{tag} step {step}: loss {loss}")
        print(f"{tag} step {step}: loss {loss:.6f}, {step_ms[-1]:.2f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(trainer.flat).all()) or torch.equal(trainer.flat, flat0):
        raise AssertionError(f"{tag}: parameters not finite or not moved")
    return step_ms, peak, dict(LAUNCHES)


def _grads_against_plain(tag, kernel_trainer, plain_trainer, batch, generator,
                         want, loss_tol=1e-5, grad_tol=1e-4):
    """One step's loss and gradients with the kernels against
    ``kernels="torch"`` (both trainers hold the same parameters; the same
    generator seed, or the mesh's row-keyed streams): the loss within
    ``loss_tol`` relative, each gradient leaf within ``grad_tol`` of its
    largest entry."""
    import torch
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches

    def gen():
        return None if generator is None else torch.Generator(
            device="cuda").manual_seed(generator)

    reset_launches()
    loss_k, grad_k = kernel_trainer.loss_and_grads(batch, gen())[:2]
    if {k: v for k, v in LAUNCHES.items() if v} != want:
        raise AssertionError(f"{tag}: kernel step launches {dict(LAUNCHES)}")
    reset_launches()
    loss_p, grad_p = plain_trainer.loss_and_grads(batch, gen())[:2]
    if any(LAUNCHES.values()):
        raise AssertionError(f"{tag}: the kernels='torch' step launched {dict(LAUNCHES)}")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst, off = 0.0, 0
    for p in kernel_trainer.leaves:
        a, b = grad_k[off:off + p.numel()], grad_p[off:off + p.numel()]
        off += p.numel()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag}: a gradient is not finite")
        worst = max(worst, float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30))
    if not (rel < loss_tol and worst < grad_tol):
        raise AssertionError(f"{tag} kernels vs plain step: loss rel {rel:.3g}, "
                             f"worst gradient leaf {worst:.3g}")
    print(f"{tag} step kernels vs kernels=\"torch\" on the card: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f}, rel {rel:.3g} (< {loss_tol:g}); "
          f"worst gradient leaf {worst:.3g} of its max (< {grad_tol:g})", flush=True)


def _leaf_paths(tree, prefix=""):
    """The parameter paths in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1]


def _grads_twice(tag, trainer, batch, seed):
    """One step's whole flat gradient bitwise the same in two passes from
    the same parameters and generator seed (no step is taken); raises,
    naming the leaves that differ, if it is not."""
    import torch
    grads = [trainer.loss_and_grads(batch, torch.Generator(device="cuda").manual_seed(seed))[1]
             for _ in range(2)]
    differ, off = [], 0
    for path, p in zip(_leaf_paths(trainer.params), trainer.leaves):
        if not torch.equal(grads[0][off:off + p.numel()], grads[1][off:off + p.numel()]):
            differ.append(path)
        off += p.numel()
    B, L = batch["S"].shape
    if differ:
        raise AssertionError(f"{tag}: the flat gradient of one B={B} x L={L} step "
                             f"differs across two passes in the leaves {differ}")
    print(f"{tag}: the flat gradient ({off} entries) of one B={B} x L={L} step is "
          "bitwise equal across two passes from the same state and generator",
          flush=True)


def _embedding_grads_twice(tag, trainer, batch):
    """The token embedding's gradient (``models/mpnn.py::embed_tokens``, the
    one-hot product) bitwise equal across two backward passes of a random
    cotangent at the batch's shape; raises if not."""
    import torch
    from na_mpnn_tpu_torch.models.mpnn import embed_tokens
    emb = trainer.params["W_s"]["emb"].detach().clone().requires_grad_(True)
    S = batch["S"]
    g = torch.randn(S.shape + (emb.shape[1],), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))
    grads = []
    for _ in range(2):
        emb.grad = None
        embed_tokens({"W_s": {"emb": emb}}, S).backward(g)
        grads.append(emb.grad.clone())
    if not torch.equal(grads[0], grads[1]):
        raise AssertionError(f"{tag}: the embedding gradient differs between two passes")

    def one_hot_pass():
        embed_tokens({"W_s": {"emb": emb}}, S).backward(g)

    def index_pass():   # PyTorch's own gather backward (atomics), for comparison
        emb[S.long()].backward(g)

    ms, index_ms = _device_ms(one_hot_pass, "embed_one_hot"), _device_ms(index_pass, "embed_index")
    print(f"{tag}: the embedding gradient [{emb.shape[0]} x {emb.shape[1]}] "
          f"(one-hot product) is bitwise equal across two backward passes; gather "
          f"+ backward: device busy {ms:.4f} ms per pass against {index_ms:.4f} ms "
          f"through PyTorch's index backward (torch.profiler, 5 passes)", flush=True)


def _traced(fn, name, n):
    """``n`` calls of ``fn`` under ``torch.profiler`` (CPU and CUDA
    activity, ending in a synchronise), the Chrome trace written to
    ``build/chip_smoke/<name>.json``; returns ``_trace_summary`` of it. A
    trace that holds no device operation (the profiler missed the card's
    activity, seen once in a run of this script) is taken again, three
    times in all, before ``_trace_summary``'s error stands."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(OUT, f"{name}.json")
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        try:
            return _trace_summary(path, n)
        except AssertionError:
            if attempt == 2:
                raise
            print(f"{name}: the trace holds no device operation; tracing again",
                  flush=True)


def _device_ms(fn, tag, n=5):
    """Device-busy ms per call of ``fn`` (the union of its device intervals
    in a ``torch.profiler`` trace of ``n`` calls, after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    return _traced(fn, tag, n)[1]


def training_phase(nb, fwd_ms, rows):
    """The full-width Trainer on the card: 5 train steps and 1 eval step;
    returns the launches of the whole run, the median step ms and the peak
    bytes of the steps."""
    import dataclasses

    import torch
    from na_mpnn_tpu_torch.ops import LAUNCHES
    from na_mpnn_tpu_torch.train.trainer import (Trainer, model_config_from_params,
                                                 to_device)

    dev = torch.device("cuda")
    cfg = model_config_from_params({"MIXED_PRECISION": 0})
    trainer = Trainer(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    want = _expected_train_launches(cfg)
    step_ms, peak, _ = _train_steps(trainer, nb, want, "train", generator=gen)
    before = dict(LAUNCHES)
    e = trainer.eval_step(nb)
    lpt = e["loss_per_token"]
    if lpt.shape != (8, 768) or not bool(torch.isfinite(lpt).all()):
        raise AssertionError(f"eval step: loss_per_token {tuple(lpt.shape)}")
    eval_counts = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                   if v - before.get(k, 0)}
    if any(k.startswith(("message_table_bwd", "rbf_classed_dw")) for k in eval_counts):
        raise AssertionError(f"eval step launched a backward kernel: {eval_counts}")
    total = dict(LAUNCHES)
    median = float(np.median(step_ms[1:]))
    per_step = sum(fwd_ms.get(k, rows.get(k, {}).get("ms", 0.0)) * n
                   for k, n in want.items())
    print(f"training B=8 L=768 K=32 H=128: {median:.2f} ms per train step "
          f"(median of steps 2-5, host clock, synchronised; all: "
          f"{', '.join(f'{t:.2f}' for t in step_ms)}); peak memory "
          f"{peak / 2**30:.3f} GiB; the kernels' standalone times add to "
          f"{per_step:.2f} ms per step ({100 * per_step / median:.1f}% of it); "
          f"launches per step {want}", flush=True)

    # save -> restore, bitwise
    path = os.path.join(OUT, "train.npz")
    trainer.save(path, epoch=1, save_step=0)
    back = Trainer(cfg, seed=1, device=dev)
    back.restore(path)
    s, r = trainer.opt_state, back.opt_state
    if not (torch.equal(trainer.flat, back.flat) and torch.equal(s.mu, r.mu)
            and torch.equal(s.nu, r.nu) and s.count == r.count == 5
            and s.schedule_count == r.schedule_count and back.step == 5):
        raise AssertionError("save -> restore is not bitwise")
    print("checkpoint: save -> restore bitwise equal (params, mu, nu, counts)",
          flush=True)

    # one step's loss and gradients: kernels against kernels="torch"
    plain = Trainer(dataclasses.replace(cfg, kernels="torch"), seed=0, device=dev)
    plain.restore(path)
    _grads_against_plain("training", trainer, plain, to_device(nb, dev), 7, want)
    _embedding_grads_twice("training", trainer, to_device(nb, dev))
    _grads_twice("training", trainer, to_device(nb, dev), 7)
    return total, median, peak


def _expected_bf16_launches(cfg):
    """A bf16 training step's launches: kNN (fp32 coordinates), then the bf16
    variants only."""
    return {k if k == "knn" else k + "_bf16": n
            for k, n in _expected_train_launches(cfg).items()}


def bf16_training_phase(nb, fp32_ms, fp32_peak):
    """The bf16 trunk on the card: the Trainer of ``model_config_from_params({})``
    (the JAX default, ``MIXED_PRECISION`` 1; dropout 0.1, noise 0.1 A) on the
    B=8 x L=768 batch: 5 train steps with the launches of every step held to
    kNN 1, RBF 1, RBF dW 1, message table 9, its backward 9, all bf16
    variants (no fp32 variant of rows 3, 4, 9, 10), ms per step and peak
    memory against the fp32 step of this run; one eval step (fused route:
    3 + 3 + 3 bf16 launches); the checkpoint's arrays fp32; one step's loss
    and gradients with the kernels against ``kernels="torch"`` (bf16 plain
    versions) on the card: loss within 1e-3 relative, each gradient leaf
    within 3e-2 of its largest entry (the plain path's backward is
    autograd's, whose rounding points differ from the kernels'). Returns
    the launches."""
    import dataclasses

    import torch
    from na_mpnn_tpu_torch.ops import LAUNCHES
    from na_mpnn_tpu_torch.train.trainer import (Trainer, model_config_from_params,
                                                 to_device)

    dev = torch.device("cuda")
    cfg = model_config_from_params({})
    if cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"the default config's compute_dtype is {cfg.compute_dtype}")
    trainer = Trainer(cfg, seed=0, device=dev)
    want = _expected_bf16_launches(cfg)
    step_ms, peak, _ = _train_steps(trainer, nb, want, "bf16 train",
                                    generator=torch.Generator(device=dev).manual_seed(0))
    before = dict(LAUNCHES)
    e = trainer.eval_step(nb)
    lpt = e["loss_per_token"]
    if lpt.shape != (8, 768) or not bool(torch.isfinite(lpt).all()):
        raise AssertionError(f"bf16 eval step: loss_per_token {tuple(lpt.shape)}")
    eval_counts = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                   if v - before.get(k, 0)}
    n_enc, n_dec = cfg.num_encoder_layers, cfg.num_decoder_layers
    eval_want = {"knn": 1, "rbf_classed_bf16": 1, "fused_node_update_enc_bf16": n_enc,
                 "fused_edge_update_bf16": n_enc, "fused_node_update_dec_bf16": n_dec}
    if eval_counts != eval_want:
        raise AssertionError(f"bf16 eval step launches {eval_counts}, want {eval_want}")
    total = dict(LAUNCHES)
    _profile_call(lambda: trainer.eval_step(nb), "eval_bf16_profile",
                  "bf16 eval step B=8 L=768")
    median = float(np.median(step_ms[1:]))
    print(f"bf16 training B=8 L=768 K=32 H=128: {median:.2f} ms per train step "
          f"(median of steps 2-5, host clock, synchronised; all: "
          f"{', '.join(f'{t:.2f}' for t in step_ms)}) against fp32 {fp32_ms:.2f} ms "
          f"({median / fp32_ms:.3f}x); peak memory {peak / 2**30:.3f} GiB against "
          f"fp32 {fp32_peak / 2**30:.3f} GiB; launches per step {want}; eval step "
          f"launches {eval_counts}", flush=True)
    path = os.path.join(OUT, "train_bf16.npz")
    trainer.save(path, epoch=1, save_step=0)
    with np.load(path) as z:
        wide = [k for k in z.files if np.issubdtype(z[k].dtype, np.floating)
                and z[k].dtype != np.float32]
    if wide:
        raise AssertionError(f"bf16 checkpoint: arrays not fp32: {wide[:5]}")
    plain = Trainer(dataclasses.replace(cfg, kernels="torch"), seed=0, device=dev)
    plain.restore(path)
    _grads_against_plain("bf16 training", trainer, plain, to_device(nb, dev), 7, want,
                         loss_tol=1e-3, grad_tol=3e-2)
    _grads_twice("bf16 training", trainer, to_device(nb, dev), 7)
    return total, median, peak


UNBUCKETED_L = 750


def unbucketed_batch():
    """8 synthetic protein-DNA structures of 610-750 residues collated with
    ``use_buckets=False``: B=8, L=750 (750 % 32 = 14), the batch on which
    the JAX training decoder runs rows 7 and 8."""
    from na_mpnn_tpu_torch.data.pdb import parse_pdb
    from na_mpnn_tpu_torch.train.collate import collate_batch
    structs = []
    for i in range(TRAIN_STRUCTURES):
        n = UNBUCKETED_L - 20 * i
        n_dna = 40 + 2 * i
        path = os.path.join(OUT, f"unbucketed{i}.pdb")
        write_synthetic_pdb(path, (("A", "protein", n - 2 * n_dna), ("C", "dna", n_dna),
                                   ("D", "dna", n_dna)), seed=50 + i)
        parsed = parse_pdb(path)
        structs.append({k: parsed[k] for k in TRAIN_KEYS})
    batch = collate_batch(structs, use_buckets=False)
    if batch["S"].shape != (TRAIN_STRUCTURES, UNBUCKETED_L):
        raise AssertionError(f"unbucketed batch {batch['S'].shape}")
    return batch


# Rows 7 and 8's kernels by name in a profile (``csrc/message_mlp.cu``;
# ``csrc/message_mlp_bwd.cu``: the tile walk, the weight gradients and the
# two ordered reductions).
MLP_KERNELS = {"row 7": ("message_mlp_kernel",),
               "row 8": ("mlp_tile_kernel", "mlp_wgrad_kernel", "mlp_reduce_weights",
                         "mlp_reduce_biases")}


def unbucketed_training_phase(nb, low=False):
    """5 full-width Trainer steps (dropout 0.1, noise 0.1 A; fp32, or with
    ``low`` the bf16 trunk of ``model_config_from_params({})``) on the
    unbucketed batch, where the decoder takes the gathered route: launches
    per step kNN 1, RBF 1, RBF dW 1, message table 6 and its backward 6
    (the encoder), ``message_mlp`` 3 and ``message_mlp_bwd`` 3 (the
    decoder), all bf16 variants but the kNN with ``low``; then one step
    with the kernels against ``kernels="torch"`` (fp32: loss < 1e-5, leaves
    < 1e-4; bf16: loss < 1e-3, leaves < 3e-2, the plain path's backward
    being autograd's), the flat gradient bitwise across two passes, and a
    ``torch.profiler`` trace of 3 more steps: the device busy share and
    rows 7 and 8's device ms per step (raises if either row's kernels are
    missing from the trace). Returns the launches, the median step ms and
    the peak bytes."""
    import dataclasses

    import torch
    from na_mpnn_tpu_torch.train.trainer import (Trainer, model_config_from_params,
                                                 to_device)

    dev = torch.device("cuda")
    cfg = model_config_from_params({} if low else {"MIXED_PRECISION": 0})
    tag = "bf16 unbucketed" if low else "unbucketed"
    trainer = Trainer(cfg, seed=0, device=dev)
    want = {k: v for k, v in _expected_train_launches(cfg).items()
            if not k.endswith("dec")}
    want.update(message_mlp=cfg.num_decoder_layers,
                message_mlp_bwd=cfg.num_decoder_layers)
    if low:
        want = {k if k == "knn" else k + "_bf16": n for k, n in want.items()}
    step_ms, peak, counts = _train_steps(
        trainer, nb, want, f"{tag} train",
        generator=torch.Generator(device=dev).manual_seed(0))
    median = float(np.median(step_ms[1:]))
    B, L = nb["S"].shape
    print(f"{tag} training B={B} L={L} K=32 H=128: {median:.2f} ms per train "
          f"step (median of steps 2-5; all: {', '.join(f'{t:.2f}' for t in step_ms)}); "
          f"peak memory {peak / 2**30:.3f} GiB; launches per step {want}", flush=True)
    path = os.path.join(OUT, "unbucketed_bf16.npz" if low else "unbucketed.npz")
    trainer.save(path, epoch=1, save_step=0)
    plain = Trainer(dataclasses.replace(cfg, kernels="torch"), seed=0, device=dev)
    plain.restore(path)
    tols = dict(loss_tol=1e-3, grad_tol=3e-2) if low else {}
    _grads_against_plain(f"{tag} training", trainer, plain, to_device(nb, dev), 7,
                         want, **tols)
    _grads_twice(f"{tag} training", trainer, to_device(nb, dev), 7)
    gen = torch.Generator(device=dev).manual_seed(1)
    window, busy, by_name = _traced(lambda: trainer.train_step(nb, gen),
                                    tag.replace(" ", "_") + "_steps", 3)
    def base(name):     # "void k<...>(...)" -> "k"
        return (name.split("<")[0].split("(")[0].split() or [""])[-1]

    ms = {r: sum(us for n, (_, us) in by_name.items() if base(n) in keys) / 3e3
          for r, keys in MLP_KERNELS.items()}
    launched = {r: sum(c for n, (c, _) in by_name.items() if base(n) in keys) / 3
                for r, keys in MLP_KERNELS.items()}
    if not all(ms.values()):
        raise AssertionError(f"{tag} profile: rows 7 and 8 not found ({ms})")
    print(f"{tag} profile of 3 train steps (torch.profiler): {window:.2f} ms per "
          f"step, device busy {busy:.2f} ms ({100 * busy / window:.1f}%); row 7 "
          f"{ms['row 7']:.3f} ms ({launched['row 7']:.0f} kernels) and row 8 "
          f"{ms['row 8']:.3f} ms ({launched['row 8']:.0f} kernels) of device time per "
          f"step, rows 7 + 8 {ms['row 7'] + ms['row 8']:.3f} ms", flush=True)
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / 3e3:8.3f} ms  {n / 3:5.1f}x  {name[:90]}", flush=True)
    return counts, median, peak


def _trace_summary(path, steps):
    """Device time per step by operation from a ``torch.profiler`` Chrome
    trace: the union of the device intervals (kernels, copies, sets) against
    the trace's span gives the idle share."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in spans if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise AssertionError(f"{path}: the trace holds no device operation")
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    busy, end = 0.0, None
    for e in sorted(dev, key=lambda e: e["ts"]):
        s, t = e["ts"], e["ts"] + e["dur"]
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    by_name = {}
    for e in dev:
        name = e["name"].replace("(anonymous namespace)::", "")
        n, d = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, d + e["dur"])
    return (t1 - t0) / 1e3 / steps, busy / 1e3 / steps, by_name


def _print_profile(profile, tag):
    """The profile's top device operations, rows 3 and 9 wherever they
    rank; raises if PyTorch's index backward (the embedding's gradient
    before it became a one-hot product) is in it."""
    window, busy, by_name = _trace_summary(os.path.join(profile, "train_steps.json"), 3)
    print(f"{tag} profile of 3 train steps (torch.profiler, CUDA activity): "
          f"{window:.2f} ms per step, device busy {busy:.2f} ms "
          f"({100 * busy / window:.1f}%), idle {100 * (1 - busy / window):.1f}%; "
          f"top device operations per step:", flush=True)
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 1e3 / 3:8.3f} ms  {n / 3:5.1f}x  {name[:90]}", flush=True)
    for key in ("rbf_fwd_groups", "message_table_kernel"):
        for name, (n, us) in by_name.items():
            if key in name:
                print(f"  {tag} {key}: {us / 1e3 / 3:.3f} ms per step, {n / 3:.1f}x "
                      f"({name[:60]})", flush=True)
    if any("indexing_backward_kernel" in name for name in by_name):
        raise AssertionError(f"{tag} profile: indexing_backward_kernel is in it")
    print(f"  {tag}: no indexing_backward_kernel in the profile", flush=True)


def _loop_epochs(run):
    """The log lines of a ``run_training`` folder: (log.jsonl records, the
    printed per-epoch summaries)."""
    with open(os.path.join(run, "log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    with open(os.path.join(run, "log.txt")) as f:
        text = f.read().splitlines()[1:]
    per_epoch = []
    for r, line in zip(logs, text):
        fields = dict(kv.split(": ") for kv in line.split(", ")[2:4])
        train_s = float(fields["train_time"])
        per_epoch.append(f"epoch {r['epoch']}: train {train_s:.2f} s, valid "
                         f"{float(fields['valid_time']):.2f} s, {r['steps']} steps, "
                         f"{1e3 * train_s / r['steps']:.1f} ms per step, loader "
                         f"wait {r['loader_wait_s']:.3f} s, train loss "
                         f"{r['train_loss']:.4f}")
    return logs, text, per_epoch


def training_loop_phase():
    """The training loop as a user runs it: 16 synthetic protein-DNA PDBs of
    300-700 residues under ``build/chip_smoke/train_data``, the port's
    ``cli/preprocess`` over them, the training CSV, then ``run_training`` on
    the card at the reference regime (6000-token batches, 2 loader workers,
    fp32) for 2 epochs with a profiler capture of 3 steps, and resumed from
    its ``last.npz`` for 1 more. Checks the logs and the checkpoint, that
    the resumed epoch starts at the saved step, and that no bucketed batch
    launched ``message_mlp``. Prints seconds per epoch, ms per step inside
    the loop, the loader's wait and the profile's top device operations.
    Returns the launches and the training CSV."""
    import shutil

    import torch
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches
    from na_mpnn_tpu_torch.train.trainer import run_training

    data = os.path.join(OUT, "train_data")
    run = os.path.join(OUT, "train_loop")
    for d in (data, run):
        if os.path.exists(d):
            shutil.rmtree(d)
    structures = []
    for i in range(16):
        n = 300 + (400 * i) // 15
        d = 20 + 2 * i
        structures.append((("A", "protein", n - 2 * d), ("B", "dna", d), ("C", "dna", d)))
    t0 = time.time()
    csv_path = write_training_set(data, structures, seed=100)
    prep_s = time.time() - t0
    profile = os.path.join(run, "profile")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    run_training(training_config(csv_path, run, NUM_WORKERS=2, PROFILE_DIR=profile),
                 max_epochs=2, device="cuda")
    first_s = time.time() - t0
    last = os.path.join(run, "last.npz")
    t0 = time.time()
    run_training(training_config(csv_path, run, NUM_WORKERS=2, PREV_CHECKPOINT=last),
                 max_epochs=1, device="cuda")
    resume_s = time.time() - t0
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    for name in ("log.txt", "log.jsonl", "last.npz"):
        if not os.path.exists(os.path.join(run, name)):
            raise AssertionError(f"training loop: {name} missing")
    logs, text, per_epoch = _loop_epochs(run)
    if [r["epoch"] for r in logs] != [1, 2, 3] or len(text) != 3:
        raise AssertionError(f"training loop: epochs logged {[r['epoch'] for r in logs]}")
    if logs[2]["step"] - logs[2]["steps"] != logs[1]["step"]:
        raise AssertionError(f"resumed epoch starts at step "
                             f"{logs[2]['step'] - logs[2]['steps']}, saved "
                             f"{logs[1]['step']}")
    if not all(np.isfinite(r["train_loss"]) and np.isfinite(r["valid_loss"])
               for r in logs):
        raise AssertionError("training loop: a logged loss is not finite")
    if any(k.startswith("message_mlp") for k in counts) or not counts.get("knn"):
        raise AssertionError(f"training loop on bucketed batches: launches {counts}")
    print(f"training loop (16 structures of 300-700 residues, preprocessed in "
          f"{prep_s:.1f} s; run_training 2 epochs {first_s:.1f} s, resumed 1 epoch "
          f"{resume_s:.1f} s): " + "; ".join(per_epoch) + f"; launches {counts}",
          flush=True)
    _print_profile(profile, "fp32 loop")
    return counts, csv_path


def bf16_loop_phase(csv_path):
    """``run_training`` on the card from the fp32 loop's training set with a
    config that omits ``MIXED_PRECISION`` (the bf16 trunk): 1 epoch, 2
    loader workers, a profiler capture of 3 steps. Checks the log, that only
    bf16 variants of rows 3, 4, 9 and 10 launched (no fp32 variant, no
    ``message_mlp``), and prints the epoch and the profile's top device
    operations. Returns the launches."""
    import shutil

    import torch
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches
    from na_mpnn_tpu_torch.train.trainer import run_training

    run = os.path.join(OUT, "train_loop_bf16")
    if os.path.exists(run):
        shutil.rmtree(run)
    profile = os.path.join(run, "profile")
    cfg = training_config(csv_path, run, NUM_WORKERS=2, PROFILE_DIR=profile)
    del cfg["MIXED_PRECISION"]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    trainer = run_training(cfg, max_epochs=1, device="cuda")
    torch.cuda.synchronize()
    loop_s = time.time() - t0
    counts = {k: v for k, v in LAUNCHES.items() if v}
    if trainer.cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"bf16 loop: compute_dtype {trainer.cfg.compute_dtype}")
    fp32_rows = ("rbf_classed", "rbf_classed_dw", "message_table_enc_node",
                 "message_table_enc_edge", "message_table_dec",
                 "message_table_bwd_enc_node", "message_table_bwd_enc_edge",
                 "message_table_bwd_dec", "message_mlp", "message_mlp_bwd")
    if any(counts.get(k) for k in fp32_rows) or not counts.get("rbf_classed_dw_bf16"):
        raise AssertionError(f"bf16 loop: launches {counts}")
    logs, text, per_epoch = _loop_epochs(run)
    if [r["epoch"] for r in logs] != [1] or not np.isfinite(logs[0]["train_loss"]):
        raise AssertionError(f"bf16 loop: log {logs}")
    print(f"bf16 training loop (the fp32 loop's 16 structures; run_training 1 epoch "
          f"{loop_s:.1f} s): " + "; ".join(per_epoch) + f"; launches {counts}",
          flush=True)
    _print_profile(profile, "bf16 loop")
    return counts


def mesh_kernel_phase(nb):
    """The kernels of the multi-device slice against their plain versions
    on the card at the training shape (B=8, L=768, K=32, H=128): the
    query/key kNN (row 2) for a quarter shard (Lq = 192) and the whole
    structure (Lq = 768) against Lk = 768, E_idx exact; the dense RBF
    projection (row 5, relative error < 1e-5) and its weight gradient (row
    6, < 1e-4 of its max), each bitwise across two launches and bitwise
    rows 3 and 4's results on the same operands (one instantiation of the
    group walks at fp32); the message table and its backward (rows 9, 10)
    for a 192-row shard against the 768-row table. Returns the JSON rows of
    rows 2, 5 and 6."""
    import torch
    from na_mpnn_tpu_torch.models import init_params
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.models.features import build_augmented_atoms
    from na_mpnn_tpu_torch.ops import knn, message_kernels as mk, rbf_classed, rbf_edge
    from na_mpnn_tpu_torch.train.trainer import to_device

    dev = torch.device("cuda")
    cfg = ModelConfig()
    H, K = cfg.hidden_dim, cfg.k_neighbors
    batch = to_device(nb, dev)
    X_aug, X_m_aug, X_ref = build_augmented_atoms(batch["X"], batch["X_m"],
                                                  batch, cfg)
    mask = batch["mask"].float()
    B, L = mask.shape
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    _, E_all = knn.knn_graph_cuda(X_ref, mask, K)
    for Lq in (192, 768):
        s0 = 192 if Lq == 192 else 0        # the second of four shards
        Xq = X_ref[:, s0:s0 + Lq].contiguous()
        mq = mask[:, s0:s0 + Lq].contiguous()
        D_k, E_k = knn.knn_graph_qk_cuda(Xq, X_ref, mq, mask, K)
        D_p, E_p = knn.knn_graph_qk_plain(Xq, X_ref, mq, mask, K)
        if not (torch.equal(E_k, E_p) and torch.equal(E_k, E_all[:, s0:s0 + Lq])
                and torch.equal(D_k, D_p)):
            raise AssertionError(f"knn_qk Lq={Lq}: E_idx or D differs from the plain "
                                 "version, or E_idx from the structure's rows")
        err = float((D_k - D_p).abs().max())
        ms = _sync_time(lambda: knn.knn_graph_qk_cuda(Xq, X_ref, mq, mask, K), 10)
        plain_ms = _sync_time(lambda: knn.knn_graph_qk_plain(Xq, X_ref, mq, mask, K), 3)
        bound = _knn_bound(B, Lq, K, Lk=L)
        print(f"knn_qk B={B} Lq={Lq} Lk={L} K={K}: E_idx and D exact (E_idx also "
              f"against the structure's rows), max|dD|={err:.3g}, {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]})", flush=True)
        if Lq == L:
            rows["knn_qk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound[0], bound_by=bound[1])
    knn_hard_cases(qk=True)

    # rows 5 and 6 on the dense Trainer's operands: at fp32 the classed
    # walks' instantiations, so rows 3 and 4's bits on the same operands
    params = init_params(1, cfg, device=dev)
    W = params["features"]["edge_embedding"]["w"][cfg.num_positional_embeddings:]
    E_idx = E_all
    bound = _rbf_bound(X_aug, X_m_aug, E_idx, H)
    E = E_idx.numel()
    grid_ms = 1e3 * 2 * E * 18 * 18 * 16 * H / PEAK_FP32_FLOPS
    out_k = rbf_edge.rbf_edge_cuda(X_aug, X_m_aug, E_idx, W)
    out_p = rbf_edge.rbf_edge_features_plain(X_aug, X_m_aug, E_idx, W)
    rel = _rel_err(out_k, out_p)
    if not rel < REL_TOL:
        raise AssertionError(f"rbf_edge: relative error {rel:.3g}")
    if not torch.equal(out_k, rbf_edge.rbf_edge_cuda(X_aug, X_m_aug, E_idx, W)):
        raise AssertionError("rbf_edge: two identical launches differ")
    if not torch.equal(out_k, rbf_classed.rbf_edge_features_classed_cuda(
            X_aug, X_m_aug, E_idx, W)):
        raise AssertionError("rbf_edge: not the bits of rbf_classed on the same operands")
    err = float((out_k - out_p).abs().max())
    del out_k, out_p
    ms = _sync_time(lambda: rbf_edge.rbf_edge_cuda(X_aug, X_m_aug, E_idx, W), 5)
    plain_ms = _sync_time(lambda: rbf_edge.rbf_edge_features_plain(
        X_aug, X_m_aug, E_idx, W), 2)
    print(f"rbf_edge (dense) B={B} L={L} K={K} H={H}: rel err {rel:.3g} "
          f"(< {REL_TOL}), two launches bitwise equal, bitwise rbf_classed's "
          f"output, {ms:.4f} ms (scalar-FMA form, PERF.md: {SCALAR_MS['rbf_edge']} "
          f"ms; plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]}; the "
          f"full 18x18x16 grid {grid_ms:.4f} ms at 67 TFLOP/s)", flush=True)
    rows["rbf_edge"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound[0], bound_by=bound[1])
    g = torch.randn((B, L, K, H), generator=gen, device=dev)
    dw_k = rbf_edge.rbf_edge_dw_cuda(X_aug, X_m_aug, E_idx, g)
    dw_k2 = rbf_edge.rbf_edge_dw_cuda(X_aug, X_m_aug, E_idx, g)
    dw_p = rbf_edge.rbf_edge_dw_plain(X_aug, X_m_aug, E_idx, g)
    rel = _rel_err(dw_k, dw_p)
    if not rel < 1e-4:
        raise AssertionError(f"rbf_edge_dw: relative error {rel:.3g}")
    if not torch.equal(dw_k, dw_k2):
        raise AssertionError("rbf_edge_dw: two identical launches differ")
    if not torch.equal(dw_k, rbf_classed.rbf_classed_dw_cuda(X_aug, X_m_aug, E_idx, g)):
        raise AssertionError("rbf_edge_dw: not the bits of rbf_classed_dw on the "
                             "same operands")
    ms = _sync_time(lambda: rbf_edge.rbf_edge_dw_cuda(X_aug, X_m_aug, E_idx, g), 5)
    plain_ms = _sync_time(lambda: rbf_edge.rbf_edge_dw_plain(X_aug, X_m_aug, E_idx, g), 2)
    print(f"rbf_edge_dw (dense) B={B} L={L} K={K} H={H}: rel err {rel:.3g} "
          f"(< 1e-4), two launches bitwise equal, bitwise rbf_classed_dw's "
          f"result, {ms:.4f} ms (scalar-FMA form, PERF.md: "
          f"{SCALAR_MS['rbf_edge_dw']} ms; plain {plain_ms:.4f} ms, bound "
          f"{bound[0]:.5f} ms by {bound[1]}; the full grid {grid_ms:.4f} ms)",
          flush=True)
    rows["rbf_edge_dw"] = dict(max_abs_err=float((dw_k - dw_p).abs().max()),
                               ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                               bound_by=bound[1])
    del dw_k, dw_k2, dw_p, g

    # rows 9 and 10: the second of four 192-row shards against the table
    # of the whole structure (Lk = 768)
    Lq, s0 = 192, 192
    N = B * Lq
    eidx2 = E_all[:, s0:s0 + Lq].reshape(-1).contiguous()
    h_V2 = torch.randn((N, H), generator=gen, device=dev)
    h_E2 = torch.randn((N * K, H), generator=gen, device=dev)
    m_att = (torch.rand((N * K,), generator=gen, device=dev) > 0.1).float()
    m1d = (torch.rand((N * K,), generator=gen, device=dev) > 0.2).float()
    mbw = m1d * (torch.rand((N * K,), generator=gen, device=dev) > 0.5).float()
    ones = torch.ones_like(m_att)
    order = mk.table_order(eidx2, K, Lq, L, B * L)
    for mode, ma, mb in (("enc_node", m_att, ones), ("enc_edge", ones, ones),
                         ("dec", m1d, mbw)):
        C = 2 * H if mode == "dec" else H
        table = torch.randn((B * L, C), generator=gen, device=dev)
        wa, wb, w2, w3 = (torch.randn((H, H), generator=gen, device=dev) / H ** 0.5
                          for _ in range(4))
        b1, b2, b3 = (torch.randn((H,), generator=gen, device=dev) for _ in range(3))
        args = (mode, h_V2, h_E2, table, eidx2, ma, mb, wa, wb, b1, w2, b2, w3, b3)
        out_k, x_k = mk.message_table_cuda(*args, K=K, L=Lq, Lk=L, save_x=True)
        out_p, x_p = mk.message_table_plain(*args, K=K, L=Lq, Lk=L, save_x=True)
        fwd = max(_rel_err(out_k, out_p), _rel_err(x_k, x_p))
        if not fwd < REL_TOL:
            raise AssertionError(f"message_table {mode} Lk != L: rel err {fwd:.3g}")
        _table_fwd_bitwise(f"message_table {mode} Lk != L", args, out_k, x_k, K=K,
                           L=Lq, Lk=L)
        lo = [t.to(torch.bfloat16) if torch.is_tensor(t) and t.is_floating_point()
              else t for t in args]
        lo_k, lo_x = mk.message_table_cuda(*lo, K=K, L=Lq, Lk=L, save_x=True)
        lo_p, lo_xp = mk.message_table_plain(*lo, K=K, L=Lq, Lk=L, save_x=True)
        lo_err = max(_rel_err(lo_k.float(), lo_p.float()),
                     _rel_err(lo_x.float(), lo_xp.float()))
        if not lo_err < BF16_TOL:
            raise AssertionError(f"message_table {mode} bf16 Lk != L: rel err {lo_err:.3g}")
        _table_fwd_bitwise(f"message_table {mode} bf16 Lk != L", lo, lo_k, lo_x, K=K,
                           L=Lq, Lk=L)
        del lo, lo_k, lo_x, lo_p, lo_xp
        g = torch.randn((N * K if mode == "enc_edge" else N, H), generator=gen,
                        device=dev)
        bargs = (mode, h_V2, h_E2, x_k, eidx2, ma, mb, wa, wb, b1, w2, b2, w3, b3, g)
        got = [t.clone() for t in mk.message_table_bwd_cuda(*bargs, K=K, L=Lq, Lk=L)]
        again = mk.message_table_bwd_cuda(*bargs, K=K, L=Lq, Lk=L, order=order)
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"message_table_bwd {mode} Lk != L: two "
                                 "launches differ")
        want = mk.message_table_bwd_plain(*bargs, K=K, L=Lq, Lk=L)
        errs = [_rel_err(a, b) for a, b in zip(got, want)]
        if not (max(errs[:2]) < REL_TOL and max(errs) < 1e-4):
            raise AssertionError(f"message_table_bwd {mode} Lk != L: rel errs {errs}")
        ms = _sync_time(lambda: mk.message_table_cuda(*args, K=K, L=Lq, Lk=L,
                                                      save_x=True), 10)
        bms = _sync_time(lambda: mk.message_table_bwd_cuda(*bargs, K=K, L=Lq, Lk=L,
                                                           order=order), 10)
        print(f"message_table {mode} shard Lq={Lq} of Lk={L} (B={B}): forward rel "
              f"err {fwd:.3g} (< {REL_TOL}; bf16 {lo_err:.3g} < {BF16_TOL:.3g}; "
              f"both bitwise across launches and without x), {ms:.4f} ms; "
              f"backward worst rel err "
              f"{max(errs):.3g} (g_hV, g_ein < {REL_TOL}; g_table {errs[2]:.3g} "
              f"[{B * L} x {C}]; two launches bitwise equal), {bms:.4f} ms with the "
              f"order given", flush=True)
        del got, again, want, out_p, x_p
    return rows


def _count_since(before):
    from na_mpnn_tpu_torch.ops import LAUNCHES
    return {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
            if v - before.get(k, 0)}


def dense_inference_phase(pdb):
    """``rbf_mode="dense"`` through the model API at the main path's
    structure (L=389): encode + sample (B=1) and score (B=10), log-probs
    against ``kernels="torch"`` on the card (< 1e-4, sampled tokens equal
    under the same decode order and Gumbel noise); host-clock ms of encode
    and score. Returns the launches of the kernel runs."""
    import dataclasses

    import torch
    from na_mpnn_tpu_torch.data.featurize import featurize_inference
    from na_mpnn_tpu_torch.data.pdb import parse_pdb
    from na_mpnn_tpu_torch.models import encode, init_params, sample, score
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches

    dev = torch.device("cuda")
    cfg = ModelConfig(rbf_mode="dense")
    plain = dataclasses.replace(cfg, kernels="torch")
    params = init_params(0, cfg, device=dev)
    parsed = parse_pdb(pdb)
    L = len(parsed["S"])
    batch = featurize_inference(parsed, np.ones(L, np.int32), device=dev)
    batch["decoding_order"] = torch.randperm(
        L, generator=torch.Generator().manual_seed(3)).to(dev)[None]
    tiled = {k: v.repeat_interleave(10, 0) for k, v in batch.items()}
    gumbel = -torch.log(-torch.log(torch.rand(
        (L, 1, 33), generator=torch.Generator().manual_seed(4)).clamp_min(1e-30))).to(dev)
    torch.cuda.synchronize()
    reset_launches()
    encode(params, cfg, batch)
    out_k = sample(params, cfg, batch, None, gumbel=gumbel)
    lp_k = score(params, cfg, tiled, decoding_order=tiled["decoding_order"])["log_probs"]
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    if counts.get("rbf_edge", 0) != 3 or counts.get("rbf_classed", 0):
        raise AssertionError(f"dense inference: launches {counts}")
    reset_launches()
    out_p = sample(params, plain, batch, None, gumbel=gumbel)
    lp_p = score(params, plain, tiled, decoding_order=tiled["decoding_order"])["log_probs"]
    if any(LAUNCHES.values()):
        raise AssertionError(f"dense kernels='torch' launched {dict(LAUNCHES)}")
    d_sample = float((out_k["log_probs"] - out_p["log_probs"]).abs().max())
    d_score = float((lp_k - lp_p).abs().max())
    if not (torch.equal(out_k["S"], out_p["S"]) and d_sample < 1e-4 and d_score < 1e-4):
        raise AssertionError(f"dense inference vs plain: tokens equal "
                             f"{torch.equal(out_k['S'], out_p['S'])}, max |d log p| "
                             f"sample {d_sample:.3g}, score {d_score:.3g}")
    _check_finite(lp_k.cpu(), (10, L, 33), "dense score log_probs")
    before = dict(LAUNCHES)
    enc_ms = _host_ms(lambda: encode(params, cfg, batch), 10)
    score_ms = _host_ms(lambda: score(params, cfg, tiled,
                                      decoding_order=tiled["decoding_order"]), 5)
    timed = _count_since(before)
    print(f"dense inference L={L}: encode + sample (B=1) + score (B=10) launched "
          f"{counts}; kernels vs kernels=\"torch\": tokens equal, max |d log p| "
          f"sample {d_sample:.3g}, score {d_score:.3g} (< 1e-4); encode B=1 "
          f"{enc_ms:.2f} ms, score B=10 {score_ms:.2f} ms (host clock; timing "
          f"runs launched {timed})", flush=True)
    return counts


def _expected_dense_launches(cfg):
    want = _expected_train_launches(cfg)
    del want["rbf_classed"], want["rbf_classed_dw"]
    return {**want, "rbf_edge": 1, "rbf_edge_dw": 1}


def dense_training_phase(nb, low=False):
    """5 full-width Trainer steps with ``rbf_mode="dense"`` (launches per
    step: kNN 1, dense RBF 1, its weight gradient 1, message table 9, its
    backward 9; with ``low`` the bf16 trunk, every one but the kNN a bf16
    variant, and then one step with the kernels against ``kernels="torch"``
    at bf16: loss < 1e-3, leaves < 3e-2); then a ``torch.profiler`` trace of
    3 more steps for rows 5 and 6's device ms per step. Returns the
    launches, the median step ms and the peak bytes."""
    import dataclasses

    import torch
    from na_mpnn_tpu_torch.train.trainer import (Trainer, model_config_from_params,
                                                 to_device)

    cfg = dataclasses.replace(
        model_config_from_params({} if low else {"MIXED_PRECISION": 0}),
        rbf_mode="dense")
    tag = "bf16 dense" if low else "dense"
    trainer = Trainer(cfg, seed=0, device="cuda")
    want = _expected_dense_launches(cfg)
    if low:
        want = {k if k == "knn" else k + "_bf16": n for k, n in want.items()}
    step_ms, peak, counts = _train_steps(
        trainer, nb, want, f"{tag} train",
        generator=torch.Generator(device="cuda").manual_seed(0))
    median = float(np.median(step_ms[1:]))
    print(f"{tag} training B=8 L=768 K=32 H=128: {median:.2f} ms per train step "
          f"(median of steps 2-5; all: {', '.join(f'{t:.2f}' for t in step_ms)}); "
          f"peak memory {peak / 2**30:.3f} GiB; launches per step {want}",
          flush=True)
    if low:
        path = os.path.join(OUT, "dense_bf16.npz")
        trainer.save(path, epoch=1, save_step=0)
        plain = Trainer(dataclasses.replace(cfg, kernels="torch"), seed=0,
                        device="cuda")
        plain.restore(path)
        _grads_against_plain(f"{tag} training", trainer, plain,
                             to_device(nb, "cuda"), 7, want, loss_tol=1e-3,
                             grad_tol=3e-2)
    # rows 5 and 6 on the device in 3 more steps, after the check above
    # (which starts from the timed steps' state): the forward walk and the
    # classify kernel that lists its edges; the weight-gradient walk and its
    # ordered reduction
    gen = torch.Generator(device="cuda").manual_seed(1)
    window, busy, by_name = _traced(lambda: trainer.train_step(nb, gen),
                                    tag.replace(" ", "_") + "_steps", 3)
    parts = {"row 5": ("rbf_fwd_groups", "classify_kernel"),
             "row 6": ("rbf_dw_groups", "dw_reduce")}
    ms = {r: sum(us for n, (_, us) in by_name.items() if n.split("<")[0].split("(")[0]
                 .endswith(keys)) / 3e3 for r, keys in parts.items()}
    if not all(ms.values()):
        raise AssertionError(f"{tag} profile: rows 5 and 6 not found ({ms})")
    print(f"{tag} profile of 3 train steps (torch.profiler): {window:.2f} ms per "
          f"step, device busy {busy:.2f} ms ({100 * busy / window:.1f}%); row 5 "
          f"{ms['row 5']:.3f} ms and row 6 {ms['row 6']:.3f} ms of device time per "
          f"step", flush=True)
    return counts, median, peak


def _stream_cost(cfg, nb):
    """The random draws of one training step at the training shape, timed
    alone (CUDA events): the mesh route's row-keyed streams (noise, decode
    order, dropout on 3 edge messages and 12 node tensors) against the
    one-device route's ``torch.Generator`` draws of the same shapes."""
    import torch
    from na_mpnn_tpu_torch.models.modules import dropout
    from na_mpnn_tpu_torch.parallel import graph_parallel as gp

    dev = torch.device("cuda")
    B, L = nb["S"].shape
    H, K, A = cfg.hidden_dim, cfg.k_neighbors, nb["X"].shape[2]
    n_node = 2 * (cfg.num_encoder_layers + cfg.num_decoder_layers)
    rid = torch.arange(B * L, device=dev).view(B, L)
    edge = torch.randn((B, L, K * H), device=dev)
    node = torch.randn((B, L, H), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rows():
        gp.row_normal((0, 1), gp.TAG_NOISE, rid, (A, 3), torch.float32)
        gp.row_normal((0, 1), gp.TAG_ORDER, rid, (), torch.float32)
        for i in range(cfg.num_encoder_layers):
            gp.row_dropout(cfg.dropout, (0, 1), 200 + i, rid)(edge, 2)
        for i in range(n_node):
            gp.row_dropout(cfg.dropout, (0, 1), 300 + i, rid)(node, 0)

    def generator():
        torch.randn((B, L, A, 3), generator=gen, device=dev)
        torch.randn((B, L), generator=gen, device=dev)
        for _ in range(cfg.num_encoder_layers):
            dropout(edge, cfg.dropout, gen)
        for _ in range(n_node):
            dropout(node, cfg.dropout, gen)

    row_ms, gen_ms = _sync_time(rows, 5), _sync_time(generator, 5)
    print(f"random draws of one training step B={B} L={L}: row-keyed streams "
          f"{row_ms:.2f} ms, torch.Generator draws {gen_ms:.2f} ms (difference "
          f"{row_ms - gen_ms:.2f} ms)", flush=True)


# ---------------------------------------------------------------------------
# The graph-parallel sampler, remat, the other atom frames
# ---------------------------------------------------------------------------

SAMPLER_6144 = (("A", "protein", 2000), ("B", "protein", 2000), ("C", "dna", 1072),
                ("D", "dna", 1072))
ENCODE_LAUNCHES = {"knn_qk": 1, "rbf_classed": 1, "fused_node_update_enc": 3,
                   "fused_edge_update": 3}


def _timed(fn):
    """(``fn()``, host seconds to its end, synchronised, peak bytes
    allocated during it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def graph_sampler_phase(pdb, mesh):
    """``sample_graph_parallel`` on the one-rank mesh against the one-device
    ``sample`` from the same generator seed (fp32, released width): design
    (B=1, T=0.1) and specificity (B=30, T=0.6) on the 389-residue complex
    and design on a 6144-residue structure (the largest bucket). Decode
    orders and tokens equal, ``sampling_probs`` within 2e-4 and
    ``log_probs`` within 2e-3 (JAX's bars, ``tests/test_graph_parallel.py:
    233-237``); the encode's launches held to knn_qk 1, rbf_classed 1, fused
    3 + 3 + 0; seconds per structure and peak memory of both. Then the
    key-chunked plain kNN (chunks of 1000) against the one-shot plain kNN
    at L = 6144: ``E_idx`` and ``D`` bitwise. Returns the launches."""
    import torch
    import torch.distributed as dist
    from na_mpnn_tpu_torch.models import init_params, sample
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches
    from na_mpnn_tpu_torch.ops.knn import knn_graph_qk_plain
    from na_mpnn_tpu_torch.parallel.graph_parallel import (_knn_local_rows,
                                                           sample_graph_parallel)
    from na_mpnn_tpu_torch.train.trainer import model_config_from_params

    dev = torch.device("cuda")
    cfg = model_config_from_params({"MIXED_PRECISION": 0})
    params = init_params(6, cfg, device=dev)
    big = os.path.join(OUT, "sampler6144.pdb")
    write_synthetic_pdb(big, SAMPLER_6144, seed=3)
    counts = {}

    def gen():
        return torch.Generator(device=dev).manual_seed(11)

    # the graph group's communicator starts here, before the timed calls
    dist.all_reduce(torch.zeros(1, device=dev), group=mesh.graph_group)
    for tag, path, B, T in (("design", pdb, 1, 0.1), ("specificity", pdb, 30, 0.6),
                            ("design L=6144", big, 1, 0.1)):
        batch = _structure(path, dev)[0]
        L = batch["S"].shape[1]
        reset_launches()
        gp, gp_s, gp_peak = _timed(lambda: sample_graph_parallel(
            params, cfg, batch, gen(), mesh, num_samples=B, temperature=T))
        enc = {k: v for k, v in LAUNCHES.items() if v}
        if enc != ENCODE_LAUNCHES:
            raise AssertionError(f"graph sampler {tag}: encode launches {enc}, "
                                 f"want {ENCODE_LAUNCHES}")
        for k, v in enc.items():
            counts[k] = counts.get(k, 0) + v
        one, one_s, one_peak = _timed(lambda: sample(
            params, cfg, batch, gen(), num_samples=B, temperature=T))
        if not (torch.equal(gp["S"], one["S"])
                and torch.equal(gp["decoding_order"], one["decoding_order"])):
            raise AssertionError(f"graph sampler {tag}: tokens or order differ "
                                 "from sample")
        dp = float((gp["sampling_probs"] - one["sampling_probs"]).abs().max())
        dl = float((gp["log_probs"] - one["log_probs"]).abs().max())
        if not (dp < 2e-4 and dl < 2e-3):
            raise AssertionError(f"graph sampler {tag}: probs {dp:.3g}, log "
                                 f"probs {dl:.3g}")
        print(f"graph sampler (1,1) NCCL, {tag} B={B} L={L} T={T}: "
              f"sample_graph_parallel {gp_s:.3f} s ({1e3 * gp_s / L:.3f} ms per "
              f"decode step), peak {gp_peak / 2**30:.3f} GiB; sample {one_s:.3f} s "
              f"({1e3 * one_s / L:.3f} ms per step), peak {one_peak / 2**30:.3f} "
              f"GiB; tokens and order equal, max |d p| {dp:.3g} (< 2e-4), max "
              f"|d log p| {dl:.3g} (< 2e-3); encode launches {enc}", flush=True)
    _, X_aug, X_m_aug, X_ref, mask = _structure(big, dev)
    (D1, I1), chunk_s, chunk_peak = _timed(
        lambda: _knn_local_rows(X_ref, X_ref, mask, mask, 32, 1000))
    (D0, I0), one_s, one_peak = _timed(
        lambda: knn_graph_qk_plain(X_ref, X_ref, mask, mask, 32))
    if not (torch.equal(I1, I0) and torch.equal(D1, D0)):
        raise AssertionError("key-chunked kNN at L=6144 differs from the one-shot kNN")
    print(f"key-chunked plain kNN L={X_ref.shape[1]} K=32, chunks of 1000: E_idx and "
          f"D bitwise the one-shot plain kNN; {1e3 * chunk_s:.2f} ms, peak "
          f"{chunk_peak / 2**30:.3f} GiB against one-shot {1e3 * one_s:.2f} ms, "
          f"peak {one_peak / 2**30:.3f} GiB", flush=True)
    return counts


def remat_phase(nb, ub):
    """Per-layer rematerialisation (``remat="layer"``) against ``"none"``:
    one step of the classed B=8 x L=768 trainer at fp32 and bf16 and of the
    unbucketed L=750 trainer at fp32 (dropout 0.1, noise 0.1 A, generator
    seed 7): the loss and the whole flat gradient bitwise equal and the
    same launches (no kernel runs again in the backward); then 5 train
    steps of each setting, ms per step (median of steps 2-5) and peak GiB,
    and for the classed steps a ``torch.profiler`` trace of 3 more steps of
    each: the step's window and the device's busy ms (what the
    recomputation costs on the device, and what it costs the host).
    Returns the launches."""
    import dataclasses

    import torch
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches
    from na_mpnn_tpu_torch.train.trainer import Trainer, model_config_from_params

    dev = torch.device("cuda")
    counts = {}
    for tag, batch, low in (("classed", nb, False), ("classed bf16", nb, True),
                            ("unbucketed", ub, False)):
        cfg = model_config_from_params({} if low else {"MIXED_PRECISION": 0})
        res = {}
        for remat in ("none", "layer"):
            tr = Trainer(dataclasses.replace(cfg, remat=remat), seed=0, device=dev)
            b = tr.device_batch(batch)
            reset_launches()
            loss, grad = tr.loss_and_grads(
                b, torch.Generator(device=dev).manual_seed(7))[:2]
            torch.cuda.synchronize()
            want = {k: v for k, v in LAUNCHES.items() if v}
            del b
            gen = torch.Generator(device=dev).manual_seed(8)
            step_ms, peak, _ = _train_steps(tr, batch, want, f"remat={remat} {tag}",
                                            generator=gen)
            for k, v in want.items():
                counts[k] = counts.get(k, 0) + 6 * v
            trace = ""
            if tag.startswith("classed"):
                window, busy, _ = _traced(lambda: tr.train_step(batch, gen),
                                          f"remat_{remat}_{tag.replace(' ', '_')}", 3)
                trace = f"{remat} {window:.2f} ms window, {busy:.2f} ms busy"
            res[remat] = (loss, grad, want, float(np.median(step_ms[1:])), peak, trace)
        (l0, g0, w0, ms0, pk0, tr0), (l1, g1, w1, ms1, pk1, tr1) = res["none"], res["layer"]
        if not (torch.equal(l0, l1) and torch.equal(g0, g1)):
            raise AssertionError(f"remat {tag}: loss or flat gradient differs from "
                                 "remat='none'")
        if w0 != w1:
            raise AssertionError(f"remat {tag}: launches {w1} != {w0}")
        B, L = batch["S"].shape
        print(f"remat {tag} B={B} L={L}: loss {float(l0):.6f} and flat gradient "
              f"({g0.numel()} entries) bitwise equal to remat='none', the same "
              f"launches {w0}; ms per train step (median of steps 2-5) none "
              f"{ms0:.2f}, layer {ms1:.2f}; peak none {pk0 / 2**30:.3f} GiB, layer "
              f"{pk1 / 2**30:.3f} GiB"
              + (f"; profile of 3 steps, per step: {tr0}; {tr1}" if tr0 else ""),
              flush=True)
    return counts


def atom65_batch(sizes, tag, pad_to=None):
    """Synthetic protein-DNA structures of ``sizes`` residues, parsed with
    their 65-atom table (``xyz_65``: the synthetic files carry backbone
    atoms only, so the other slots are absent) and collated."""
    from na_mpnn_tpu_torch.data.pdb import parse_pdb
    from na_mpnn_tpu_torch.train.collate import collate_batch
    structs = []
    for i, n in enumerate(sizes):
        n_dna = 40 + 2 * i
        path = os.path.join(OUT, f"{tag}{i}.pdb")
        write_synthetic_pdb(path, (("A", "protein", n - 2 * n_dna), ("C", "dna", n_dna),
                                   ("D", "dna", n_dna)), seed=70 + i)
        parsed = parse_pdb(path)
        s = {k: parsed[k] for k in TRAIN_KEYS}
        s["X"], s["X_m"] = parsed["xyz_65"], parsed["xyz_65_m"]
        structs.append(s)
    return collate_batch(structs, pad_to=pad_to)


def atom_frame_phase(nb, mesh):
    """The frames the RBF kernels do not take (``PairRbfProjection``: the
    plain RBF and one product, recomputed in the backward): a
    ``Trainer(mesh=(1,1))`` step at B=8 x L=768 with the 65-atom table
    and ``gp_rbf_row_chunk=32`` at fp32 and bf16, a one-device step with the
    65-atom table at B=2 x L=384, and one with ``include_pred_na_N=False``
    at B=8 x L=768. Each against ``kernels="torch"`` on the same batch
    (``_grads_against_plain``'s bars), then 2 train steps: ms, peak GiB and
    the launches (the kNN and the layers' kernels, no RBF kernel). Returns
    the launches."""
    import dataclasses

    import torch
    from na_mpnn_tpu_torch.train.trainer import Trainer, model_config_from_params

    dev = torch.device("cuda")
    nb65 = atom65_batch([600 + 24 * i for i in range(TRAIN_STRUCTURES)], "atom65_")
    small65 = atom65_batch([384, 360], "atom65_small", pad_to=384)
    counts = {}
    cases = (("65-atom mesh (1,1) fp32", {"MIXED_PRECISION": 0, "ATOMS_TO_LOAD": "all"},
              nb65, True),
             ("65-atom mesh (1,1) bf16", {"ATOMS_TO_LOAD": "all"}, nb65, True),
             ("65-atom one device fp32", {"MIXED_PRECISION": 0, "ATOMS_TO_LOAD": "all"},
              small65, False),
             ("no base N one device fp32", {"MIXED_PRECISION": 0, "INCLUDE_PRED_NA_N": 0},
              nb, False))
    for tag, keys, batch, on_mesh in cases:
        cfg = model_config_from_params(keys)
        low = cfg.compute_dtype == "bfloat16"
        if on_mesh:
            cfg = dataclasses.replace(cfg, gp_rbf_row_chunk=32)
        want = {k: v for k, v in (_expected_bf16_launches(cfg) if low
                                  else _expected_train_launches(cfg)).items()
                if not k.startswith("rbf")}
        if on_mesh:
            want["knn_qk"] = want.pop("knn")
        kw = dict(mesh=mesh) if on_mesh else dict(device=dev)
        trainer = Trainer(cfg, seed=0, **kw)
        plain = Trainer(dataclasses.replace(cfg, kernels="torch"), seed=0, **kw)
        tols = dict(loss_tol=1e-3, grad_tol=3e-2) if low else {}
        _grads_against_plain(tag, trainer, plain, trainer.device_batch(batch),
                             None if on_mesh else 7, want, **tols)
        del plain
        step_ms, peak, launched = _train_steps(
            trainer, batch, want, tag, steps=2,
            generator=None if on_mesh else torch.Generator(device=dev).manual_seed(0))
        for k, v in want.items():
            counts[k] = counts.get(k, 0) + 3 * v
        B, L = batch["S"].shape
        print(f"{tag} B={B} L={L} ({cfg.total_atoms} slots, RBF block "
              f"{cfg.edge_in - 16} wide{', row chunk 32' if on_mesh else ''}): "
              f"{', '.join(f'{t:.2f}' for t in step_ms)} ms per train step; peak "
              f"{peak / 2**30:.3f} GiB; launches per step {want}", flush=True)
    return counts



def mesh_phase(nb, ub, pdb):
    """The mesh route on one card: a one-rank NCCL group from a FileStore
    under ``build/chip_smoke/``; at the training shape, the deterministic
    ``forward_graph_parallel`` against the one-device ``forward`` under the
    same decode order (log-probs < 1e-4); 5 steps of ``Trainer(mesh=(1,1))``
    (launches per step: knn_qk 1, RBF 1, RBF dW 1, message table 9, its
    backward 9); one step with the kernels against ``kernels="torch"``;
    then, in the same group, the graph-parallel sampler,
    remat and the other atom frames. Returns the launches of the kernel
    runs."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from na_mpnn_tpu_torch.models import forward, init_params
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches
    from na_mpnn_tpu_torch.parallel.graph_parallel import forward_graph_parallel
    from na_mpnn_tpu_torch.parallel.mesh import (initialize_distributed,
                                                 make_mesh, shard_batch)
    from na_mpnn_tpu_torch.train.trainer import (Trainer, model_config_from_params,
                                                 to_device)

    dev = torch.device("cuda")
    store = os.path.join(OUT, "mesh_store")
    if os.path.exists(store):
        os.remove(store)
    initialize_distributed(1, 0, "cuda", init_file=store)
    try:
        mesh = make_mesh(1, 1, device=dev)
        cfg = model_config_from_params({"MIXED_PRECISION": 0})
        params = init_params(4, cfg, device=dev)
        batch = to_device(nb, dev)
        B, L = batch["S"].shape
        g = torch.Generator().manual_seed(5)
        order = torch.stack([torch.randperm(L, generator=g) for _ in range(B)]).to(dev)
        reset_launches()
        with torch.no_grad():
            lp_gp = forward_graph_parallel(params, cfg, shard_batch(batch, mesh),
                                           mesh, order)
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            lp_1 = forward(params, cfg, {**batch, "decoding_order": order})[0]
        want_fwd = {"knn_qk": 1, "rbf_classed": 1, "fused_node_update_enc": 3,
                    "fused_edge_update": 3, "fused_node_update_dec": 3}
        if counts != want_fwd:
            raise AssertionError(f"forward_graph_parallel launches {counts}, "
                                 f"want {want_fwd}")
        d = float((lp_gp - lp_1).abs().max())
        if not d < 1e-4:
            raise AssertionError(f"forward_graph_parallel vs forward: {d:.3g}")
        print(f"mesh (1,1) NCCL: forward_graph_parallel vs forward B={B} L={L}, "
              f"same decode order: max |d log p| {d:.3g} (< 1e-4); launches "
              f"{counts}", flush=True)

        trainer = Trainer(cfg, seed=0, mesh=mesh)
        want = {**_expected_train_launches(cfg), "knn_qk": 1}
        del want["knn"]
        step_ms, peak, train_counts = _train_steps(trainer, nb, want, "mesh train")
        for k, v in train_counts.items():
            counts[k] = counts.get(k, 0) + v
        median = float(np.median(step_ms[1:]))
        print(f"mesh (1,1) Trainer B=8 L=768 K=32 H=128: {median:.2f} ms per train "
              f"step (median of steps 2-5; all: "
              f"{', '.join(f'{t:.2f}' for t in step_ms)}); peak memory "
              f"{peak / 2**30:.3f} GiB; launches per step {want}", flush=True)
        _stream_cost(cfg, nb)
        path = os.path.join(OUT, "mesh_train.npz")
        trainer.save(path, epoch=1, save_step=0)
        plain = Trainer(dataclasses.replace(cfg, kernels="torch"), seed=0, mesh=mesh)
        plain.restore(path)
        _grads_against_plain("mesh (1,1) training", trainer, plain,
                             trainer.device_batch(nb), None, want)
        for k, v in _bf16_mesh_steps(nb, mesh, order, median).items():
            counts[k] = counts.get(k, 0) + v
        t0 = time.perf_counter()
        for phase in (lambda: graph_sampler_phase(pdb, mesh),
                      lambda: remat_phase(nb, ub),
                      lambda: atom_frame_phase(nb, mesh)):
            for k, v in phase().items():
                counts[k] = counts.get(k, 0) + v
        print(f"graph sampler, remat and atom-frame phases: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()
    return counts


def _bf16_mesh_steps(nb, mesh, order, fp32_ms):
    """The bf16 trunk on the one-rank mesh (G = 1: the one-device trunk's
    casts, with the mesh's row-keyed streams): 3 steps of
    ``Trainer(model_config_from_params({}), mesh=(1,1))`` with the launches
    of each held to knn_qk 1 and the bf16 variants of rows 3, 4, 9, 10; then
    one step without dropout and noise under a given decode order against
    the one-device bf16 step (loss within 1e-4 relative, each gradient leaf
    within 2^-7 of its max: PyTorch's index-gather backward of ``emb[S]``
    adds in an order its atomics choose, and a bf16 rounding may fall
    apart). Returns the
    launches."""
    import dataclasses

    import torch
    from na_mpnn_tpu_torch.train.trainer import Trainer, model_config_from_params

    cfg = model_config_from_params({})
    trainer = Trainer(cfg, seed=0, mesh=mesh)
    want = {**_expected_bf16_launches(cfg), "knn_qk": 1}
    del want["knn"]
    step_ms, peak, counts = _train_steps(trainer, nb, want, "bf16 mesh train",
                                         steps=3)
    median = float(np.median(step_ms[1:]))
    det = dataclasses.replace(cfg, dropout=0.0, protein_augment_eps=0.0,
                              dna_augment_eps=0.0, rna_augment_eps=0.0)
    ordered = {**nb, "decoding_order": order.cpu().numpy()}
    on_mesh = Trainer(det, seed=0, mesh=mesh)
    loss_m, grad_m = on_mesh.loss_and_grads(on_mesh.device_batch(ordered))[:2]
    one = Trainer(det, seed=0, device=mesh.device)
    batch = one.device_batch(ordered)
    batch["decoding_order"] = order
    loss_1, grad_1 = one.loss_and_grads(batch)[:2]
    rel = abs(float(loss_m) - float(loss_1)) / abs(float(loss_1))
    worst, off = 0.0, 0
    for p in one.leaves:
        a, b = grad_m[off:off + p.numel()], grad_1[off:off + p.numel()]
        off += p.numel()
        worst = max(worst, float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30))
    if not (rel < 1e-4 and worst < 2.0 ** -7):
        raise AssertionError(f"bf16 mesh (1,1) vs one device: loss rel {rel:.3g}, "
                             f"worst gradient leaf {worst:.3g}")
    print(f"bf16 mesh (1,1) Trainer B=8 L=768 K=32 H=128: {median:.2f} ms per "
          f"train step (median of steps 2-3; all: "
          f"{', '.join(f'{t:.2f}' for t in step_ms)}) against the fp32 mesh step "
          f"{fp32_ms:.2f} ms; peak memory {peak / 2**30:.3f} GiB; launches per step "
          f"{want}; without dropout and noise against the one-device bf16 step: loss "
          f"{float(loss_m):.6f} vs {float(loss_1):.6f}, rel {rel:.3g} (< 1e-4), worst "
          f"gradient leaf {worst:.3g} of its max (< 2^-7)", flush=True)
    return counts


def main():
    import torch
    card = device_phase()
    os.makedirs(OUT, exist_ok=True)
    build_phase()
    pdb = os.path.join(OUT, "synthetic.pdb")
    L = write_synthetic_pdb(pdb)
    host_reader_phase(pdb)
    rows = kernel_phase(pdb)
    rows.update(fused_kernel_phase(pdb))
    launches = main_path_phase(pdb, L)

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    breakdown_phase(pdb)
    add(fused_vs_table_phase(pdb))
    add(batch_design_phase())
    add(eval_phase(pdb, L))
    reference_check_phase(pdb)
    add(dense_inference_phase(pdb))
    nb = training_batch()
    train_rows, fwd_ms = train_kernel_phase(nb)
    rows.update(train_rows)
    rows.update(bf16_kernel_phase(nb))
    rows.update(message_mlp_phase())
    rows.update(message_mlp_phase(low=True))
    rows.update(mesh_kernel_phase(nb))
    counts, classed_ms, classed_peak = training_phase(nb, fwd_ms, rows)
    add(counts)
    counts, classed16_ms, classed16_peak = bf16_training_phase(nb, classed_ms,
                                                               classed_peak)
    add(counts)
    ub = unbucketed_batch()
    counts, unbucketed_ms, unbucketed_peak = unbucketed_training_phase(ub)
    add(counts)
    counts, ub16_ms, ub16_peak = unbucketed_training_phase(ub, low=True)
    add(counts)
    for what, u_ms, c_ms, u_pk, c_pk in (
            ("fp32", unbucketed_ms, classed_ms, unbucketed_peak, classed_peak),
            ("bf16", ub16_ms, classed16_ms, ub16_peak, classed16_peak)):
        print(f"unbucketed (L=750, gathered decoder) against bucketed (L=768) training "
              f"step ({what}): {u_ms:.2f} ms vs {c_ms:.2f} ms ({u_ms - c_ms:+.2f} ms); "
              f"peak memory {u_pk / 2**30:.3f} GiB vs {c_pk / 2**30:.3f} GiB",
              flush=True)
    counts, dense_ms, dense_peak = dense_training_phase(nb)
    add(counts)
    counts, dense16_ms, dense16_peak = dense_training_phase(nb, low=True)
    add(counts)
    for what, d_ms, c_ms, d_pk, c_pk in (
            ("fp32", dense_ms, classed_ms, dense_peak, classed_peak),
            ("bf16", dense16_ms, classed16_ms, dense16_peak, classed16_peak)):
        print(f"dense against classed training step ({what}): {d_ms:.2f} ms vs "
              f"{c_ms:.2f} ms ({d_ms - c_ms:+.2f} ms); peak memory "
              f"{d_pk / 2**30:.3f} GiB vs {c_pk / 2**30:.3f} GiB", flush=True)
    for what, ms16, ms32, pk16, pk32 in (
            ("dense", dense16_ms, dense_ms, dense16_peak, dense_peak),
            ("unbucketed", ub16_ms, unbucketed_ms, ub16_peak, unbucketed_peak)):
        print(f"bf16 against fp32 {what} training step: {ms16:.2f} ms vs "
              f"{ms32:.2f} ms ({ms16 / ms32:.3f}x); peak memory {pk16 / 2**30:.3f} "
              f"GiB vs {pk32 / 2**30:.3f} GiB ({pk16 / pk32:.3f}x)", flush=True)
    add(mesh_phase(nb, ub, pdb))
    counts, csv_path = training_loop_phase()
    add(counts)
    add(bf16_loop_phase(csv_path))
    sources = {
        "knn": ("na_mpnn_tpu_torch/csrc/knn.cu", "na_mpnn_tpu/ops/knn.py:106"),
        "knn_qk": ("na_mpnn_tpu_torch/csrc/knn.cu", "na_mpnn_tpu/ops/knn.py:54"),
        "rbf_classed": ("na_mpnn_tpu_torch/csrc/rbf_classed.cu",
                        "na_mpnn_tpu/ops/rbf_classed.py:443"),
        "rbf_classed_dw": ("na_mpnn_tpu_torch/csrc/rbf_classed_dw.cu",
                           "na_mpnn_tpu/ops/rbf_classed.py:476"),
        "rbf_edge": ("na_mpnn_tpu_torch/csrc/rbf_edge.cu",
                     "na_mpnn_tpu/ops/rbf_edge.py:99"),
        "rbf_edge_dw": ("na_mpnn_tpu_torch/csrc/rbf_edge_dw.cu",
                        "na_mpnn_tpu/ops/rbf_edge.py:197"),
    }
    for mode in MODES:
        sources[f"message_table_{mode}"] = (
            "na_mpnn_tpu_torch/csrc/message_table.cu",
            "na_mpnn_tpu/ops/message_kernels.py:464")
    for mode in MODES:
        sources[f"message_table_bwd_{mode}"] = (
            "na_mpnn_tpu_torch/csrc/message_table_bwd.cu",
            "na_mpnn_tpu/ops/message_kernels.py:500")
    for name, line in (("fused_node_update_enc", 152), ("fused_node_update_dec", 152),
                       ("fused_edge_update", 187)):
        sources[name] = ("na_mpnn_tpu_torch/csrc/fused_layers.cu",
                         f"na_mpnn_tpu/ops/fused_layers.py:{line}")
    for name, line in (("message_mlp", 187), ("message_mlp_bwd", 212)):
        sources[name] = (f"na_mpnn_tpu_torch/csrc/{name}.cu",
                         f"na_mpnn_tpu/ops/message_kernels.py:{line}")
    # the bf16 variants: the same sources' *_bf16 entries, the same TPU
    # kernels' compute_dtype=bfloat16 branch
    for name in [n for n in sources if n.startswith(("rbf_", "message_", "fused_"))]:
        sources[name + "_bf16"] = sources[name]
    kernels = []
    for name, (source, replaces) in sources.items():
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name}: never launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **rows[name], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
