#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``na_mpnn_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit. Phases, each of which raises on failure:

1. device check: prints the card's name and power limit, turns TF32 off;
2. build: compiles ``na_mpnn_tpu_torch/csrc/*.cu`` (one nvcc per source, in
   parallel) and prints the seconds;
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: kNN (E_idx exact, also with the masked rows of
   ``--pad_to_bucket 32``), class-specialised RBF and the message table in
   its three modes (relative error < 1e-5; random masks, m1d = 0 on some
   decoder edges);
4. main path: the port's CLI on a synthetic protein-DNA PDB of 389
   residues with random full-width weights (H=128, K=32, 3+3 layers) in
   design, specificity and score mode and in design mode with
   ``--pad_to_bucket 32``; checks the outputs and that each path launched
   every kernel; then the time of encode, sample, score and unconditional
   probs at that shape; then score and unconditional probs with the kernels
   against the plain path (``kernels="torch"``) on the card at that
   structure padded to 416 rows, and against the CPU on a small structure;
5. one JSON line of the kernels (launches on the main path, error, times,
   bound), then the card's name and power limit as ``nvidia-smi`` gives
   them and, last, the device JSON.

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


def _bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


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


def kernel_phase(pdb):
    """Each kernel against its plain version on the card; returns the
    measured numbers of each kernel at the design shape (B=1)."""
    import torch
    from na_mpnn_tpu_torch.models import init_params
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.ops import knn, message_kernels, rbf_classed

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
        if not torch.equal(E_k, E_p):
            raise AssertionError(f"knn {tag}: E_idx differs from the plain version")
        err = float((D_k - D_p).abs().max())
        ms = _sync_time(lambda: knn.knn_graph_cuda(X_ref, mask, K), 20)
        plain_ms = _sync_time(lambda: knn.knn_graph_plain(X_ref, mask, K), 5)
        # The function's least work per pair: the masked distance (12
        # operations), the row max and about one comparison to select the
        # k smallest.
        bound = _bound_ms(B * L * L * 14, B * L * 16 + B * L * K * 12)
        print(f"knn {tag} B={B} L={L} K={K}: E_idx exact, max|dD|={err:.3g}, "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms)",
              flush=True)
        if tag == "design":
            rows["knn"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound[0], bound_by=bound[1])

    # RBF at the design shape (B=1) and the score shape (B=10).
    W = params["features"]["edge_embedding"]["w"][cfg.num_positional_embeddings:]
    for n_copies in (1, 10):
        _, X_aug, X_m_aug, X_ref, mask = _structure(pdb, dev, n_copies)
        _, E_idx = knn.knn_graph_cuda(X_ref, mask, K)
        out_k = rbf_classed.rbf_edge_features_classed_cuda(X_aug, X_m_aug, E_idx, W)
        out_p = rbf_classed.rbf_edge_features_classed_plain(X_aug, X_m_aug, E_idx, W)
        rel = _rel_err(out_k, out_p)
        if not rel < REL_TOL:
            raise AssertionError(f"rbf B={n_copies}: relative error {rel:.3g}")
        ms = _sync_time(lambda: rbf_classed.rbf_edge_features_classed_cuda(
            X_aug, X_m_aug, E_idx, W), 20)
        plain_ms = _sync_time(lambda: rbf_classed.rbf_edge_features_classed_plain(
            X_aug, X_m_aug, E_idx, W), 3)
        B, L = mask.shape
        nq = X_m_aug.sum(-1)                                         # [B,L]
        nn = torch.gather(nq, 1, E_idx.reshape(B, -1)).reshape(B, L, K)
        pairs = float((nq[:, :, None] * nn).sum())
        ops = pairs * cfg.num_rbf * (2 * H + 8)
        nbytes = (X_aug.numel() + X_m_aug.numel() + W.numel()
                  + B * L * K * H) * 4 + E_idx.numel() * 8
        bound = _bound_ms(ops, nbytes)
        print(f"rbf_classed B={B} L={L} K={K}: rel err {rel:.3g} (< {REL_TOL}), "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms)",
              flush=True)
        if n_copies == 1:
            rows["rbf_classed"] = dict(max_abs_err=float((out_k - out_p).abs().max()),
                                       ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound[0], bound_by=bound[1])
        del out_p

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
            ms = _sync_time(lambda: message_kernels.message_table_cuda(*args, K=K, L=L), 20)
            plain_ms = _sync_time(lambda: message_kernels.message_table_plain(
                *args, K=K, L=L), 5)
            C = table.shape[1]
            # The function's least work: h_V@Wa per node; e_in@Wb, W2 and
            # about 30 elementwise operations per edge element; W3 per edge
            # only in enc_edge, since in the summing modes
            # sum_k w_k (W3 g_k + b3) = W3 (sum_k w_k g_k) + b3 sum_k w_k.
            if mode == "enc_edge":
                ops = N * K * (6 * H * H + 30 * H) + N * 2 * H * H
            else:
                ops = N * K * (4 * H * H + 30 * H) + N * 4 * H * H
            nbytes = (4 * (N * H + N * K * H + N * C + 2 * N * K + 4 * H * H + 3 * H
                           + out_k.numel()) + 8 * N * K)
            bound = _bound_ms(ops, nbytes)
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


def main_path_phase(pdb, L):
    """The port's CLI on the card, per mode; returns the launches."""
    import torch
    from na_mpnn_tpu_torch.cli.run import cli_entry
    from na_mpnn_tpu_torch.models import init_params
    from na_mpnn_tpu_torch.models.config import ModelConfig
    from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches
    from na_mpnn_tpu_torch.params import save_checkpoint_npz

    ckpt = os.path.join(OUT, "random_weights.npz")
    save_checkpoint_npz(ckpt, init_params(0, ModelConfig(), device="cpu"))
    total = {}
    runs = (("design", []), ("specificity", ["--output_specificity", "1"]),
            ("score", []), ("design_pad32", ["--pad_to_bucket", "32"]))
    for tag, extra in runs:
        mode = "design" if tag.startswith("design") else tag
        out = os.path.join(OUT, tag)
        argv = ["--mode", mode, "--checkpoint_na_mpnn", ckpt, "--pdb_path", pdb,
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
        stats = np.load(os.path.join(out, "stats", "synthetic.npz"))
        enc = counts.get("message_table_enc_node", 0) + counts.get("message_table_enc_edge", 0)
        dec = counts.get("message_table_dec", 0)
        if counts.get("knn", 0) < 1 or counts.get("rbf_classed", 0) < 1:
            raise AssertionError(f"{tag}: kNN/RBF kernels not launched: {counts}")
        if enc < 6 * counts["knn"]:
            raise AssertionError(f"{tag}: fewer than 6 message-table launches "
                                 f"per encode: {counts}")
        if mode == "score":
            if dec < 3:
                raise AssertionError(f"score: decoder kernel not launched: {counts}")
            _check_finite(stats["log_probs"], (10, L, 33), "score log_probs")
            _check_finite(stats["unconditional_log_probs"], (L, 33), "uncond")
            if not np.allclose(np.exp(stats["log_probs"]).sum(-1), 1.0, atol=1e-4):
                raise AssertionError("score: probabilities do not sum to 1")
        else:
            B = 30 if mode == "specificity" else 1
            _check_finite(stats["log_probs"], (B, L, 33), f"{tag} log_probs")
            _check_finite(stats["sampling_probs"], (B, L, 33), f"{tag} probs")
            S = stats["generated_sequences"]
            if S.shape != (B, L) or S.min() < 0 or S.max() >= 33:
                raise AssertionError(f"{tag}: bad sequences {S.shape}")
            with open(os.path.join(out, "seqs", "synthetic.fa")) as f:
                if f.read().count(">") != B + 1:
                    raise AssertionError(f"{tag}: FASTA records missing")
            if mode == "specificity":
                spec = np.load(os.path.join(out, "specificity", "synthetic.npz"),
                               allow_pickle=True)
                _check_finite(spec["predicted_ppm"], (L, 33), "predicted_ppm")
        print(f"main path {tag}: {dt:.2f} s, launches {counts}", flush=True)
    return total


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


def main():
    import torch
    card = device_phase()
    os.makedirs(OUT, exist_ok=True)
    build_phase()
    pdb = os.path.join(OUT, "synthetic.pdb")
    L = write_synthetic_pdb(pdb)
    rows = kernel_phase(pdb)
    launches = main_path_phase(pdb, L)
    breakdown_phase(pdb)
    reference_check_phase(pdb)
    sources = {
        "knn": ("na_mpnn_tpu_torch/csrc/knn.cu", "na_mpnn_tpu/ops/knn.py:106"),
        "rbf_classed": ("na_mpnn_tpu_torch/csrc/rbf_classed.cu",
                        "na_mpnn_tpu/ops/rbf_classed.py:443"),
    }
    for mode in ("enc_node", "enc_edge", "dec"):
        sources[f"message_table_{mode}"] = (
            "na_mpnn_tpu_torch/csrc/message_table.cu",
            "na_mpnn_tpu/ops/message_kernels.py:464")
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
