"""Batched multi-structure inference on PyTorch: many structures through one
device in packed decode batches (port of the JAX package's
``eval/batch_design.py``).

1. a parse-ahead thread parses every input (host side, in input order);
2. structures are bucketed by padded length (``bucket`` granularity) and
   packed greedily, up to ``batch_structures`` per decode group; a group
   that is not full is padded with all-masked dummy rows;
3. each group decodes in one ``models.sample_multi`` call, every structure
   repeated ``samples_per_structure`` times;
4. per structure, ``design_structures`` writes the CLI's ``seqs/<name>.fa``
   and ``predict_specificities`` its ``specificity/<name>.npz``.

Host and device overlap: a full group is featurized and queued on the
device at once, its outputs start copying back without blocking, and the
previous group is read and written out only after the next one is queued.
Randomness comes from one ``torch.Generator`` seeded by ``seed``, drawn in
group order, so a fixed seed and input order reproduce the designs.

    python -m na_mpnn_tpu_torch.eval.batch_design --csv structures.csv \\
        --checkpoint model.npz --out_folder out/ --samples 4
    python -m na_mpnn_tpu_torch.eval.batch_design --csv structures.csv \\
        --checkpoint model.npz --out_folder out/ --mode specificity

The CSV has a ``structure_path`` column. ``--device cuda`` (the default)
runs the kernels, ``--device cpu`` their plain versions.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def _chain_mask_for(parsed: Dict, design_na_only: bool) -> np.ndarray:
    chains = parsed["chain_letters"]
    if design_na_only:
        sel = [c in parsed["na_chain_letters"] for c in chains]
    else:
        sel = [True] * len(chains)
    return np.asarray(sel, np.int32)


def _dummy_like(feats: Dict) -> Dict:
    """An all-masked row (zero coordinates, mask 0): every position is
    teacher-forced and out of every score; pads a group to its size."""
    out = {k: np.zeros_like(np.asarray(v)) for k, v in feats.items()}
    # strictly increasing R_idx keeps the relative-position features tame
    out["R_idx"] = np.arange(out["R_idx"].shape[1],
                             dtype=out["R_idx"].dtype)[None]
    return out


def pack_group(parsed_list: List[Dict], Lp: int, batch_structures: int,
               design_na_only: bool) -> Dict[str, np.ndarray]:
    """One decode group as host arrays ``[batch_structures, Lp, ...]``: the
    structures featurized at the padded length ``Lp``, then dummy rows up to
    ``batch_structures``."""
    from ..data.featurize import featurize_inference

    feats = [featurize_inference(parsed, _chain_mask_for(parsed, design_na_only),
                                 pad_to=Lp, as_numpy=True)
             for parsed in parsed_list]
    while len(feats) < batch_structures:
        feats.append(_dummy_like(feats[0]))
    return {k: np.concatenate([f[k] for f in feats]) for k in feats[0]}


def _record_failure(failed_dir, name, path, e):
    os.makedirs(failed_dir, exist_ok=True)
    with open(os.path.join(failed_dir, name + ".txt"), "w") as f:
        f.write(f"{path}\n{type(e).__name__}: {e}\n")


def _run_batched(pdb_paths: List[str], checkpoint: str,
                 per_structure: Callable,
                 samples_per_structure: int, temperature: float,
                 omit_AA: str, design_na_only: int, bucket: int,
                 batch_structures: int, seed: int, na_shared_tokens: int,
                 failed_dir: Optional[str] = None,
                 pair_bias_AA: Optional[np.ndarray] = None,
                 device="cuda"):
    """Parse -> bucket -> pack -> ``sample_multi``, then
    ``per_structure(name, path, parsed, rows)`` for every input, in the
    order its group finished; ``rows`` holds that structure's slice of the
    decode outputs at the padded length (callers truncate to L):

      S [S,Lp] int, log_probs [S,Lp,nl], sampling_probs [S,Lp,nl],
      seq_rec [S], loss [S], rec_mask [Lp] (mask * chain_mask).

    A structure that fails to parse is written to ``failed_dir`` and
    skipped; without ``failed_dir`` its error is raised (the group in
    flight is still written out first)."""
    import queue
    import threading

    from .. import constants
    from ..data.featurize import (get_score, get_seq_rec, make_pair_bias_ctx,
                                  resolve_device)
    from ..data.pdb import parse_pdb
    from ..data.seq_format import omit_vector, structure_name
    from ..models.config import ModelConfig
    from ..models.mpnn import sample_multi
    from ..params import load_params_any

    device = resolve_device(device)
    cfg = ModelConfig(dropout=0.0)
    params, _ = load_params_any(checkpoint, cfg, device=device)
    omit = omit_vector(omit_AA, bool(na_shared_tokens))

    parse_q: "queue.Queue" = queue.Queue(maxsize=max(2 * batch_structures, 8))
    stop = threading.Event()  # set when the consumer aborts

    def _offer(item) -> bool:
        """put() that gives up when the consumer has stopped reading."""
        while not stop.is_set():
            try:
                parse_q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _parse_worker():
        try:
            for p in pdb_paths:
                if stop.is_set():
                    return
                name = structure_name(p)
                try:
                    parsed = parse_pdb(p, na_shared_tokens=bool(na_shared_tokens))
                    if len(parsed["S"]) == 0:
                        raise ValueError("no residues parsed")
                except Exception as e:  # noqa: BLE001 — skip and go on
                    if not _offer(("err", name, p, e)):
                        return
                    continue
                if not _offer(("ok", name, p, parsed)):
                    return
        finally:
            _offer(None)  # the sentinel, even when the worker dies

    threading.Thread(target=_parse_worker, daemon=True,
                     name="na-mpnn-parse-ahead").start()

    S_rep = samples_per_structure
    generator = torch.Generator(device=device).manual_seed(int(seed))
    pair_P = (None if pair_bias_AA is None else
              torch.as_tensor(np.asarray(pair_bias_AA, np.float32), device=device))
    bias_for: Dict[int, torch.Tensor] = {}  # [Lp,nl] omit bias per bucket

    @torch.no_grad()
    def _dispatch(group, Lp):
        """Featurize, copy and queue the decode of one group; the outputs
        start their copy to the host without blocking."""
        packed = pack_group([parsed for _, _, parsed in group], Lp,
                            batch_structures, bool(design_na_only))
        batch = {k: torch.from_numpy(v).to(device) for k, v in packed.items()}
        if Lp not in bias_for:
            bias_for[Lp] = torch.as_tensor(np.tile(-1e8 * omit, (Lp, 1)),
                                           device=device)
        ctx = None
        if pair_P is not None:
            u = np.stack([make_pair_bias_ctx(cl, r, pair_bias_AA,
                                             as_numpy=True)["u_diag"]
                          for cl, r in zip(packed["chain_labels"], packed["R_idx"])])
            ctx = {"pair_bias_AA": pair_P, "u_diag": torch.as_tensor(u, device=device)}
        out = sample_multi(params, cfg, batch, generator,
                           samples_per_structure=S_rep, temperature=temperature,
                           bias=bias_for[Lp], pair_bias_ctx=ctx)
        rec_mask = (batch["mask"] * batch["chain_mask"]).to(torch.float32)
        rec_mask_rep = rec_mask.repeat_interleave(S_rep, dim=0)
        rec = get_seq_rec(batch["S"].repeat_interleave(S_rep, dim=0), out["S"],
                          rec_mask_rep)
        loss, _ = get_score(out["S"], out["log_probs"], rec_mask_rep,
                            constants.NUM_LETTERS)
        host = {"S": out["S"], "log_probs": out["log_probs"],
                "sampling_probs": out["sampling_probs"], "seq_rec": rec,
                "loss": loss, "rec_mask": rec_mask}
        host = {k: v.to("cpu", non_blocking=True) for k, v in host.items()}
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return group, host, done

    def _emit(state):
        """Wait for one group's copies and hand each structure its rows."""
        group, host, done = state
        if done is not None:
            done.synchronize()
        arr = {k: v.numpy() for k, v in host.items()}
        for i, (name, path, parsed) in enumerate(group):
            sl = slice(i * S_rep, (i + 1) * S_rep)
            rows = {"S": arr["S"][sl], "log_probs": arr["log_probs"][sl],
                    "sampling_probs": arr["sampling_probs"][sl],
                    "seq_rec": arr["seq_rec"][sl], "loss": arr["loss"][sl],
                    "rec_mask": arr["rec_mask"][i]}
            per_structure(name, path, parsed, rows)

    pending: Dict[int, List] = {}  # Lp -> group being filled
    inflight = None
    ready: List = []  # full groups as (group, Lp)
    done = False
    try:
        while not done:
            item = parse_q.get()
            if item is None:
                done = True
                # partial groups in insertion order (input order; a bucket
                # that refills re-enters at the end)
                ready.extend((grp, Lp) for Lp, grp in pending.items())
            elif item[0] == "err":
                _, name, p, e = item
                if failed_dir is None:
                    raise e
                _record_failure(failed_dir, name, p, e)
            else:
                _, name, p, parsed = item
                Lp = -(-max(len(parsed["S"]), 1) // bucket) * bucket
                pending.setdefault(Lp, []).append((name, p, parsed))
                if len(pending[Lp]) == batch_structures:
                    ready.append((pending.pop(Lp), Lp))
            for group, Lp in ready:
                state = _dispatch(group, Lp)
                # swap before emitting: if _emit raises, the except path
                # must not emit the same group again
                prev, inflight = inflight, state
                if prev is not None:
                    _emit(prev)
            ready.clear()
        prev, inflight = inflight, None
        if prev is not None:
            _emit(prev)
    except BaseException:
        stop.set()  # unblock and retire the parse worker
        try:  # drain, so a worker blocked in put() exits at once
            while True:
                item = parse_q.get_nowait()
                if item is not None and item[0] == "err" and failed_dir is not None:
                    _, name, p, e = item
                    try:
                        _record_failure(failed_dir, name, p, e)
                    except OSError:
                        pass
        except queue.Empty:
            pass
        if inflight is not None:  # its device work is done: keep the outputs
            try:
                _emit(inflight)
            except Exception:  # noqa: BLE001 — keep the original error
                pass
        raise


def design_structures(pdb_paths: List[str], checkpoint: str, out_folder: str,
                      samples_per_structure: int = 1, temperature: float = 0.1,
                      omit_AA: str = "ARNDCQEGHILKMFPSTWYVX",
                      design_na_only: int = 1, bucket: int = 64,
                      batch_structures: int = 8, seed: int = 0,
                      na_shared_tokens: int = 1,
                      file_ending: str = "",
                      catch_failures: bool = False,
                      pair_bias_AA: Optional[np.ndarray] = None,
                      write_design_json: bool = False,
                      device="cuda") -> Dict[str, Dict]:
    """Design sequences for every structure; writes ``seqs/<name>.fa`` (the
    CLI's FASTA records) and returns ``{name: {"seq_rec": [S], "confidence":
    [S], "fasta_path": str}}``. ``catch_failures`` records unparseable
    inputs under ``failed_inferences/`` and goes on; without it an invalid
    input raises when it is parsed (structures decoded before keep their
    files). ``write_design_json`` also writes
    ``<out>/<name>/design_json/<name>_<i>.json`` per design."""
    from ..data.seq_format import (ints_to_seq, native_fasta_entry,
                                   sample_fasta_entry, seq_by_chains,
                                   token_maps)

    # seed 0 draws a seed once, so the FASTA headers record the one used
    seed = int(seed) if seed else int(np.random.randint(1, 99999))
    os.makedirs(os.path.join(out_folder, "seqs"), exist_ok=True)
    _, int_to_str, dna_to_rna = token_maps(bool(na_shared_tokens))
    results: Dict[str, Dict] = {}

    def emit(name, path, parsed, rows):
        L = len(parsed["S"])
        rna_conv = np.asarray(parsed["rna_mask_for_token_conversion"])
        S_rep = rows["S"].shape[0]

        def to_seq(S_ints):
            return ints_to_seq(S_ints[:L], rna_conv, int_to_str, dna_to_rna)

        native = to_seq(np.asarray(parsed["S"]))
        n_design = int(rows["rec_mask"][:L].sum())
        entries = [native_fasta_entry(
            name, temperature, seed, n_design, S_rep, 1, checkpoint,
            seq_by_chains(native, parsed["mask_c"]))]
        recs, confs, design_data = [], [], []
        for s in range(S_rep):
            seq_text = seq_by_chains(to_seq(rows["S"][s]), parsed["mask_c"])
            conf = float(np.exp(-rows["loss"][s]))
            rec = float(rows["seq_rec"][s])
            recs.append(rec)
            confs.append(conf)
            entries.append(sample_fasta_entry(
                name, s + 1, temperature, seed, conf, rec, seq_text))
            design_data.append({
                "input_structure_name": name,
                "input_structure_path": path,
                "original_input_structure_path": path,
                "design_id": str(s + 1),
                "name": f"{name}_{s + 1}",
                "design_sequence": seq_text,
                "tool_reported_sequence_recovery": rec,
                "design_method": "na_mpnn",
                "model_weights_path": checkpoint,
            })
        fasta_path = os.path.join(out_folder, "seqs", name + ".fa" + file_ending)
        with open(fasta_path, "w") as f:
            f.write("\n".join(entries))
        if write_design_json:
            dj = os.path.join(out_folder, name, "design_json")
            os.makedirs(dj, exist_ok=True)
            for d in design_data:
                with open(os.path.join(dj, d["name"] + ".json"), "w") as f:
                    json.dump(d, f, indent=4)
        results[name] = {"seq_rec": recs, "confidence": confs,
                         "fasta_path": fasta_path}

    _run_batched(pdb_paths, checkpoint, emit,
                 samples_per_structure=samples_per_structure,
                 temperature=temperature, omit_AA=omit_AA,
                 design_na_only=design_na_only, bucket=bucket,
                 batch_structures=batch_structures, seed=seed,
                 na_shared_tokens=na_shared_tokens,
                 failed_dir=os.path.join(out_folder, "failed_inferences")
                 if catch_failures else None,
                 pair_bias_AA=pair_bias_AA, device=device)
    return results


def predict_specificities(pdb_paths: List[str], checkpoint: str,
                          out_folder: str,
                          samples_per_structure: int = 30,
                          temperature: float = 0.6,
                          omit_AA: str = "ARNDCQEGHILKMFPSTWYVX",
                          design_na_only: int = 1, bucket: int = 64,
                          batch_structures: int = 4, seed: int = 0,
                          na_shared_tokens: int = 1,
                          catch_failures: bool = False,
                          pair_bias_AA: Optional[np.ndarray] = None,
                          device="cuda") -> Dict[str, Dict]:
    """Binding-specificity PPMs for every structure (the mean over all
    samples of the per-position sampling distribution); writes the CLI's
    ``specificity/<name>.npz`` and returns ``{name: {"ppm_path": str,
    "predicted_ppm": [L,num_letters]}}``. Defaults are the specificity
    mode's (30 samples, T=0.6, protein fixed)."""
    from .. import constants

    seed = int(seed) if seed else int(np.random.randint(1, 99999))
    os.makedirs(os.path.join(out_folder, "specificity"), exist_ok=True)
    restype_to_int = constants.restype_to_int_table(bool(na_shared_tokens))
    results: Dict[str, Dict] = {}

    def emit(name, path, parsed, rows):
        L = len(parsed["S"])
        predicted_ppm = np.mean(
            rows["sampling_probs"][:, :L].astype(np.float64), axis=0)
        encoded_residues = [
            f"{parsed['chain_letters'][i]}{parsed['R_idx'][i]}{parsed['icodes'][i]}"
            for i in range(L)
        ]
        ppm_path = os.path.join(out_folder, "specificity", name + ".npz")
        np.savez(
            ppm_path,
            predicted_ppm=predicted_ppm,
            true_sequence=np.asarray(parsed["S"]).astype(np.int64),
            chain_labels=np.asarray(parsed["chain_labels"])[:L],
            mask=np.asarray(parsed["mask"])[:L],
            protein_mask=np.asarray(parsed["protein_mask"])[:L],
            dna_mask=np.asarray(parsed["dna_mask"])[:L],
            rna_mask=np.asarray(parsed["rna_mask"])[:L],
            encoded_residues=encoded_residues,
            encoded_residues_dict={r: i for i, r in enumerate(encoded_residues)},
            restype_to_int=restype_to_int,
        )
        results[name] = {"ppm_path": ppm_path, "predicted_ppm": predicted_ppm}

    _run_batched(pdb_paths, checkpoint, emit,
                 samples_per_structure=samples_per_structure,
                 temperature=temperature, omit_AA=omit_AA,
                 design_na_only=design_na_only, bucket=bucket,
                 batch_structures=batch_structures, seed=seed,
                 na_shared_tokens=na_shared_tokens,
                 failed_dir=os.path.join(out_folder, "failed_inferences")
                 if catch_failures else None,
                 pair_bias_AA=pair_bias_AA, device=device)
    return results


def parse_pair_bias_AA(spec: str, na_shared_tokens: bool = True) -> np.ndarray:
    """'xy:val,...' -> ``[num_letters, num_letters]`` neighbour-pair bias
    (the CLI's ``--pair_bias_AA`` format)."""
    from ..data.seq_format import parse_pair_bias_spec, token_maps

    str_to_int, _, _ = token_maps(na_shared_tokens)
    return parse_pair_bias_spec(spec, str_to_int)


def read_structure_paths(csv_path: str) -> List[str]:
    """The ``structure_path`` column of a CSV file."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        if "structure_path" not in (reader.fieldnames or []):
            raise ValueError(f"{csv_path}: no structure_path column")
        return [row["structure_path"] for row in reader]


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--csv", required=True,
                   help="CSV with a structure_path column")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out_folder", required=True)
    p.add_argument("--mode", default="design",
                   choices=["design", "specificity"])
    p.add_argument("--samples", type=int, default=None,
                   help="per-structure samples (default: 1 design / 30 specificity)")
    p.add_argument("--temperature", type=float, default=None,
                   help="default: 0.1 design / 0.6 specificity")
    p.add_argument("--omit_AA", default="ARNDCQEGHILKMFPSTWYVX")
    p.add_argument("--design_na_only", type=int, default=1)
    p.add_argument("--bucket", type=int, default=64)
    p.add_argument("--batch_structures", type=int, default=None,
                   help="structures per decode batch (default: 8 design / 4 specificity)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--catch_failed_inferences", type=int, default=0)
    p.add_argument("--pair_bias_AA", type=str, default="",
                   help='neighbor pair bias, e.g. "at:0.5,cg:-0.3"')
    p.add_argument("--write_design_json", type=int, default=0,
                   help="also write <out>/<id>/design_json/*.json per design")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    paths = read_structure_paths(args.csv)
    if args.temperature is not None and args.temperature <= 0:
        p.error("--temperature must be > 0 (sampling divides logits by T)")
    defaults = {"design": (1, 0.1, 8), "specificity": (30, 0.6, 4)}
    n_def, t_def, bs_def = defaults[args.mode]
    kwargs = dict(
        samples_per_structure=args.samples if args.samples is not None else n_def,
        temperature=args.temperature if args.temperature is not None else t_def,
        omit_AA=args.omit_AA, design_na_only=args.design_na_only,
        bucket=args.bucket,
        batch_structures=args.batch_structures
        if args.batch_structures is not None else bs_def,
        seed=args.seed, catch_failures=bool(args.catch_failed_inferences),
        pair_bias_AA=parse_pair_bias_AA(args.pair_bias_AA)
        if args.pair_bias_AA else None,
        device=args.device)
    if args.mode == "design":
        res = design_structures(paths, args.checkpoint, args.out_folder,
                                write_design_json=bool(args.write_design_json),
                                **kwargs)
        for name, r in res.items():
            print(f"{name}: seq_rec={np.mean(r['seq_rec']):.4f} "
                  f"confidence={np.mean(r['confidence']):.4f}")
    else:
        res = predict_specificities(paths, args.checkpoint, args.out_folder,
                                    **kwargs)
        for name, r in res.items():
            print(f"{name}: ppm -> {r['ppm_path']}")


if __name__ == "__main__":
    main()
