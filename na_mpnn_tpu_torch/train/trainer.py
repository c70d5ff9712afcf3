"""The training step: forward + loss + gradients + Noam-Adam update, the
evaluation step and ``.npz`` checkpoints (port of the JAX package's
``train/trainer.py::Trainer``), on one device or on a
``torch.distributed`` mesh; and ``run_training``, the training loop over
the data stack (``data/dataset.py``, ``data/loader.py``) with metrics, logs,
checkpoints and resume.

With a mesh (``parallel/mesh.py``), every rank holds the same parameters
(rank 0's, broadcast after init and restore), takes its ``shard_batch`` of
the global batch, and runs ``forward_graph_parallel`` at every mesh shape
(at G = 1 its gathers are identities), whose random streams are keyed by
(seed, step, global row); the loss is a sum over tokens divided by a
constant, so one all-reduce of the flat gradient over the world gives the
global gradient, and every rank then takes the same clipped Adam update.
Metrics are computed on the log-probs all-gathered along the graph axis and
then gathered over the data axis: the global ``[B, L]`` arrays. With the
per-host feed (``per_host_feed``, graph axis 1) each rank's host batch holds
its own rows only and its metrics are of those rows.

The parameters live in one flat buffer, in ``ravel_pytree`` order (lists in
order, dict keys sorted), and the parameter tree the model reads is a tree of
views into it; each view is a leaf that takes its own gradient. The
optimizer runs over the flat vector, as the JAX trainer does, so its moments
save straight into the JAX checkpoint layout: ``opt/leaf0000..0003`` =
(adam count, mu, nu, schedule count).

Batches are host numpy dicts (``collate_batch``); they reach the card as one
pinned-memory, non-blocking copy per array.

``MIXED_PRECISION`` (default 1, as in the JAX package) selects the bf16
trunk (``compute_dtype="bfloat16"``) on one device and on every mesh, with
the JAX Trainer's policy on the same mesh: the whole trunk in bf16 on one
device and at G = 1, only the RBF projection at G > 1
(``parallel/graph_parallel.py``). The parameters, the flat gradient, its
all-reduce and the Noam-Adam state stay fp32 at every mesh shape (the model
casts the layers' parameters in its forward, so autograd returns their
gradients in fp32), and the ``.npz`` checkpoints are those of an fp32 run.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..models import ModelConfig, forward, init_params
from ..models.config import ARCHITECTURES, check_supported
from ..params import load_checkpoint_npz, refuse_orbax, save_checkpoint_npz
from ..parallel.graph_parallel import all_gather_rows, forward_graph_parallel
from ..parallel.mesh import Mesh, all_gather_batch, replicated, shard_batch
from .losses import (compute_canonical_base_pair_accuracy, loss_nll,
                     loss_smoothed, loss_smoothed_uniform,
                     make_polymer_restype_masks, mask_for_loss)
from .optimizer import OptState, make_optimizer


def model_config_from_params(params: Dict) -> ModelConfig:
    """ModelConfig from a reference-style JSON parameter dict (the JAX
    package's ``model_config_from_params``; ``MODEL_TYPE`` "ligand_mpnn"
    selects LigandMPNN, whose letters default to its 21)."""
    model_type = params.get("MODEL_TYPE", "na_mpnn")
    letters = ARCHITECTURES[model_type].letters
    return ModelConfig(
        node_features=params.get("HIDDEN_DIM", 128),
        edge_features=params.get("HIDDEN_DIM", 128),
        hidden_dim=params.get("HIDDEN_DIM", 128),
        num_encoder_layers=params.get("NUM_ENCODER_LAYERS", 3),
        num_decoder_layers=params.get("NUM_DECODER_LAYERS", 3),
        k_neighbors=params.get("NUM_NEIGHBORS", 32),
        vocab=params.get("VOCAB_SIZE", letters),
        num_letters=params.get("NUM_LETTERS", letters),
        dropout=params.get("DROPOUT", 0.1),
        protein_augment_eps=params.get("PROTEIN_BACKBONE_NOISE", 0.1),
        dna_augment_eps=params.get("DNA_BACKBONE_NOISE", 0.1),
        rna_augment_eps=params.get("RNA_BACKBONE_NOISE", 0.1),
        decode_protein_first=bool(params.get("DECODE_PROTEIN_FIRST", 0)),
        na_ref_atom=params.get("NA_REF_ATOM", "C1'"),
        include_pred_na_N=bool(params.get("INCLUDE_PRED_NA_N", 1)),
        compute_dtype=("bfloat16" if params.get("MIXED_PRECISION", 1)
                       else "float32"),
        atom_table=params.get("ATOMS_TO_LOAD", "backbone"),
        model_type=model_type,
        atom_context_num=params.get("ATOM_CONTEXT_NUM", 25),
    )


BATCH_KEYS = [
    "X", "X_m", "mask", "S", "R_idx", "chain_labels", "protein_mask",
    "dna_mask", "rna_mask", "R_polymer_type", "interface_mask",
    "base_pair_mask", "base_pair_index", "canonical_base_pair_mask",
    "canonical_base_pair_index", "aligned_ppm", "ppm_mask",
]

# LigandMPNN's context atoms (``models/ligand.py``), copied where a batch
# carries them
CONTEXT_KEYS = ["Y", "Y_t", "Y_m"]


# The batch arrays the metrics read (S, the loss per token's masks and PPM
# labels, the canonical base pairs).
METRIC_KEYS = ("S", "protein_mask", "dna_mask", "rna_mask", "ppm_mask",
               "aligned_ppm", "canonical_base_pair_mask",
               "canonical_base_pair_index")


def to_device(np_batch, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The ``BATCH_KEYS`` (and ``CONTEXT_KEYS``) arrays of a host batch on
    ``device``: floats as ``dtype``, integers as they are; pinned and
    non-blocking on a card."""
    device = torch.device(device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    out = {}
    for k in BATCH_KEYS + CONTEXT_KEYS:
        if k not in np_batch:
            continue
        a = np.asarray(np_batch[k])
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np_dtype, copy=False)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def tree_leaves(tree):
    """Leaves in ``ravel_pytree`` order: lists in order, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def _views(tree, flat, offsets):
    """The tree with each leaf replaced by its view of ``flat``."""
    if isinstance(tree, dict):
        return {k: _views(v, flat, offsets) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_views(v, flat, offsets) for v in tree]
    a, b = offsets[id(tree)]
    return flat[a:b].view(tree.shape).requires_grad_(True)


class Trainer:
    """Owns the parameters, the optimizer state and the train / eval steps
    of one model, on one device or, with ``mesh``, on this rank of a mesh
    (the mesh's device; every rank constructs its Trainer alike)."""

    def __init__(self, cfg: ModelConfig, label_smoothing=0.1,
                 loss_tokens=6000.0, grad_clip_norm=1.0,
                 na_shared_tokens=True, seed=0, device="cuda",
                 mesh: Mesh = None, dtype=torch.float32,
                 per_host_feed: bool = False):
        check_supported(cfg)
        if cfg.arch.atom_context and mesh is not None:
            raise ValueError("ligand_mpnn trains on one device: the graph-"
                             "parallel forward has no context encoder")
        self.cfg = cfg
        self.mesh = mesh
        # the per-host feed: host batches hold this rank's rows only
        self.per_host_feed = bool(per_host_feed) and mesh is not None
        if self.per_host_feed and mesh.graph != 1:
            raise ValueError("the per-host feed splits the batch over the data "
                             "axis only: it needs a mesh with graph = 1")
        self.seed = seed
        self.dtype = dtype
        self.device = torch.device(device) if mesh is None else mesh.device
        self.label_smoothing = label_smoothing
        self.loss_tokens = loss_tokens
        self.na_shared_tokens = na_shared_tokens
        self.restype_masks = make_polymer_restype_masks(na_shared_tokens)
        self.optimizer = make_optimizer(cfg.hidden_dim, grad_clip_norm=grad_clip_norm)
        tree = init_params(seed, cfg, device=self.device, dtype=dtype)
        offsets, n = {}, 0
        for leaf in tree_leaves(tree):
            offsets[id(leaf)] = (n, n + leaf.numel())
            n += leaf.numel()
        self.flat = torch.cat([t.reshape(-1) for t in tree_leaves(tree)])
        self.params = _views(tree, self.flat, offsets)
        self.leaves = list(tree_leaves(self.params))
        self._replicate()
        self.opt_state = self.optimizer.init(self.flat)
        self.step = 0

    def _replicate(self):
        """Rank 0's parameters on every rank of the mesh."""
        if self.mesh is not None:
            with torch.no_grad():
                replicated(self.mesh, self.flat)

    # -- steps -------------------------------------------------------------

    def _polymer_masks(self, batch):
        return {"protein": batch["protein_mask"], "dna": batch["dna_mask"],
                "rna": batch["rna_mask"]}

    def _loss(self, log_probs, batch, mfl):
        if self.cfg.arch.loss == "uniform":
            return loss_smoothed_uniform(
                batch["S"], log_probs, mfl, weight=self.label_smoothing,
                tokens=self.loss_tokens, num_letters=self.cfg.num_letters)
        return loss_smoothed(
            batch["S"], log_probs, mfl, self._polymer_masks(batch),
            self.restype_masks, weight=self.label_smoothing,
            tokens=self.loss_tokens, num_letters=self.cfg.num_letters,
            ppm_mask=batch["ppm_mask"], aligned_ppm=batch["aligned_ppm"])

    def _log_probs(self, batch, generator, train):
        if self.mesh is None:
            return forward(self.params, self.cfg, batch, generator)[0]
        if generator is not None:
            raise ValueError("a mesh Trainer keys its random streams by "
                             "(seed, step); it takes no generator")
        return forward_graph_parallel(
            self.params, self.cfg, batch, self.mesh,
            batch.get("decoding_order"),
            key=(self.seed, self.step) if train else None)

    def loss_and_grads(self, batch, generator=None):
        """Forward + ``loss_smoothed`` + backward on a device batch ->
        (loss_av, flat gradient, log_probs, mask_for_loss, loss per token).
        With a mesh, ``batch`` is this rank's shard (``shard_batch``), which
        may carry this rank's rows of ``decoding_order`` ``[B/D, L]``; the
        loss and the gradient are the global ones (summed over the world),
        the rest this rank's rows."""
        for p in self.leaves:
            p.grad = None
        with trace.span("train.forward"):
            log_probs = self._log_probs(batch, generator, train=True)
            mfl = mask_for_loss(batch["S"], batch["mask"],
                                self.na_shared_tokens).to(log_probs.dtype)
            loss_per_token, loss_av = self._loss(log_probs, batch, mfl)
        with trace.span("train.backward"):
            loss_av.backward()
            grad = torch.cat([(p.grad if p.grad is not None
                               else torch.zeros_like(p)).reshape(-1)
                              for p in self.leaves])
            for p in self.leaves:
                p.grad = None
            loss_av = loss_av.detach()
            if self.mesh is not None:
                with trace.span("train.allreduce"):
                    dist.all_reduce(grad)
                dist.all_reduce(loss_av)
        return (loss_av, grad, log_probs.detach(), mfl,
                loss_per_token.detach())

    def _metrics(self, batch, log_probs, mfl, loss_per_token=None):
        """Per-token metrics of the global batch: with a mesh, from the
        log-probs and batch arrays gathered along the graph axis, then over
        the data axis; with the per-host feed, of this rank's rows only (the
        metric sums are added over the ranks at the epoch's end)."""
        if self.mesh is None:
            return self._metrics_from_logprobs(batch, log_probs, mfl,
                                               loss_per_token)
        with torch.no_grad():
            rows = {k: all_gather_rows(batch[k], self.mesh)
                    for k in METRIC_KEYS if k in batch}
            m = self._metrics_from_logprobs(
                rows, all_gather_rows(log_probs, self.mesh),
                all_gather_rows(mfl, self.mesh))
            if self.per_host_feed:
                return m
            return {k: all_gather_batch(v, self.mesh) for k, v in m.items()}

    def _metrics_from_logprobs(self, batch, log_probs, mfl,
                               loss_per_token=None):
        _, _, true_false = loss_nll(batch["S"], log_probs, mfl)
        cbp_acc = compute_canonical_base_pair_accuracy(
            log_probs, batch["canonical_base_pair_mask"],
            batch["canonical_base_pair_index"], self.na_shared_tokens)
        if loss_per_token is None:
            loss_per_token, _ = self._loss(log_probs, batch, mfl)
        return {
            "loss_per_token": loss_per_token.to(torch.float32),
            "accuracy": true_false,
            "cbp_accuracy": cbp_acc,
            "S_pred": log_probs.argmax(dim=-1),
            "mask_for_loss": mfl,
        }

    def _train_step_impl(self, batch, generator):
        """One step on a device batch (which may carry ``decoding_order``):
        gradients, optimizer update in place on the flat parameters,
        metrics."""
        loss_av, grad, log_probs, mfl, loss_per_token = self.loss_and_grads(
            batch, generator)
        with trace.span("train.update"):
            with torch.no_grad():
                self.flat.add_(self.optimizer.update(grad, self.opt_state))
            metrics = self._metrics(batch, log_probs, mfl, loss_per_token)
        metrics["loss_av"] = loss_av
        return metrics

    @torch.no_grad()
    def _eval_step_impl(self, batch):
        log_probs = self._log_probs(batch, None, train=False)
        mfl = mask_for_loss(batch["S"], batch["mask"], self.na_shared_tokens)
        return self._metrics(batch, log_probs, mfl.to(log_probs.dtype))

    # -- public API --------------------------------------------------------

    def device_batch(self, np_batch):
        """A host batch on the trainer's device: with a mesh, this rank's
        ``shard_batch`` of it (and its rows of ``decoding_order``, where
        the host batch has one); with the per-host feed the host batch is
        this rank's shard already (``decoding_order`` too)."""
        if self.mesh is None:
            return to_device(np_batch, self.device, self.dtype)
        if self.per_host_feed:
            batch = to_device(np_batch, self.device, self.dtype)
            if "decoding_order" in np_batch:
                batch["decoding_order"] = torch.as_tensor(
                    np.asarray(np_batch["decoding_order"]), device=self.device)
            return batch
        batch = to_device(shard_batch(np_batch, self.mesh), self.device,
                          self.dtype)
        if "decoding_order" in np_batch:
            order = shard_batch({"S": np_batch["S"],
                                 "o": np.asarray(np_batch["decoding_order"])},
                                self.mesh, shard_length=False)["o"]
            batch["decoding_order"] = torch.from_numpy(order).to(self.device)
        return batch

    def train_step(self, np_batch, generator: torch.Generator = None):
        """One training step. On one device ``generator`` (on the trainer's
        device) draws the coordinate noise, dropout masks and decode order
        (None: none of them). With a mesh they come from (seed, step)."""
        with trace.span("train.step"):
            with trace.span("train.batch"):
                batch = self.device_batch(np_batch)
            metrics = self._train_step_impl(batch, generator)
        self.step += 1
        return metrics

    def eval_step(self, np_batch):
        return self._eval_step_impl(self.device_batch(np_batch))

    def profile_steps(self, np_batch, generator, out_dir: str, n_steps: int = 3):
        """A ``torch.profiler`` trace (CPU and, on a card, CUDA activity) of
        ``n_steps`` train steps after one untraced step, written as a Chrome
        trace to ``out_dir/train_steps.json``; returns its path. The steps
        train: they advance the parameters and ``step`` as any other."""
        from torch.profiler import ProfilerActivity, profile

        self.train_step(np_batch, generator)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        with profile(activities=activities) as prof:
            for _ in range(n_steps):
                self.train_step(np_batch, generator)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "train_steps.json")
        prof.export_chrome_trace(path)
        return path

    # -- checkpoints -------------------------------------------------------

    def save(self, path: str, epoch: int, save_step: int):
        """Write the ``.npz`` checkpoint both packages read (with a mesh:
        rank 0 writes, and every rank returns once the file is written)."""
        if self.mesh is None or self.mesh.rank == 0:
            meta = {"epoch": epoch, "step": self.step, "save_step": save_step}
            s = self.opt_state
            leaves = (np.asarray(s.count, np.int32), s.mu.cpu().numpy(),
                      s.nu.cpu().numpy(), np.asarray(s.schedule_count, np.int32))
            save_checkpoint_npz(path, self.params, meta=meta, opt_state_flat={
                f"leaf{i:04d}": v for i, v in enumerate(leaves)})
        if self.mesh is not None:
            dist.barrier(device_ids=([self.device.index]
                                     if self.device.type == "cuda" else None))

    def restore(self, path: str) -> Dict:
        """Read an ``.npz`` checkpoint of either package; optimizer state in
        the flat layout or the legacy per-leaf one (count, mu of every leaf,
        nu of every leaf, schedule count)."""
        if os.path.isdir(path):
            refuse_orbax(path)
        tree, meta, opt_flat = load_checkpoint_npz(path)
        with torch.no_grad():
            for view, arr in zip(self.leaves, tree_leaves(tree)):
                if tuple(view.shape) != tuple(np.shape(arr)):
                    raise ValueError(f"{path}: parameter shape {np.shape(arr)} "
                                     f"!= {tuple(view.shape)}")
                view.copy_(torch.from_numpy(np.asarray(arr)))
        if opt_flat:
            loaded = [np.asarray(opt_flat[f"leaf{i:04d}"])
                      for i in range(len(opt_flat))]
            if len(loaded) != 4:
                n = (len(loaded) - 2) // 2
                if len(loaded) != 2 * n + 2:
                    raise ValueError(f"{path}: optimizer state has "
                                     f"{len(loaded)} leaves")
                mu = np.concatenate([x.reshape(-1) for x in loaded[1:1 + n]])
                nu = np.concatenate([x.reshape(-1) for x in loaded[1 + n:-1]])
                loaded = [loaded[0], mu, nu, loaded[-1]]
            if loaded[1].size != self.flat.numel():
                raise ValueError(f"{path}: optimizer moments hold "
                                 f"{loaded[1].size} values, the model "
                                 f"{self.flat.numel()}")

            def moment(a):
                return torch.from_numpy(np.array(a, np.float32)).to(
                    self.device, self.flat.dtype)

            self.opt_state = OptState(int(loaded[0]), moment(loaded[1]),
                                      moment(loaded[2]), int(loaded[3]))
        self._replicate()
        self.step = int(meta.get("step", 0))
        return meta


def _epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The one-device random stream of an epoch (noise, dropout, decode
    order), a function of (seed, epoch) only: the role of JAX's
    ``fold_in(PRNGKey(seed), epoch)``."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1000003 + epoch) % 2 ** 63)


def run_training(config_path_or_dict, max_epochs: Optional[int] = None,
                 steps_override: Optional[int] = None, device="cuda"):
    """The training loop from a reference-style JSON config (the JAX
    package's ``run_training``): dataset and prefetch loader, ``Trainer``,
    metrics, ``log.txt`` / ``log.jsonl`` and ``.npz`` checkpoints under
    ``BASE_FOLDER``, resume from ``PREV_CHECKPOINT``. Runs on ``device``
    (a card unless the caller asks for the CPU).

    The example tables are read with ``csv`` (``read_examples_csv``). Every
    per-epoch random stream is a function of (``SEED``, epoch): the cluster
    draws (``split_rng``, the JAX formula) and the device's noise, dropout
    and decode order (``_epoch_generator``; with a mesh, streams keyed by
    (seed, step)), so a run restored from the epoch-boundary checkpoint
    replays the interrupted epoch exactly. Under ``torchrun`` (or any
    initialised process group) the Trainer runs on a
    ``(WORLD_SIZE / MESH_GRAPH_AXIS, MESH_GRAPH_AXIS)`` mesh, the batch
    dimension padded to the data axis, rank 0 writing logs and checkpoints.
    With more than one rank and ``MESH_GRAPH_AXIS`` 1, ``PER_HOST_FEED``
    (default 1, JAX ``trainer.py:572-582``) has each rank parse and collate
    only its own rows of each global batch (``PrefetchLoader(shard=(rank,
    world))``), pad them to the world's longest L (``sync_batch_length``),
    and sum its metric rows, added over the ranks at the epoch's end
    (``all_reduce_across_hosts``); with ``PER_HOST_FEED: 0`` every rank
    loads the whole batch and keeps its ``shard_batch``. ``log.jsonl`` adds two keys per
    epoch to the JAX package's: ``loader_wait_s`` (host seconds spent
    waiting for the next training batch) and ``steps`` (training steps taken
    in the epoch, a ``PROFILE_DIR`` capture's included).

    ``MIXED_PRECISION`` (default 1) trains the bf16 trunk, on one device
    and on a mesh; ``CHECKPOINT_FORMAT: "orbax"`` raises."""
    from .. import constants
    from ..data.dataset import (DatasetConfig, NADataset, make_batch_iter,
                                parse_date, read_examples_csv)
    from ..data.loader import PrefetchLoader
    from ..data.parsers import make_parsers
    from ..parallel.mesh import (initialize_distributed, make_mesh,
                                 sync_batch_length)
    from .metrics import generate_metric_manager

    if isinstance(config_path_or_dict, str):
        with open(config_path_or_dict) as f:
            p = json.load(f)
    else:
        p = dict(config_path_or_dict)
    if p.get("CHECKPOINT_FORMAT", "npz") != "npz":
        raise NotImplementedError(
            f"CHECKPOINT_FORMAT {p['CHECKPOINT_FORMAT']!r}: only npz is written "
            "(orbax.checkpoint imports jax, which this package never imports)")

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        initialize_distributed(world, int(os.environ["RANK"]), device)
    mesh = None
    if dist.is_initialized():
        mesh = make_mesh(graph=int(p.get("MESH_GRAPH_AXIS", 1)), device=device)
    lead = mesh is None or mesh.rank == 0

    base = p["BASE_FOLDER"]
    if base[-1] != "/":
        base += "/"
    logfile = base + "log.txt"
    jsonl_log = base + "log.jsonl"
    if lead:
        os.makedirs(base, exist_ok=True)
        if not p.get("PREV_CHECKPOINT"):
            with open(logfile, "w") as f:
                f.write("Epoch\tTrain\tValidation\n")

    atoms = (constants.ALL_ATOMS if p.get("ATOMS_TO_LOAD") == "all"
             else constants.BACKBONE_ATOMS)
    ds_cfg = DatasetConfig(
        atom_list_to_save=tuple(atoms),
        parse_protein=bool(p["PARSE_PROTEIN"]), parse_dna=bool(p["PARSE_DNA"]),
        parse_rna=bool(p["PARSE_RNA"]),
        parse_rna_as_dna=bool(p["PARSE_RNA_AS_DNA"]),
        na_shared_tokens=bool(p["NA_SHARED_TOKENS"]),
        protein_backbone_occ_cutoff=p["PROTEIN_BACKBONE_OCC_CUTOFF"],
        protein_side_chain_occ_cutoff=p["PROTEIN_SIDE_CHAIN_OCC_CUTOFF"],
        dna_backbone_occ_cutoff=p["DNA_BACKBONE_OCC_CUTOFF"],
        dna_side_chain_occ_cutoff=p["DNA_SIDE_CHAIN_OCC_CUTOFF"],
        rna_backbone_occ_cutoff=p["RNA_BACKBONE_OCC_CUTOFF"],
        rna_side_chain_occ_cutoff=p["RNA_SIDE_CHAIN_OCC_CUTOFF"],
        crop_large_structures=bool(p["CROP_LARGE_STRUCTURES"]),
        batch_tokens=p["BATCH_TOKENS"], na_ref_atom=p["NA_REF_ATOM"],
        parse_ppms=bool(p["PARSE_PPMS"]),
        min_overlap_length=p["MIN_OVERLAP_LENGTH"],
        drop_protein_probability=p["DROP_PROTEIN_PROBABILITY"],
        na_only_as_uniform_ppm=bool(p["NA_ONLY_AS_UNIFORM_PPM"]),
        protein_interface_residue_mutation_probability=p[
            "PROTEIN_INTERFACE_RESIDUE_MUTATION_PROBABILITY"],
        mutate_base_pair_together=bool(p["MUTATE_BASE_PAIR_TOGETHER"]),
        mutate_entire_side_chain_interface_probability=p[
            "MUTATE_ENTIRE_SIDE_CHAIN_INTERFACE_PROBABILITY"],
        na_non_interface_as_uniform_ppm=bool(p["NA_NON_INTERFACE_AS_UNIFORM_PPM"]),
    )
    cif_parser, pdb_parser = make_parsers(
        skip_res=p.get("EXCLUDE_RES", []),
        randomize_nmr_model=bool(p.get("RANDOMIZE_NMR_MODEL", 0)))
    dataset = NADataset(cif_parser=cif_parser, pdb_parser=pdb_parser, config=ds_cfg)

    cfg = model_config_from_params(p)
    seed = int(p.get("SEED", 0))
    per_host_feed = (mesh is not None and mesh.size > 1
                     and bool(p.get("PER_HOST_FEED", 1)) and mesh.graph == 1)
    trainer = Trainer(cfg, label_smoothing=p["LABEL_SMOOTHING"],
                      loss_tokens=float(p["LOSS_TOKENS"]),
                      grad_clip_norm=p["GRADIENT_NORM"],
                      na_shared_tokens=bool(p["NA_SHARED_TOKENS"]),
                      seed=seed, device=device, mesh=mesh,
                      per_host_feed=per_host_feed)

    epoch0, save_step = 0, 0
    if p.get("PREV_CHECKPOINT"):
        try:
            meta = trainer.restore(p["PREV_CHECKPOINT"])
            epoch0 = int(meta.get("epoch", 0))
            save_step = int(meta.get("save_step", 0))
            print(f"Starting from step {trainer.step}")
        except (OSError, ValueError, KeyError) as e:
            print(f"LOADING FROM BAD PATH CHECKPOINT ({type(e).__name__}: {e})")

    rows_train = read_examples_csv(p["DF_PATH_TRAIN"])
    rows_valid = read_examples_csv(p["DF_PATH_VALID"])
    date_cutoff = parse_date(p["DATE_CUTOFF"])

    metric_manager = generate_metric_manager(
        dataset.restype_to_int, metrics_to_compute=p["METRICS_TO_COMPUTE"])
    use_interface = p["METRICS_TO_COMPUTE"] == "all"
    total_steps = steps_override or p["TOTAL_STEPS"]
    profile_dir = p.get("PROFILE_DIR") or os.environ.get("NA_MPNN_PROFILE_DIR")
    dev = trainer.device

    # Persistent per-split loaders: the worker pool (and each worker's parse
    # cache) survives across epochs; only the epoch's clusters are swapped in.
    loaders = {}

    def get_loader(split, batch_iter):
        if split not in loaders:
            loaders[split] = PrefetchLoader(
                dataset, batch_iter, num_workers=int(p.get("NUM_WORKERS", 0)),
                pad_batch_multiple=mesh.data if mesh is not None else None,
                shard=(mesh.rank, mesh.size) if per_host_feed else None)
        else:
            loaders[split].set_clusters(batch_iter)
        return loaders[split]

    try:
        epoch = epoch0
        while True:
            metric_manager.zero_metrics()
            t0 = time.time()
            generator = None if mesh is not None else _epoch_generator(seed, epoch, dev)
            step0 = trainer.step
            loader_wait_s = 0.0

            def run_split(rows, max_pdbs, split):
                nonlocal profile_dir, loader_wait_s
                split_rng = np.random.RandomState(
                    (seed * 1000003 + epoch * 31 + (0 if split == "train" else 1))
                    % (2 ** 31))
                batch_iter = make_batch_iter(
                    rows, p["BATCH_TOKENS"], p["MIN_PROTEIN_LENGTH_CUTOFF"],
                    date_cutoff, bool(p["CROP_LARGE_STRUCTURES"]), max_pdbs,
                    rng=split_rng)
                batches = iter(get_loader(split, batch_iter))
                while True:
                    t_wait = time.perf_counter()
                    np_batch = next(batches, None)
                    if split == "train":
                        loader_wait_s += time.perf_counter() - t_wait
                    if np_batch is None:
                        break
                    if per_host_feed:
                        np_batch = sync_batch_length(np_batch, mesh)

                    def host(key):
                        return torch.as_tensor(np_batch[key], device=dev)

                    interface = {}
                    if use_interface:
                        interface = {"interface": host("interface_mask"),
                                     "nonInterface": 1 - host("interface_mask")}
                    if split == "train":
                        if profile_dir:
                            trainer.profile_steps(np_batch, generator, profile_dir)
                            profile_dir = None
                        m = trainer.train_step(np_batch, generator)
                    else:
                        m = trainer.eval_step(np_batch)
                    polymer_masks = {k: host(f"{k}_mask")
                                     for k in ("protein", "dna", "rna")}
                    metric_manager.accumulate(
                        m["loss_per_token"], m["accuracy"], m["cbp_accuracy"],
                        host("canonical_base_pair_mask"), host("S"), m["S_pred"],
                        split, m["mask_for_loss"], polymer_masks, interface)

            run_split(rows_train, p["MAX_NUMBER_OF_PDBS_TRAIN"], "train")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.time()
            run_split(rows_valid, p["MAX_NUMBER_OF_PDBS_VALID"], "valid")
            t2 = time.time()

            if per_host_feed:
                metric_manager.all_reduce_across_hosts(dev)
            metric_manager.compute_metrics()
            out_str = metric_manager.create_print_string(
                epoch, trainer.step,
                np.format_float_positional(np.float32(t1 - t0), unique=False, precision=3),
                np.format_float_positional(np.float32(t2 - t1), unique=False, precision=3))
            if lead:
                with open(logfile, "a") as f:
                    f.write(out_str + "\n")
                with open(jsonl_log, "a") as f:
                    f.write(json.dumps({"epoch": epoch + 1, "step": trainer.step,
                                        **metric_manager.as_dict(),
                                        "loader_wait_s": loader_wait_s,
                                        "steps": trainer.step - step0})
                            + "\n")
                print(out_str)

            trainer.save(base + "last.npz", epoch + 1, save_step)
            if trainer.step > save_step + p["SAVE_EVERY_N_STEPS"]:
                save_step += p["SAVE_EVERY_N_STEPS"]
                trainer.save(base + f"s_{trainer.step}.npz", epoch + 1, save_step)
            epoch += 1
            if trainer.step > total_steps:
                break
            if max_epochs is not None and (epoch - epoch0) >= max_epochs:
                break
    finally:
        for loader in loaders.values():
            loader.close()
    return trainer
