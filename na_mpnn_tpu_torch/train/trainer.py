"""The training step: forward + loss + gradients + Noam-Adam update, the
evaluation step and ``.npz`` checkpoints (port of the JAX package's
``train/trainer.py::Trainer``, fp32), on one device or on a
``torch.distributed`` mesh.

With a mesh (``parallel/mesh.py``), every rank holds the same parameters
(rank 0's, broadcast after init and restore), takes its ``shard_batch`` of
the global batch, and runs ``forward_graph_parallel`` at every mesh shape
(at G = 1 its gathers are identities), whose random streams are keyed by
(seed, step, global row); the loss is a sum over tokens divided by a
constant, so one all-reduce of the flat gradient over the world gives the
global gradient, and every rank then takes the same clipped Adam update.
Metrics are computed on the log-probs all-gathered along the graph axis and
then gathered over the data axis: the global ``[B, L]`` arrays.

The parameters live in one flat buffer, in ``ravel_pytree`` order (lists in
order, dict keys sorted), and the parameter tree the model reads is a tree of
views into it; each view is a leaf that takes its own gradient. The
optimizer runs over the flat vector, as the JAX trainer does, so its moments
save straight into the JAX checkpoint layout: ``opt/leaf0000..0003`` =
(adam count, mu, nu, schedule count).

Batches are host numpy dicts (``collate_batch``); they reach the card as one
pinned-memory, non-blocking copy per array.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..models import ModelConfig, forward, init_params
from ..params import load_checkpoint_npz, save_checkpoint_npz
from ..parallel.graph_parallel import all_gather_rows, forward_graph_parallel
from ..parallel.mesh import Mesh, all_gather_batch, replicated, shard_batch
from .losses import (compute_canonical_base_pair_accuracy, loss_nll,
                     loss_smoothed, make_polymer_restype_masks, mask_for_loss)
from .optimizer import NoamAdam, OptState


def model_config_from_params(params: Dict) -> ModelConfig:
    """ModelConfig from a reference-style JSON parameter dict (the JAX
    package's ``model_config_from_params``)."""
    return ModelConfig(
        node_features=params.get("HIDDEN_DIM", 128),
        edge_features=params.get("HIDDEN_DIM", 128),
        hidden_dim=params.get("HIDDEN_DIM", 128),
        num_encoder_layers=params.get("NUM_ENCODER_LAYERS", 3),
        num_decoder_layers=params.get("NUM_DECODER_LAYERS", 3),
        k_neighbors=params.get("NUM_NEIGHBORS", 32),
        vocab=params.get("VOCAB_SIZE", 33),
        num_letters=params.get("NUM_LETTERS", 33),
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
    )


BATCH_KEYS = [
    "X", "X_m", "mask", "S", "R_idx", "chain_labels", "protein_mask",
    "dna_mask", "rna_mask", "R_polymer_type", "interface_mask",
    "base_pair_mask", "base_pair_index", "canonical_base_pair_mask",
    "canonical_base_pair_index", "aligned_ppm", "ppm_mask",
]


# The batch arrays the metrics read (S, the loss per token's masks and PPM
# labels, the canonical base pairs).
METRIC_KEYS = ("S", "protein_mask", "dna_mask", "rna_mask", "ppm_mask",
               "aligned_ppm", "canonical_base_pair_mask",
               "canonical_base_pair_index")


def to_device(np_batch, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The ``BATCH_KEYS`` arrays of a host batch on ``device``: floats as
    ``dtype``, integers as they are; pinned and non-blocking on a card."""
    device = torch.device(device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    out = {}
    for k in BATCH_KEYS:
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
                 mesh: Mesh = None, dtype=torch.float32):
        self.cfg = cfg
        self.mesh = mesh
        self.seed = seed
        self.dtype = dtype
        self.device = torch.device(device) if mesh is None else mesh.device
        self.label_smoothing = label_smoothing
        self.loss_tokens = loss_tokens
        self.na_shared_tokens = na_shared_tokens
        self.restype_masks = make_polymer_restype_masks(na_shared_tokens)
        self.optimizer = NoamAdam(cfg.hidden_dim, grad_clip_norm=grad_clip_norm)
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
        log_probs = self._log_probs(batch, generator, train=True)
        mfl = mask_for_loss(batch["S"], batch["mask"],
                            self.na_shared_tokens).to(log_probs.dtype)
        loss_per_token, loss_av = self._loss(log_probs, batch, mfl)
        loss_av.backward()
        grad = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in self.leaves])
        for p in self.leaves:
            p.grad = None
        loss_av = loss_av.detach()
        if self.mesh is not None:
            dist.all_reduce(grad)
            dist.all_reduce(loss_av)
        return (loss_av, grad, log_probs.detach(), mfl,
                loss_per_token.detach())

    def _metrics(self, batch, log_probs, mfl, loss_per_token=None):
        """Per-token metrics of the global batch: with a mesh, from the
        log-probs and batch arrays gathered along the graph axis, then over
        the data axis."""
        if self.mesh is None:
            return self._metrics_from_logprobs(batch, log_probs, mfl,
                                               loss_per_token)
        with torch.no_grad():
            rows = {k: all_gather_rows(batch[k], self.mesh)
                    for k in METRIC_KEYS if k in batch}
            m = self._metrics_from_logprobs(
                rows, all_gather_rows(log_probs, self.mesh),
                all_gather_rows(mfl, self.mesh))
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
        the host batch has one)."""
        if self.mesh is None:
            return to_device(np_batch, self.device, self.dtype)
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
        metrics = self._train_step_impl(self.device_batch(np_batch), generator)
        self.step += 1
        return metrics

    def eval_step(self, np_batch):
        return self._eval_step_impl(self.device_batch(np_batch))

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
            raise NotImplementedError(
                f"{path}: orbax directory checkpoints are not ported "
                "(ROADMAP Queue 1, 'Multi-GPU')")
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
