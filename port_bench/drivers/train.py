"""Training cells: the window drives ``Trainer.train_step`` over host
batches built in set-up (protein-nucleic-acid complexes packed to the
token budget and collated to the program's length buckets), cycled in the
seed's order, as the loader's prefetch hides collation in
``run_training``.

Set-up builds one Trainer on weights drawn on the card from the seed, and
drives it through its first ``check_steps`` steps, each on another batch
and with a generator of its own; the window continues with that same
object. The reference follows those steps from the same weights, batches and
generators. Each step's loss, each leaf's first gradient as Adam took it
(read back from Adam's first moment after one step) and each leaf's change
over the checked steps are compared.
"""
from __future__ import annotations

import statistics
import sys

import torch

from .. import costs, traffic, weights
from . import worst
from ..reference import model as M
from ..reference import train as R

# the program's parameter tree (JAX layout, ``[in, out]`` weights) against
# the reference state dict
_NORMS = {"norm1", "norm2", "norm3", "norm_nodes", "norm_edges"}


def sd_key(path):
    """(state-dict key, transposed) of a program leaf path such as
    ``("encoder", 0, "W1", "w")``."""
    parts = [str(p) for p in path]
    head, leaf = parts[:-1], parts[-1]
    if head[0] == "encoder":
        head = ["encoder_layers"] + head[1:]
    elif head[0] == "decoder":
        head = ["decoder_layers"] + head[1:]
    elif head[0] == "features" and head[1] == "positional":
        head = ["features", "embeddings", "linear"]
    if head[-1] in _NORMS:
        return ".".join(head) + (".weight" if leaf == "scale" else ".bias"), False
    if head[-1] == "W_s":
        return "W_s.weight", False
    return ".".join(head) + (".weight" if leaf == "w" else ".bias"), leaf == "w"


def leaf_paths(tree, prefix=()):
    """Leaf paths in the program's flat order (lists in order, dict keys
    sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (i,))
    else:
        yield prefix, tree


class Driver:
    # wait for the card after each request (a request's time is its own)
    sync_each = False

    def __init__(self, cell):
        self.cell = cell
        self.mix = cell.mix

    def setup(self):
        from na_mpnn_tpu_torch.train.collate import collate_batch
        from na_mpnn_tpu_torch.train.trainer import Trainer, model_config_from_params

        cell, cfg = self.cell, self.cell.config
        structures, packing = traffic.training_pool(self.mix)
        self.raw = [traffic.arrays(s, cell.seed, i) for i, s in enumerate(structures)]
        self.groups = [packing[i] for i in traffic.rng_for(cell.seed, 6).permutation(len(packing))]
        self.batches = [collate_batch([self.raw[i] for i in g]) for g in self.groups]
        self.tokens = [int(sum(len(self.raw[i]["S"]) for i in g)) for g in self.groups]
        atoms = [sum(float((costs.ATOMS_PRESENT["protein"] * self.raw[i]["protein_mask"]
                            + costs.ATOMS_PRESENT["dna"] * self.raw[i]["dna_mask"]
                            + costs.ATOMS_PRESENT["rna"] * self.raw[i]["rna_mask"]).sum())
                     for i in g) for g in self.groups]
        self.pairs = [(a / t) ** 2 for a, t in zip(atoms, self.tokens)]
        self.sd = weights.make(cfg, cell.seed, cell.device)
        self.trainer = Trainer(model_config_from_params(cfg),
                               label_smoothing=cfg["LABEL_SMOOTHING"],
                               loss_tokens=float(cfg["LOSS_TOKENS"]),
                               grad_clip_norm=cfg["GRADIENT_NORM"],
                               na_shared_tokens=bool(cfg["NA_SHARED_TOKENS"]),
                               seed=0, device=cell.device)
        self.paths = [p for p, _ in leaf_paths(self.trainer.params)]
        self.sizes = [t.numel() for _, t in leaf_paths(self.trainer.params)]
        with torch.no_grad():
            flat = []
            for p, t in leaf_paths(self.trainer.params):
                key, tr = sd_key(p)
                v = self.sd[key].t() if tr else self.sd[key]
                flat.append(v.reshape(t.shape).reshape(-1))
            self.trainer.flat.copy_(torch.cat(flat))
        self.start = self.trainer.flat.detach().clone()
        self.step_seeds = traffic.rng_for(cell.seed, 7).integers(1, 2 ** 62, size=8)
        n = self.mix["check_steps"]
        self.losses, self.first_grad = [], None
        for s in range(n):
            gen = torch.Generator(device=cell.device).manual_seed(int(self.step_seeds[s]))
            m = self.trainer.train_step(self.batches[s], gen)
            self.losses.append(float(m["loss_av"]))
            if s == 0:
                self.first_grad = (self.trainer.opt_state.mu / (1 - R.ADAM_B1)).clone()
        self.after = self.trainer.flat.detach().clone()
        # every other (B, L) once, so that no first allocation falls in the window
        self.gen = torch.Generator(device=cell.device).manual_seed(int(self.step_seeds[-1]))
        seen = {self.batches[s]["S"].shape for s in range(n)}
        for b in self.batches[n:]:
            if b["S"].shape not in seen:
                seen.add(b["S"].shape)
                self.trainer.train_step(b, self.gen)
        self.next = n

    def request(self, i):
        k = (self.next + i) % len(self.batches)
        self.trainer.train_step(self.batches[k], self.gen)
        return {"batch": k, "tokens": self.tokens[k], "pairs": self.pairs[k],
                "shape": tuple(self.batches[k]["S"].shape)}

    def restore(self):
        pass

    def release(self):
        self.trainer = None
        if self.cell.device != "cpu":
            torch.cuda.empty_cache()

    def _split(self, flat):
        out, at = {}, 0
        for p, n in zip(self.paths, self.sizes):
            key, tr = sd_key(p)
            v = flat[at:at + n]
            at += n
            shape = self.sd[key].shape
            out[key] = v.view(shape[::-1]).t() if tr else v.view(shape)
        return out

    def check(self, requests, control=None):
        """(name, value): ``loss_gap`` the largest relative gap of a checked
        step's loss; ``grad_gap`` and ``update_gap`` the worst leaf's gap
        between the program's and the reference's norms of the first
        gradient and of the change over the checked steps, against the
        reference's norm of that leaf or of the median leaf, whichever is
        larger. Leaves whose reference gradient is under a thousandth of the
        median leaf's move by round-off alone and are left out of the
        change."""
        cell, n = self.cell, self.mix["check_steps"]
        batches = [R.pad([self.raw[i] for i in g], b["S"].shape[1], cell.device)
                   for g, b in zip(self.groups[:n], self.batches[:n])]

        def gens():
            return [torch.Generator(device=cell.device).manual_seed(int(s))
                    for s in self.step_seeds[:n]]

        with M.exact_float32():
            losses, grad, after = R.train_steps(self.sd, cell.config, batches, gens(),
                                                M.Precision("fp32"))
            p_losses, p_grad, p_after = self.losses, self._split(self.first_grad), \
                self._split(self.after)
            if control is not None:
                p_losses, p_grad, p_after = R.train_steps(
                    self.sd, cell.config, batches, gens(), M.Precision(control))
        start = self._split(self.start)
        g_norm = {k: float(v.norm()) for k, v in grad.items()}
        d_norm = {k: float((after[k] - start[k]).norm()) for k in grad}
        g_med, d_med = statistics.median(g_norm.values()), statistics.median(d_norm.values())
        grad_gap = worst(abs(float(p_grad[k].norm()) - g_norm[k]) / max(g_norm[k], g_med)
                         for k in grad)
        moved = [k for k in grad if g_norm[k] >= 1e-3 * g_med]
        update_gap = worst(abs(float((p_after[k] - start[k]).norm()) - d_norm[k])
                           / max(d_norm[k], d_med) for k in moved)
        loss_gap = worst(abs(a - b) / abs(b) for a, b in zip(p_losses, losses))
        print("update_gap leaves left out (reference gradient under a thousandth of "
              f"the median leaf's): {sorted(set(grad) - set(moved))}", file=sys.stderr)
        return [("loss_gap", loss_gap), ("grad_gap", grad_gap), ("update_gap", update_gap)]
