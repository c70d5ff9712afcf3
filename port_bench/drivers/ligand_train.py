"""LigandMPNN training cells: ``Trainer.train_step`` of a ``ligand_mpnn``
configuration over host batches of protein complexes with context atoms
(``traffic_ligand.py``), built in set-up, collated to the program's length
buckets, cycled in the seed's order, as ``drivers/train.py`` drives
NA-MPNN.

Set-up fails at once, before any traffic or weights, on a program with no
``ligand_mpnn`` model type. The weights are drawn on the card from the
seed in LigandMPNN's own state-dict layout (``weights_ligand.py``) and put
into the Trainer's parameters by name (``sd_key``); the reference
(``reference/ligand_train.py``) follows the checked steps from the same
weights, batches and generators, and the check compares as
``drivers/train.py`` does (``loss_gap``, ``grad_gap``, ``update_gap``).
"""
from __future__ import annotations

import torch

from .. import traffic, traffic_ligand, train_gaps, weights_ligand
from ..reference import ligand_model as LM
from ..reference import ligand_train as LT
from ..reference import model as M
from . import train

_STACKS = {"encoder": "encoder_layers", "decoder": "decoder_layers",
           "context_layers": "context_encoder_layers",
           "y_context_layers": "y_context_encoder_layers"}
_NORMS = {"norm1", "norm2", "norm3", "norm_nodes", "norm_edges", "norm_y_nodes",
          "norm_y_edges", "V_C_norm"}


def sd_key(path):
    """(LigandMPNN state-dict key, transposed) of a program leaf path such
    as ``("context", "y_edges", "w")`` or ``("y_context_layers", 0, "W1",
    "b")``."""
    parts = [str(p) for p in path]
    head, leaf = parts[:-1], parts[-1]
    if head[0] in _STACKS:
        head = [_STACKS[head[0]]] + head[1:]
    elif head[0] == "features" and head[1] == "positional":
        head = ["features", "embeddings", "linear"]
    elif head[0] == "context":
        head = ["features"] + head[1:]
    if head[-1] in _NORMS:
        return ".".join(head) + (".weight" if leaf == "scale" else ".bias"), False
    if head[-1] == "W_s":
        return "W_s.weight", False
    return ".".join(head) + (".weight" if leaf == "w" else ".bias"), leaf == "w"


class Driver(train.Driver):
    def setup(self):
        from na_mpnn_tpu_torch.models import config as program_config
        if "ligand_mpnn" not in getattr(program_config, "MODEL_TYPES", ()):
            raise RuntimeError("this program has no ligand_mpnn model type")
        from na_mpnn_tpu_torch.train.collate import collate_batch
        from na_mpnn_tpu_torch.train.trainer import Trainer, model_config_from_params

        cell, cfg, mix = self.cell, self.cell.config, self.mix
        pool, packing = traffic_ligand.training_pool(mix)
        self.raw = [traffic_ligand.arrays(s, mix, cell.seed, i) for i, s in enumerate(pool)]
        self.groups = [packing[i] for i in traffic.rng_for(cell.seed, 6).permutation(len(packing))]
        self.batches = [collate_batch([self.raw[i] for i in g], pad_token=LM.X_TOKEN)
                        for g in self.groups]
        self.tokens = [int(sum(len(self.raw[i]["S"]) for i in g)) for g in self.groups]
        self.pairs = [25.0] * len(self.groups)      # protein residues: 5 x 5 atoms
        self.sd = weights_ligand.make(cfg, cell.seed, cell.device)
        self.trainer = Trainer(model_config_from_params(cfg),
                               label_smoothing=cfg["LABEL_SMOOTHING"],
                               loss_tokens=float(cfg["LOSS_TOKENS"]),
                               grad_clip_norm=cfg["GRADIENT_NORM"],
                               seed=0, device=cell.device)
        leaves = list(train.leaf_paths(self.trainer.params))
        self.paths = [p for p, _ in leaves]
        self.sizes = [t.numel() for _, t in leaves]
        with torch.no_grad():
            flat = []
            for p, t in leaves:
                key, tr = sd_key(p)
                v = self.sd[key].t() if tr else self.sd[key]
                flat.append(v.reshape(t.shape).reshape(-1))
            self.trainer.flat.copy_(torch.cat(flat))
        self.start = self.trainer.flat.detach().clone()
        self.step_seeds = traffic.rng_for(cell.seed, 7).integers(1, 2 ** 62, size=8)
        n = mix["check_steps"]
        self.losses, self.first_grad = [], None
        for s in range(n):
            gen = torch.Generator(device=cell.device).manual_seed(int(self.step_seeds[s]))
            m = self.trainer.train_step(self.batches[s], gen)
            self.losses.append(float(m["loss_av"]))
            if s == 0:
                self.first_grad = (self.trainer.opt_state.mu / (1 - train.R.ADAM_B1)).clone()
        self.after = self.trainer.flat.detach().clone()
        self.gen = torch.Generator(device=cell.device).manual_seed(int(self.step_seeds[-1]))
        seen = {self.batches[s]["S"].shape for s in range(n)}
        for b in self.batches[n:]:
            if b["S"].shape not in seen:
                seen.add(b["S"].shape)
                self.trainer.train_step(b, self.gen)
        self.next = n

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
        """``drivers/train.py``'s check against LigandMPNN's reference step."""
        cell, n = self.cell, self.mix["check_steps"]
        batches = [LT.pad([self.raw[i] for i in g], b["S"].shape[1], cell.device)
                   for g, b in zip(self.groups[:n], self.batches[:n])]

        def gens():
            return [torch.Generator(device=cell.device).manual_seed(int(s))
                    for s in self.step_seeds[:n]]

        def steps(prec):
            return LT.train_steps(self.sd, cell.config, batches, gens(), M.Precision(prec))

        with M.exact_float32():
            reference = steps("fp32")
            program = (steps(control) if control is not None else
                       (self.losses, self._split(self.first_grad), self._split(self.after)))
        return train_gaps.compare(reference, program, self._split(self.start))
