"""NA-MPNN's training step in plain PyTorch: the noised, dropped-out
forward, the label-smoothed loss over a fixed token budget, the gradient
clipped to a global norm, and Adam(0.9, 0.98, eps 1e-9) at the Noam rate
(NA-MPNN ``training/na_model_utils.py``: ``loss_smoothed``, ``NoamOpt``).

The random draws of a step come from one ``torch.Generator`` per step, in
the order the step consumes them: the coordinate noise, then for each
encoder layer the node-message, FFN and edge-message dropout masks, then the
decode order, then for each decoder layer the node-message and FFN masks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import model as M
from . import tokens as T

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.98, 1e-9


def noam_rate(count, d_model=128, factor=2.0, warmup=4000):
    """The Noam learning rate of update ``count`` (0 for the first), in
    float32: ``factor * d^-0.5 * min(s^-0.5, s * warmup^-1.5)``, s =
    max(count, 1)."""
    s = np.maximum(np.float32(count), np.float32(1.0))
    return float(np.float32(factor * d_model ** -0.5) * np.minimum(
        s ** np.float32(-0.5), s * np.float32(warmup ** -1.5)))


def pad(structures, L, device):
    """Per-structure input dicts -> a batch of float tensors ``[B, L, ...]``
    (absent rows zero)."""
    out = {}
    for key in ("X", "X_m", "mask", "S", "R_idx", "chain_labels", "protein_mask",
                "dna_mask", "rna_mask", "R_polymer_type"):
        first = np.asarray(structures[0][key])
        a = np.zeros((len(structures), L) + first.shape[1:], first.dtype)
        for i, s in enumerate(structures):
            a[i, :len(s[key])] = s[key]
        out[key] = torch.from_numpy(a).to(device)
    out["X"] = out["X"].float()
    return out


def loss_smoothed(batch, log_probs, smoothing, tokens):
    """Per-token cross-entropy against the one-hot letter with ``smoothing``
    spread over the letters of the token's polymer (protein 21, DNA 5, RNA
    5), summed over the tokens that take a loss and divided by ``tokens``."""
    S = batch["S"].long()
    prot, dna, rna = (torch.zeros(T.NUM_LETTERS, device=S.device) for _ in range(3))
    p_i, d_i, r_i = T.group_ints()
    prot[p_i], dna[d_i], rna[r_i] = 1.0, 1.0, 1.0
    eps = (batch["protein_mask"][..., None] * prot * (smoothing / len(p_i))
           + batch["dna_mask"][..., None] * dna * (smoothing / len(d_i))
           + batch["rna_mask"][..., None] * rna * (smoothing / len(r_i)))
    union = ((prot + dna + rna) > 0).float()
    target = F.one_hot(S, T.NUM_LETTERS).float() * (1.0 - smoothing * union) + eps
    loss = -(target * log_probs).sum(-1)
    takes = batch["mask"] * ~torch.isin(S, torch.tensor(T.NO_LOSS, device=S.device))
    return (loss * takes).sum() / tokens


def _dropout(rate, generator):
    keep = 1.0 - rate

    def drop(x, slot):
        u = torch.rand(x.reshape(x.shape[0], x.shape[1], -1).shape,
                       generator=generator, dtype=x.dtype, device=x.device)
        return torch.where(u.view_as(x) < keep, x / keep, 0.0)
    return drop


def loss_of(sd, cfg, batch, generator, prec):
    """One training forward and its loss (``cfg``: the configuration file's
    training keys)."""
    eps = (cfg["PROTEIN_BACKBONE_NOISE"], cfg["DNA_BACKBONE_NOISE"],
           cfg["RNA_BACKBONE_NOISE"])
    noise = torch.randn(batch["X"].shape, generator=generator,
                        dtype=batch["X"].dtype, device=batch["X"].device)
    X = M.noised(batch, eps, noise)
    drop = _dropout(cfg["DROPOUT"], generator)
    mask = batch["mask"].float()
    h_V, h_E, E_idx, mask_attend = M.features(sd, batch, cfg["NUM_NEIGHBORS"],
                                              prec, X=X)
    h_V, h_E = M.encoder(sd, h_V, h_E, E_idx, mask, mask_attend, prec, drop)
    r = torch.randn(mask.shape, generator=generator, dtype=mask.dtype,
                    device=mask.device)
    order = torch.argsort((mask + 1e-4) * r.abs(), dim=-1, stable=True)
    lp = M.decoder(sd, h_V, h_E, E_idx, mask, batch["S"].long(), order, prec, drop)
    return loss_smoothed(batch, lp, cfg["LABEL_SMOOTHING"], cfg["LOSS_TOKENS"])


def train_steps(sd0, cfg, batches, generators, prec):
    """Steps of the training loop from the parameters ``sd0`` (not changed),
    one per batch, each drawing from its generator. Returns (the losses,
    each leaf's first gradient as Adam takes it (clipped), the parameters
    after the last step)."""
    sd = {k: v.detach().clone().requires_grad_(True) for k, v in sd0.items()}
    mu = {k: torch.zeros_like(v) for k, v in sd.items()}
    nu = {k: torch.zeros_like(v) for k, v in sd.items()}
    losses, first = [], None
    for count, (batch, gen) in enumerate(zip(batches, generators)):
        loss = loss_of(sd, cfg, batch, gen, prec)
        grads = torch.autograd.grad(loss, list(sd.values()), allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g)
                 for (k, v), g in zip(sd.items(), grads)}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = cfg["GRADIENT_NORM"]
        if norm >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        lr = noam_rate(count, d_model=cfg["HIDDEN_DIM"])
        with torch.no_grad():
            for k, v in sd.items():
                mu[k].mul_(ADAM_B1).add_(grads[k] * (1 - ADAM_B1))
                nu[k].mul_(ADAM_B2).add_(grads[k] * grads[k] * (1 - ADAM_B2))
                m_hat = mu[k] / (1 - ADAM_B1 ** (count + 1))
                v_hat = nu[k] / (1 - ADAM_B2 ** (count + 1))
                v.add_(-lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
        losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in sd.items()}
