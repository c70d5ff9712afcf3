"""LigandMPNN's training step in plain PyTorch: the noised, dropped-out
forward (``ligand_model.py``), ProteinMPNN's label-smoothed loss over a
fixed token budget (``training/model_utils.py::loss_smoothed``: the one-hot
plus ``0.1 / 21`` on every letter, renormalised), the gradient clipped to a
global norm, and Adam(0.9, 0.98, eps 1e-9) at the Noam rate (``train.py``'s
``noam_rate``; the same steps as ``train.train_steps`` with the loss passed
in).

The random draws of a step come from one ``torch.Generator`` per step, in
the order the step consumes them: the residues' coordinate noise ``[B,L,16,
3]``, the context atoms' noise ``[B,L,25,3]`` (the published forward noises
``X`` and ``Y`` alike; whether LigandMPNN's training did is not published),
each encoder layer's three dropout masks, each context round's four (the
atom graph's message and FFN, the residue's message and FFN), the one on
``V_C``, the decode order, each decoder layer's two. The context atoms are
chosen on the coordinates before the noise, as ``featurize`` does.

Departure: the letter X (unknown) takes no loss, as NA-MPNN's UNK.
"""
from __future__ import annotations

import torch

from . import ligand_model as LM
from . import model as M
from . import train as R


def loss_smoothed(S, log_probs, mask, weight, tokens):
    S_onehot = torch.nn.functional.one_hot(S, log_probs.shape[-1]).float()
    S_onehot = S_onehot + weight / float(S_onehot.size(-1))
    S_onehot = S_onehot / S_onehot.sum(-1, keepdim=True)
    loss = -(S_onehot * log_probs).sum(-1)
    return torch.sum(loss * mask) / tokens


def loss_of(sd, cfg, batch, generator, prec):
    """One training forward of LigandMPNN and its loss (``cfg``: the
    configuration file's keys)."""
    mask = batch["mask"].float()
    Y, Y_t, Y_m = LM.nearest_atoms(batch["X"], mask, batch["Y"], batch["Y_t"],
                                   batch["Y_m"], cfg["ATOM_CONTEXT_NUM"])
    eps = cfg["PROTEIN_BACKBONE_NOISE"]
    noise = torch.randn(batch["X"].shape, generator=generator,
                        dtype=batch["X"].dtype, device=batch["X"].device)
    X = M.noised(batch, (eps, eps, eps), noise)
    Y = Y + eps * torch.randn(Y.shape, generator=generator, dtype=Y.dtype,
                              device=Y.device)
    drop = R._dropout(cfg["DROPOUT"], generator)
    h_V, h_E, E_idx = LM.encode(sd, batch, cfg["NUM_NEIGHBORS"], prec, X=X, Y=Y,
                                Y_t=Y_t, Y_m=Y_m, drop=drop)
    r = torch.randn(mask.shape, generator=generator, dtype=mask.dtype,
                    device=mask.device)
    order = torch.argsort((mask + 1e-4) * r.abs(), dim=-1, stable=True)
    S = batch["S"].long()
    lp = M.decoder(sd, h_V, h_E, E_idx, mask, S, order, prec, drop)
    takes = mask * (S != LM.X_TOKEN)
    return loss_smoothed(S, lp, takes, cfg["LABEL_SMOOTHING"], cfg["LOSS_TOKENS"])


def pad(structures, L, device):
    """``train.pad`` with the context atoms: ``Y [B,N,3]``, ``Y_t``, ``Y_m``
    (absent atoms zero) and ``S`` of absent rows the letter X."""
    out = R.pad(structures, L, device)
    out["S"] = torch.where(out["mask"] > 0, out["S"], LM.X_TOKEN)
    n = max(len(s["Y"]) for s in structures)
    Y = torch.zeros((len(structures), n, 3), dtype=torch.float32)
    Y_t = torch.zeros((len(structures), n), dtype=torch.long)
    Y_m = torch.zeros((len(structures), n), dtype=torch.float32)
    for i, s in enumerate(structures):
        k = len(s["Y"])
        Y[i, :k] = torch.as_tensor(s["Y"], dtype=torch.float32)
        Y_t[i, :k] = torch.as_tensor(s["Y_t"], dtype=torch.long)
        Y_m[i, :k] = torch.as_tensor(s["Y_m"], dtype=torch.float32)
    out.update(Y=Y.to(device), Y_t=Y_t.to(device), Y_m=Y_m.to(device))
    return out


def train_steps(sd0, cfg, batches, generators, prec, loss=loss_of):
    """``train.train_steps`` with the step's ``loss(sd, cfg, batch,
    generator, prec)``: (the losses, each leaf's first gradient as Adam
    takes it (clipped), the parameters after the last step). A batch may be
    a list of batches whose losses add into one step (one step on their
    union, its gradient summed part by part)."""
    sd = {k: v.detach().clone().requires_grad_(True) for k, v in sd0.items()}
    mu = {k: torch.zeros_like(v) for k, v in sd.items()}
    nu = {k: torch.zeros_like(v) for k, v in sd.items()}
    losses, first = [], None
    for count, (batch, gen) in enumerate(zip(batches, generators)):
        parts = batch if isinstance(batch, list) else [batch]
        gens = gen if isinstance(gen, list) else [gen]
        total, grads = 0.0, {k: torch.zeros_like(v) for k, v in sd.items()}
        for part, g in zip(parts, gens):
            value = loss(sd, cfg, part, g, prec)
            got = torch.autograd.grad(value, list(sd.values()), allow_unused=True)
            for k, d in zip(sd, got):
                if d is not None:
                    grads[k] += d
            total += float(value.detach())
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = cfg["GRADIENT_NORM"]
        if norm >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        lr = R.noam_rate(count, d_model=cfg["HIDDEN_DIM"])
        with torch.no_grad():
            for k, v in sd.items():
                mu[k].mul_(R.ADAM_B1).add_(grads[k] * (1 - R.ADAM_B1))
                nu[k].mul_(R.ADAM_B2).add_(grads[k] * grads[k] * (1 - R.ADAM_B2))
                m_hat = mu[k] / (1 - R.ADAM_B1 ** (count + 1))
                v_hat = nu[k] / (1 - R.ADAM_B2 ** (count + 1))
                v.add_(-lr * m_hat / (torch.sqrt(v_hat) + R.ADAM_EPS))
        losses.append(total)
    return losses, first, {k: v.detach() for k, v in sd.items()}
