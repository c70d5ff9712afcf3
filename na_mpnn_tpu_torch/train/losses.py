"""Training losses and batch metrics (port of the JAX package's
``train/losses.py``):

* NLL loss and argmax accuracy (``loss_nll``);
* label-smoothed cross-entropy with a smoothing mass per polymer and PPM
  soft labels substituted into the one-hot target (``loss_smoothed``), and
  ProteinMPNN's uniform smoothing for LigandMPNN (``loss_smoothed_uniform``);
* canonical-base-pair accuracy through the partner index.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants


def loss_nll(S, log_probs, mask):
    """Per-token NLL, its masked mean and argmax correctness (float32)."""
    loss = -torch.gather(log_probs, -1, S.long()[..., None])[..., 0]
    true_false = (S.long() == log_probs.argmax(dim=-1)).to(torch.float32)
    loss_av = (loss * mask).sum() / mask.sum()
    return loss, loss_av, true_false


def make_polymer_restype_masks(na_shared_tokens: bool = True) -> Dict:
    prot, dna, rna, _ = constants.restype_group_ints(na_shared_tokens)
    return {
        "protein": constants.polymer_restype_mask_array(prot),
        "dna": constants.polymer_restype_mask_array(dna),
        "rna": constants.polymer_restype_mask_array(rna),
        "nums": {"protein": float(len(prot)), "dna": float(len(dna)),
                 "rna": float(len(rna))},
    }


def loss_smoothed(S, log_probs, mask, polymer_masks, restype_masks,
                  weight=0.1, tokens=6000.0, num_letters=33,
                  ppm_mask=None, aligned_ppm=None):
    """Label-smoothed cross-entropy with the smoothing mass spread over each
    polymer's restypes (w/21 protein, w/5 DNA, w/5 RNA) and PPM soft labels
    where ``ppm_mask``. The sum is normalised by the fixed token budget
    ``tokens`` (LOSS_TOKENS), not by the mask. -> (per token, average)."""
    dtype, device = log_probs.dtype, log_probs.device
    S_onehot = F.one_hot(S.long(), num_letters).to(dtype)
    if ppm_mask is not None and aligned_ppm is not None:
        pm = ppm_mask.to(dtype)[..., None]
        S_onehot = (1.0 - pm) * S_onehot + pm * aligned_ppm.to(dtype)

    def table(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    prm, drm, rrm = (table(restype_masks[k]) for k in ("protein", "dna", "rna"))
    nums = restype_masks["nums"]
    eps = (polymer_masks["protein"].to(dtype)[..., None] * prm
           * (weight / nums["protein"])
           + polymer_masks["dna"].to(dtype)[..., None] * drm
           * (weight / nums["dna"])
           + polymer_masks["rna"].to(dtype)[..., None] * rrm
           * (weight / nums["rna"]))
    # Every polymer-restype column is scaled by (1 - weight); MAS/PAD stay.
    # The union matters: with shared NA tokens the DNA columns are in both
    # the dna and the rna restype masks.
    all_restype_mask = ((prm + drm + rrm) > 0).to(dtype)
    S_onehot = S_onehot * (1.0 - weight * all_restype_mask) + eps
    loss = -(S_onehot * log_probs).sum(dim=-1)
    return loss, (loss * mask).sum() / tokens


def loss_smoothed_uniform(S, log_probs, mask, weight=0.1, tokens=6000.0,
                          num_letters=21):
    """ProteinMPNN's label smoothing (``training/model_utils.py::
    loss_smoothed``), LigandMPNN's loss: the one-hot target plus
    ``weight / num_letters`` on every letter, renormalised; the sum over
    ``mask`` divided by the fixed token budget ``tokens``. -> (per token,
    average)."""
    target = F.one_hot(S.long(), num_letters).to(log_probs.dtype) + weight / num_letters
    target = target / target.sum(-1, keepdim=True)
    loss = -(target * log_probs).sum(dim=-1)
    return loss, (loss * mask).sum() / tokens


def compute_canonical_base_pair_accuracy(log_probs, canonical_base_pair_mask,
                                         canonical_base_pair_index,
                                         na_shared_tokens: bool = True):
    """1 where the argmax predictions at (i, partner(i)) form one of the 16
    canonical pairs, times ``canonical_base_pair_mask``."""
    S_pred = log_probs.argmax(dim=-1)
    partner = torch.gather(S_pred, 1, canonical_base_pair_index.long())
    acc = torch.zeros_like(S_pred, dtype=torch.bool)
    for res_i, res_j in constants.canonical_base_pair_ints(na_shared_tokens):
        acc = acc | ((S_pred == res_i) & (partner == res_j))
    return acc.to(torch.int32) * canonical_base_pair_mask


def mask_for_loss(S, mask, na_shared_tokens: bool = True):
    """``mask`` without the tokens that never receive loss (UNK, DX, RX,
    MAS, PAD)."""
    no_loss = torch.as_tensor(constants.tokens_with_no_loss(na_shared_tokens),
                              device=S.device)
    S_mask = 1 - (S.long()[..., None] == no_loss).any(dim=-1).to(mask.dtype)
    return mask * S_mask
