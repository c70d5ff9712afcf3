"""Faults planted in the program, to show that a cell's check fails them.

Each takes the cell's driver before set-up and patches the program for the
rest of the process (the tests put the patched attributes back):

* ``token``: the sampler's first designed position in decode order gets
  another letter, after the sampler produced it (design, specificity);
* ``answer``: one position of each scored order has its letters' log-
  probabilities rotated (score);
* ``half``: half of the batch left out and the rest repeated in its place,
  the mean then taken over the rows kept (the sampler's rows, the score's
  orders, the training batch's structures);
* ``frozen``: the training step returns its state unchanged;
* ``temperature``: the sampler draws at ten times the temperature asked
  for, its log-probabilities untouched (design, specificity);
* ``argmax``: the sampler takes the likeliest letter (a temperature of
  1e-4), its log-probabilities untouched (design, specificity).
"""
from __future__ import annotations

import torch


def _first_designed(out):
    """Per row, the first position in decode order with a designed letter."""
    designed = out["log_probs"].abs().sum(-1) > 0
    order = out["decoding_order"]
    ranked = torch.gather(designed, 1, order)
    return torch.gather(order, 1, ranked.float().argmax(1, keepdim=True))[:, 0]


def token(driver):
    from na_mpnn_tpu_torch.models import mpnn
    original = mpnn.sample

    def sample(*args, **kwargs):
        out = original(*args, **kwargs)
        rows = torch.arange(out["S"].shape[0], device=out["S"].device)
        pos = _first_designed(out)
        out["S"][rows, pos] = (out["S"][rows, pos] + 1) % 20
        return out
    mpnn.sample = sample


def answer(driver):
    from na_mpnn_tpu_torch.models import mpnn
    original = mpnn.score

    def score(*args, **kwargs):
        out = original(*args, **kwargs)
        lp = out["log_probs"]
        lp[:, 0] = lp[:, 0].roll(1, dims=-1)
        return out
    mpnn.score = score


def half(driver):
    from na_mpnn_tpu_torch.models import mpnn
    from na_mpnn_tpu_torch.train import trainer

    def rep(v, n):
        return v.repeat((-(-n // v.shape[0]),) + (1,) * (v.dim() - 1))[:n]

    def tile(out, n):
        return {k: rep(v, n) if torch.is_tensor(v) and v.dim() else v
                for k, v in out.items()}

    sample = mpnn.sample

    def half_sample(params, cfg, batch, generator, num_samples=1, **kw):
        out = sample(params, cfg, batch, generator, max(1, num_samples // 2), **kw)
        return tile(out, num_samples)
    mpnn.sample = half_sample

    score = mpnn.score

    def half_score(params, cfg, batch, *args, **kw):
        n = batch["S"].shape[0]
        out = score(params, cfg, {k: v[:max(1, n // 2)] for k, v in batch.items()},
                    *args, **kw)
        return tile(out, n)
    mpnn.score = half_score

    loss_and_grads = trainer.Trainer.loss_and_grads

    def half_batch(self, batch, generator=None):
        n = batch["S"].shape[0]
        kept = {k: v[:max(1, n // 2)] for k, v in batch.items()}
        share = float(batch["mask"].sum()) / float(kept["mask"].sum())
        loss, grad, *rest = loss_and_grads(self, kept, generator)
        return (loss * share, grad * share, *(rep(r, n) for r in rest))
    trainer.Trainer.loss_and_grads = half_batch


def frozen(driver):
    from na_mpnn_tpu_torch.train import optimizer

    def update(self, grads, state):
        return torch.zeros_like(grads)
    optimizer.NoamAdam.update = update


def _temperature(scale):
    def plant(driver):
        from na_mpnn_tpu_torch.models import mpnn
        original = mpnn.sample

        def sample(*args, temperature=0.1, **kwargs):
            return original(*args, temperature=temperature * scale, **kwargs)
        mpnn.sample = sample
    return plant


FAULTS = {"token": token, "answer": answer, "half": half, "frozen": frozen,
          "temperature": _temperature(10.0), "argmax": _temperature(1e-3)}
