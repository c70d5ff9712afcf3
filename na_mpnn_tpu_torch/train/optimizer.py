"""Noam-warmup Adam with global-norm clipping over one flat parameter
vector, with the semantics of the JAX package's optax chain
(``train/optimizer.py``: ``clip_by_global_norm``, ``scale_by_adam``,
``scale_by_learning_rate(noam_schedule)``):

* lr(count) = factor * d_model^-0.5 * min(s^-0.5, s * warmup^-1.5) with
  s = max(count, 1), in float32 as the JAX schedule computes it, so the
  first two updates share lr(1);
* clipping scales by ``max_norm / g_norm`` when ``g_norm >= max_norm``
  (no epsilon);
* Adam(0.9, 0.98), eps 1e-9 outside the square root, bias-corrected.

The state is the optax chain's leaves in order: (adam count, mu, nu,
schedule count). ``mu`` and ``nu`` are updated in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.98, 1e-9


@dataclasses.dataclass
class OptState:
    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    schedule_count: int


def noam_schedule(d_model: int, factor: float = 2.0, warmup: int = 4000):
    """The step -> learning-rate function of the JAX package's
    ``noam_schedule``, in float32 as it computes it."""
    def schedule(step) -> float:
        s = np.maximum(np.float32(step), np.float32(1.0))
        return float(np.float32(factor * d_model ** -0.5) * np.minimum(
            s ** np.float32(-0.5), s * np.float32(warmup ** -1.5)))
    return schedule


class NoamAdam:
    def __init__(self, d_model: int = 128, factor: float = 2.0,
                 warmup: int = 4000, grad_clip_norm: float = 1.0):
        self.d_model, self.factor, self.warmup = d_model, factor, warmup
        self.grad_clip_norm = grad_clip_norm
        self.learning_rate = noam_schedule(d_model, factor, warmup)

    def init(self, flat: torch.Tensor) -> OptState:
        return OptState(0, torch.zeros_like(flat), torch.zeros_like(flat), 0)

    def update(self, grads: torch.Tensor, state: OptState) -> torch.Tensor:
        """The update to add to the flat parameters; advances ``state``."""
        g = grads
        if self.grad_clip_norm and self.grad_clip_norm > 0:
            g_norm = torch.sqrt((g * g).sum())
            g = torch.where(g_norm < self.grad_clip_norm, g,
                            (g / g_norm) * self.grad_clip_norm)
        state.mu.mul_(B1).add_(g * (1 - B1))
        state.nu.mul_(B2).add_(g * g * (1 - B2))
        state.count += 1
        mu_hat = state.mu / (1 - B1 ** state.count)
        nu_hat = state.nu / (1 - B2 ** state.count)
        u = mu_hat / (torch.sqrt(nu_hat) + EPS)
        lr = self.learning_rate(state.schedule_count)
        state.schedule_count += 1
        return u * -lr


def make_optimizer(d_model: int = 128, factor: float = 2.0, warmup: int = 4000,
                   grad_clip_norm: float = 1.0) -> NoamAdam:
    """The optimizer of the JAX package's ``make_optimizer`` (clipping, Adam,
    the Noam schedule) over one flat parameter vector."""
    return NoamAdam(d_model, factor, warmup, grad_clip_norm)
