"""The training check's numbers (``drivers/train.py``'s arithmetic, for the
training drivers added after it): the program's losses, first clipped
gradient and parameters after the checked steps against the reference's."""
from __future__ import annotations

import statistics
import sys

from .drivers import worst


def compare(reference, program, start):
    """[(name, value)]: ``loss_gap`` the largest relative gap of a checked
    step's loss; ``grad_gap`` and ``update_gap`` the worst leaf's gap between
    the program's and the reference's norms of the first gradient and of the
    change over the checked steps, against the reference's norm of that leaf
    or of the median leaf, whichever is larger. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the change. ``reference`` and ``program`` are
    (losses, first gradient by key, parameters after by key); ``start`` the
    parameters before, by key."""
    losses, grad, after = reference
    p_losses, p_grad, p_after = program
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
