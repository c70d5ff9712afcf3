"""The window's LigandMPNN model operations (``costs_ligand.train_flops``
of every completed step over its unpadded residues: the trunk, the context
features and the context layers) per second of the window, as a share of
the card's peak for the configuration's trunk (bf16 989 TFLOP/s with
``MIXED_PRECISION``, else the TF32 rate)."""
from port_bench import costs, costs_ligand

WRAPS = []


def read(run):
    cfg = run.cell.config
    ops = sum(costs_ligand.train_flops(r["tokens"], cfg) for r in run.requests if r["ok"])
    if not ops:
        return None
    peak = costs.PEAK_FLOPS["bf16" if cfg["MIXED_PRECISION"] else "fp32"]
    return 100.0 * ops / run.window_s / peak
