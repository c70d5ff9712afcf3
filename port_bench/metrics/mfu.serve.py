"""The window's model operations (``costs.serve_flops`` of every completed
request, counted from shapes) per second of the window, as a share of the
card's float32 peak (TF32 tensor cores, 495 TFLOP/s)."""
from port_bench import costs

WRAPS = []


def read(run):
    cfg, argv = run.cell.config, run.cell.mix["argv"]
    mode = argv[argv.index("--mode") + 1]
    ops = sum(costs.serve_flops(mode, r["chains"], cfg) for r in run.requests if r["ok"])
    if not ops:
        return None
    return 100.0 * ops / run.window_s / costs.PEAK_FLOPS["fp32"]
