"""Rows 11 and 12 (the fused node and edge updates, float32) against their
roofline in the profiled score requests: the least time of the updates each
request needs (``costs.score_fused_seconds``: the encoder's once over its
unpadded residues, the decoder's over the orders and the unconditional
pass) over the device time of the fused kernels, in %. Work the program
repeats, such as encoding each tiled copy of a structure, lowers the share."""
from port_bench import costs

WRAPS = []
KERNELS = ["fused_message_kernel", "node_tail_kernel"]


def read(run):
    prof, cfg = run.profile, run.cell.config
    if prof is None:
        return None
    B = cfg["inference"]["score"]["batch_size"]
    least = sum(costs.score_fused_seconds(r["residues"], B, cfg)
                for r in run.profiled if r["ok"])
    device = sum(prof.kernels.get(k, 0.0) for k in KERNELS)
    if not least or not device:
        return None
    return 100.0 * least / device
