"""Row 10 (the message-table backward) against its roofline: the least
time of the work that the profiled steps' unpadded tokens need
(``costs.train_table_seconds``) over the device time of its kernels, in %.
Padded rows the program runs lower the share."""
from port_bench import costs

WRAPS = []
KERNELS = ["tile_kernel", "wgrad_kernel", "reduce_weights", "reduce_biases", "table_kernel"]


def read(run):
    prof = run.profile
    if prof is None:
        return None
    least = sum(costs.train_table_seconds(r["tokens"], run.cell.config, backward=True)
                for r in run.profiled if r["ok"])
    device = sum(prof.kernels.get(k, 0.0) for k in KERNELS)
    if not least or not device:
        return None
    return 100.0 * least / device
