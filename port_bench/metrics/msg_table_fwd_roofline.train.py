"""Row 9 (the message-table forward, which saves its first activation for
the backward) against its roofline: the least time of the work that the
profiled steps' unpadded tokens need (``costs.train_table_seconds``) over
the device time of its kernel, in %. Padded rows the program runs lower the
share."""
from port_bench import costs

WRAPS = []
KERNELS = ["message_table_kernel"]


def read(run):
    prof = run.profile
    if prof is None:
        return None
    least = sum(costs.train_table_seconds(r["tokens"], run.cell.config, backward=False)
                for r in run.profiled if r["ok"])
    device = sum(prof.kernels.get(k, 0.0) for k in KERNELS)
    if not least or not device:
        return None
    return 100.0 * least / device
