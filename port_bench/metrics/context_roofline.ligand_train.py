"""LigandMPNN's context layers' forward against its roofline: the least
time of their forward for the window's unpadded residues
(``costs_ligand.context_layers_seconds``) over the time the card takes for
it, in %. That time is the harness's synchronised spans around the forward
(``models.ligand.context_encoder``), on the host's clock: the card is
drained before each span and waited for after, so a span holds the
forward's device work and its dispatch. The backward is not read: it runs
inside the trainer's one backward call, and the profile keeps no device
time per span. Rows run for padded residues and padded atom slots lower
the share."""
from port_bench import costs_ligand

WRAPS = ["models.ligand.context_encoder"]


def read(run):
    if run.spans is None:
        return None
    device = sum(t1 - t0 for t0, t1, _ in
                 run.spans.within("context_encoder", run.t_start, run.t_end))
    least = sum(costs_ligand.context_layers_seconds(r["tokens"], run.cell.config)
                for r in run.requests if r["ok"])
    if not device or not least:
        return None
    return 100.0 * least / device
