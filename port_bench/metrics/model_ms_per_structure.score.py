"""Milliseconds of model calls per scored structure: the ``score`` and
``unconditional_probs`` spans of the window over its requests."""
WRAPS = ["models.mpnn.score", "models.mpnn.unconditional_probs"]


def read(run):
    reqs = [r for r in run.requests if r["ok"]]
    if not reqs or run.spans is None:
        return None
    spans = [s for n in ("score", "unconditional_probs")
             for s in run.spans.within(n, run.t_start, run.t_end)]
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in spans) / len(reqs)
