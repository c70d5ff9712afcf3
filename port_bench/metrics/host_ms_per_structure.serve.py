"""Milliseconds a CLI request spends outside the model calls: the request's
wall time less its ``sample``, ``score`` and ``unconditional_probs`` spans
(argument parsing, checkpoint load, parse, featurisation, output files),
averaged over the window's requests."""
WRAPS = ["models.mpnn.sample", "models.mpnn.score", "models.mpnn.unconditional_probs"]
NAMES = [w.split(".")[-1] for w in WRAPS]


def read(run):
    reqs = [r for r in run.requests if r["ok"]]
    if not reqs or run.spans is None:
        return None
    host = 0.0
    for r in reqs:
        inside = sum(t1 - t0 for n in NAMES for t0, t1, _ in run.spans.within(n, r["t0"], r["t1"]))
        host += (r["t1"] - r["t0"]) - inside
    return 1e3 * host / len(reqs)
