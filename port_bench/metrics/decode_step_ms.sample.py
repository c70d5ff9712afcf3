"""Milliseconds of one decode step of the sampler: the time in ``sample``
spans over the window over the decode steps they ran (one per position of
the structure; every row of the batch steps together)."""
WRAPS = ["models.mpnn.sample"]


def read(run):
    if run.spans is None:
        return None
    spans = run.spans.within("sample", run.t_start, run.t_end)
    steps = sum(shape[-1] for _, _, shape in spans)
    if not steps:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in spans) / steps
