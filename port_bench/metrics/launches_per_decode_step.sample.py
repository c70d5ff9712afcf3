"""Kernel launches (CUDA runtime launch calls) inside ``sample`` calls per
decode step, in the profiled slice."""
WRAPS = ["models.mpnn.sample"]


def read(run):
    prof = run.profile
    if prof is None or run.spans is None:
        return None
    steps = sum(s[-1] for _, _, s in run.spans.within("sample", prof.t0, prof.t1))
    launches = prof.launches_in.get("sample", 0)
    if not steps or not launches:
        return None
    return launches / steps
