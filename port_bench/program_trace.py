"""The program's own spans (``na_mpnn_tpu_torch/trace.py``) for the readers
of per-layer metrics. Importing this module turns the program's tracer on;
the runner loads per-layer readers, and with them this module, only in
traced runs (``--trace 1``), so untraced runs leave the tracer off. A
program without the tracer records nothing, and its readers read None.

A reader takes the requests whose outermost span (``cli.call`` for a CLI
call, ``train.step`` for a training step) lies inside the run's window, and
the spans of those requests (their ``request`` id), wherever they ran.

The spans are host times: none synchronises, so where the card sets the
pace a stage holds the wait for it (the first copy to the host, say)."""
try:
    from na_mpnn_tpu_torch import trace as _trace
except ImportError:
    _trace = None
else:
    _trace.enable()


def within(run, root, *names):
    """(the records named ``names`` of the window's requests, the number of
    those requests). A request is the window's if its span ``root`` lies
    inside the window; a name that ends in ``.`` stands for every name it
    starts."""
    if _trace is None:
        return [], 0
    records = _trace.records()
    ids = {r.request for r in records
           if r.name == root and run.t_start <= r.t0 and r.t1 <= run.t_end}
    exact = {n for n in names if not n.endswith(".")}
    prefixes = tuple(n for n in names if n.endswith("."))
    return [r for r in records if r.request in ids
            and (r.name in exact or (prefixes and r.name.startswith(prefixes)))], len(ids)


def ms_per(run, names, root):
    """Milliseconds in the spans ``names`` per request of the window (see
    ``within``), or None where either is missing."""
    spans, count = within(run, root, *names)
    if not spans or not count:
        return None
    return 1e3 * sum(r.t1 - r.t0 for r in spans) / count
