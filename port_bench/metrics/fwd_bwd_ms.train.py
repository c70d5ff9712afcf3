"""Milliseconds of ``Trainer.loss_and_grads`` (forward, loss, backward and
the flat gradient), synchronised, averaged over the window's steps."""
WRAPS = ["train.trainer.Trainer.loss_and_grads"]


def read(run):
    if run.spans is None:
        return None
    spans = run.spans.within("loss_and_grads", run.t_start, run.t_end)
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in spans) / len(spans)
