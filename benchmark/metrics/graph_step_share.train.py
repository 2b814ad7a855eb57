"""The training steps of the traced window that ran as a CUDA graph of
the step (tf_repos_tpu_torch/train/step_graph.py), over the window's
steps, in percent: how often the graph engages. Read from the port's
step log (tf_repos_tpu_torch.utils.observability.STEP_LOG), one entry a
step while a profiler runs, "graph" or "eager: <reason>"; set-up runs
with no profiler, so the window's steps are its first ``trace.steps``
entries, and the host-traced second's follow them. The log is read once
a trace and then emptied. A port without the log, a window with fewer
entries than steps, or one in which nothing ran on a card reads nothing
(None)."""

UNIT = "%"


def read(trace):
    try:
        from tf_repos_tpu_torch.utils import observability as O
    except ImportError:
        return None
    log = getattr(O, "STEP_LOG", None)
    if log is None:
        return None
    entries = log.take()
    if trace.steps <= 0 or not trace.device_ops or len(entries) < trace.steps:
        return None
    return 100.0 * sum(e == "graph" for e in entries[:trace.steps]) / trace.steps
