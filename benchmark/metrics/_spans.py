"""The port's span records of the traced window (tf_repos_tpu_torch.utils.
observability.RECORDER), for the readers of the step's and the model's
device ms a step. Set-up runs with no profiler, so the window's records
are the first ``trace.steps`` step trees of the recorder (the step
records, the spans inside them and the backward halves of their model
spans); the host-traced second's records follow them. The recorder is
read once a trace and then emptied, so a later run in the same process
starts from none. A port without the recorder, or a window without
enough step records or without one of the named spans, reads nothing
(None)."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

_last = [None, None]  # the trace read last, and its spans' device ms a step


def _window_ms(trace) -> Optional[Dict[str, float]]:
    """{span name: device ms a step over the window's steps}, or None."""
    try:
        from tf_repos_tpu_torch.utils import observability as O
    except ImportError:
        return None
    if not hasattr(O, "RECORDER"):
        return None
    records = O.RECORDER.records()
    O.RECORDER.clear()
    if trace.steps <= 0 or sum(r["name"] == "step" for r in records) < trace.steps:
        return None
    return O.span_ms_per_step(records, trace.steps)


def ms_per_step(trace, names: Iterable[str]) -> Optional[float]:
    """Device ms a step of the spans ``names`` over the window's steps;
    None unless every one of them was recorded."""
    if _last[0] is not trace:
        _last[:] = [trace, _window_ms(trace)]
    ms = _last[1]
    if ms is None or not all(n in ms for n in names):
        return None
    return sum(ms[n] for n in names)
