"""The training step's forward, ``step.forward`` (the model's loss, from
the gathered rows to the scalar): its device extent summed over the
traced window's steps, over the steps, in ms."""

from benchmark.metrics import _spans

UNIT = "ms/step"
SPANS = ("step.forward",)


def read(trace):
    return _spans.ms_per_step(trace, SPANS)
