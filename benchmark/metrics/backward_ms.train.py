"""The training step's backward, ``step.backward`` (torch.autograd.grad
of the loss): its device extent summed over the traced window's
steps, over the steps, in ms."""

from benchmark.metrics import _spans

UNIT = "ms/step"
SPANS = ("step.backward",)


def read(trace):
    return _spans.ms_per_step(trace, SPANS)
