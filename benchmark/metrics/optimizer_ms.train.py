"""The training step's optimizer, ``step.gather`` (the touched rows of
the w|m|v store, read) and ``step.update`` (dense Adam and the row
write-back): their device extents summed over the traced window's
steps, over the steps, in ms."""

from benchmark.metrics import _spans

UNIT = "ms/step"
SPANS = ("step.gather", "step.update")


def read(trace):
    return _spans.ms_per_step(trace, SPANS)
