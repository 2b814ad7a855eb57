"""The model's embedding layer, ``model.embed`` (the lookups of every
field and their value scaling; DIN's two: the padded fields and the
history slots) and its backward half ``model.embed.bwd`` (through the
row gradients' accumulation, K2): device ms a step over the traced
window."""

from benchmark.metrics import _spans

UNIT = "ms/step"
SPANS = ("model.embed", "model.embed.bwd")


def read(trace):
    return _spans.ms_per_step(trace, SPANS)
