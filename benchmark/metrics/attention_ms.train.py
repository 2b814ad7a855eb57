"""DIN's attention over the history slots, ``model.attention`` (the
query select, the attention MLP, the weighting and the segment pool,
K6 and K5) and its backward half ``model.attention.bwd``: device ms a
step over the traced window."""

from benchmark.metrics import _spans

UNIT = "ms/step"
SPANS = ("model.attention", "model.attention.bwd")


def read(trace):
    return _spans.ms_per_step(trace, SPANS)
