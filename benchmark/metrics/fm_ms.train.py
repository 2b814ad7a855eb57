"""DeepFM's second-order FM term, ``model.fm``, and its backward half
``model.fm.bwd``: device ms a step over the traced window (a fused FM
kernel would move it)."""

from benchmark.metrics import _spans

UNIT = "ms/step"
SPANS = ("model.fm", "model.fm.bwd")


def read(trace):
    return _spans.ms_per_step(trace, SPANS)
