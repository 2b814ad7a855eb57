"""The model's towers, ``model.towers`` (the deep MLP and its output
layer, from the concatenated embeddings to the tower's logit) and its
backward half ``model.towers.bwd``: device ms a step over the traced
window."""

from benchmark.metrics import _spans

UNIT = "ms/step"
SPANS = ("model.towers", "model.towers.bwd")


def read(trace):
    return _spans.ms_per_step(trace, SPANS)
