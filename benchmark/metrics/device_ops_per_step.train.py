"""Device operations (kernels, copies, fills) a training step issues:
their count in the traced window over its steps. A CUDA graph or a
fusion lowers it."""

UNIT = "ops/step"


def read(trace):
    if not trace.device_ops or trace.steps <= 0:
        return None
    return len(trace.device_ops) / trace.steps
