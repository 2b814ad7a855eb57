"""DIN's fused attention unit (``att_unit_fwd_kernel``; ``att_unit_bwd_kernel``
with its ``att_unit_reduce_kernel``: tf_repos_tpu_torch/ops/att_unit.py)
against the least time of the model's work: per call, max(bytes /
3.35e12, FLOPs / 989e12), over the traced time of the kernels, in
percent. The work is the model's whatever computes it, from the call's
shapes (N slots, K input width, W hidden width): forward, u and a read
and the weight written, 2 N 3K W + 2 N W FLOPs (the first layer's GEMM
and the output dot); backward, u, a, the weight's gradient and the
weight read, du and da written, twice the forward's FLOPs (the
backward's recompute of the first layer is not counted). At K = 32 that
is 260 and 520 bytes a slot.

A checkout whose port has no fused unit names no entry here, and the
metric reads nothing."""

import importlib.util

UNIT = "%"
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
MODULE = "tf_repos_tpu_torch.ops.att_unit"


def _forward(u, a, w1, b1, w2, b2):
    n, k = u.shape
    return 2 * n * k * 4 + n * 4, 2 * n * 3 * k * w1.shape[1] + 2 * n * w1.shape[1]


def _backward(gw, u, a, s, w1, b1, w2):
    n, k = u.shape
    return 4 * n * k * 4 + 2 * n * 4, 2 * (2 * n * 3 * k * w1.shape[1] + 2 * n * w1.shape[1])


def _present(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:
        return False


ENTRIES = ({(MODULE, "att_unit_forward"): _forward, (MODULE, "att_unit_backward"): _backward}
           if _present(MODULE) else {})


def _least(calls) -> float:
    """The mean call's least seconds."""
    return sum(max(b / HBM_BYTES_PER_S, f / BF16_FLOPS) for b, f in calls) / len(calls)


def read(trace):
    fwd = trace.calls.get((MODULE, "att_unit_forward"), [])
    bwd = trace.calls.get((MODULE, "att_unit_backward"), [])
    tf, hf = trace.kernel_seconds(("att_unit_fwd_kernel",))
    tb, hb = trace.kernel_seconds(("att_unit_bwd_kernel",))
    tr, hr = trace.kernel_seconds(("att_unit_reduce_kernel",))
    if not fwd or not bwd or not hf or not hb or tf <= 0 or tb <= 0:
        return None
    # the mean launch of each kind: a launch the profiler missed does not
    # count against the kernels
    took = tf / hf + tb / hb + (tr / hr if hr else 0.0)
    return 100.0 * (_least(fwd) + _least(bwd)) / took
