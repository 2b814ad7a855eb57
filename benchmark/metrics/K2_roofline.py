"""K2 (``accumulate_rows_kernel``, the row-gradient segment sum of the
lazy step) against its roofline: over the traced window's launches, the
least time the card needs, max(bytes / 3.35e12, adds / 67e12), over the
time the launches took, in percent. Bytes count each input read once
and the output written once: the N slots' cotangent rows (N * K * the
element size), the N int32 ids and the S f32 output rows (chip_smoke.py's
K2 bound); adds are N * K in f32."""

UNIT = "%"
KERNELS = ("accumulate_rows_kernel",)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def _launch(g, idx, s):
    n, k = g.shape
    return n * k * g.element_size() + n * 4 + s * k * 4, n * k


ENTRIES = {("tf_repos_tpu_torch.ops.sparse_rows", "accumulate_rows"): _launch}


def least_seconds(launches):
    return sum(max(b / HBM_BYTES_PER_S, f / F32_FLOPS) for b, f in launches)


def read(trace):
    launches = [c for calls in (trace.calls.get(e, []) for e in ENTRIES) for c in calls]
    seconds, hits = trace.kernel_seconds(KERNELS)
    if not launches or not hits or seconds <= 0:
        return None
    # the mean launch's least time over the mean launch's time: a launch
    # the profiler missed does not count against the kernel
    return 100.0 * (least_seconds(launches) / len(launches)) / (seconds / hits)
