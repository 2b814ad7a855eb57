"""K5 and K6 (``sorted_segsum_kernel``, ``sorted_expand_kernel``: DIN's
attention pool and query select over the compact segment stream) against
their roofline: over the traced window's launches, the least time the
card needs, max(bytes / 3.35e12, adds / 67e12), over the time they took,
in percent. K5 reads the M value rows and M int32 segment ids and writes
n_out f32 rows (M * K adds); K6 reads n_src source rows and M ids and
writes M rows (no arithmetic)."""

UNIT = "%"
KERNELS = ("sorted_segsum_kernel", "sorted_expand_kernel")
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def _segsum(vals, cdest, n_out):
    m, k = vals.shape
    return m * k * vals.element_size() + m * 4 + n_out * k * 4, m * k


def _expand(src, cdest):
    n_src, k = src.shape
    m = cdest.shape[0]
    return n_src * k * src.element_size() + m * 4 + m * k * src.element_size(), 0


ENTRIES = {
    ("tf_repos_tpu_torch.ops.sorted_seg", "sorted_segsum"): _segsum,
    ("tf_repos_tpu_torch.ops.sorted_seg", "sorted_expand"): _expand,
}


def read(trace):
    launches = [c for calls in (trace.calls.get(e, []) for e in ENTRIES) for c in calls]
    seconds, hits = trace.kernel_seconds(KERNELS)
    if not launches or not hits or seconds <= 0:
        return None
    least = sum(max(b / HBM_BYTES_PER_S, f / F32_FLOPS) for b, f in launches)
    return 100.0 * (least / len(launches)) / (seconds / hits)
