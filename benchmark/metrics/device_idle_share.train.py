"""Share of the traced window in which no operation (kernel, copy, fill)
ran on the device: 1 - (union of their intervals) / window, in percent.
The union, not the sum: operations on concurrent streams overlap."""

UNIT = "%"


def read(trace):
    if not trace.device_ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
