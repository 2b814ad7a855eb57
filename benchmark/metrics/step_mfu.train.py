"""The whole step's share of the card's peak: the model FLOPs of the
traced window's steps (the reference's count from the configuration's
widths and the batches' live slots: the towers' and the attention's
GEMMs and the elementwise model math, forward once and backward twice,
gathers and scatters at 0) over the window's seconds, against the bf16
dense peak of one H100 SXM (989e12 FLOP/s; the towers compute in bf16),
in percent."""

UNIT = "%"
PEAK_FLOPS = 989e12


def read(trace):
    if trace.model_flops <= 0 or trace.window_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * trace.model_flops / trace.window_s / PEAK_FLOPS
