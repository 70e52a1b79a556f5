"""The whole step's share of the card's bf16 dense peak (989 TFLOP/s):
the frozen FLOP count of a stream-frame (perfbench/flops.py) times the
stream-frames a second of the traced run's window, taken with the
profiler off, in %."""

from perfbench.roofline import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.frames_per_s <= 0:
        return None
    return 100.0 * ctx.flops_per_frame * ctx.frames_per_s / PEAK_BF16_FLOPS
