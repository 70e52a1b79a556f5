"""The training step's share of the card's bf16 dense peak (989 TFLOP/s):
the frozen FLOP count of a step (perfbench/drivers/train.py
`step_flops`) times the steps a second of the traced run's window, taken
with the profiler off, in %."""

from perfbench.roofline import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.steps_per_s <= 0:
        return None
    return 100.0 * ctx.flops_per_step * ctx.steps_per_s / PEAK_BF16_FLOPS
