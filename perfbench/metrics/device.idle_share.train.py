"""The device's idle share over the traced steps: 1 - the union of its
operations' intervals over the traced window's wall time, in %.  Taken
under the profiler, which adds host time of its own."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
