"""Stream-frames per second of the run's window, the profiler off: the
rate of a closed loop with one frame in flight, which the host's pace sets
(a frame's kernels are launched one by one).  End to end only in the
lockstep cell: at S = 1 it swings with the shared host between runs of
one seed by more than any bound could hold."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or ctx.frames_per_s <= 0:
        return None
    return ctx.frames_per_s
