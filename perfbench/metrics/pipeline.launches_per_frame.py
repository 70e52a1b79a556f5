"""Kernel launches per stream-frame: the runtime's launch calls (every
kernel of the step, the port's own and PyTorch's) in the traced frames."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.launches:
        return None
    return len(tr.launches) / tr.frames
