"""Device milliseconds per stream-frame of the operations launched inside
the `pb.tracker` span (the sum of their durations), in the traced
frames."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ms = tr.device_s_by_span().get('tracker')
    return None if ms is None else ms * 1e3 / tr.frames
