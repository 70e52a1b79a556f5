"""Device milliseconds per training step of the backward, the gradient
norm and the optimizer: the operations whose innermost span is
`pb.step` (the step outside its forward and its upload) or
`pb.optimizer`."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    by = tr.device_s_by_span()
    if 'step' not in by and 'optimizer' not in by:
        return None
    return (by.get('step', 0.0) + by.get('optimizer', 0.0)) * 1e3 / tr.frames
