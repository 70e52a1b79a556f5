"""Device milliseconds per training step of the TRAIN forward
(PointRCNN(mode='TRAIN') with the proposal target layer) and the losses:
the operations whose innermost span is `pb.forward`."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ms = tr.device_s_by_span().get('forward')
    return None if ms is None else ms * 1e3 / tr.frames
