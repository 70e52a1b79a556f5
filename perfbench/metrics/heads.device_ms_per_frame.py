"""Device milliseconds per stream-frame of the detection step outside its
backbone: the RPN heads, the proposal layer, RoI pooling, the RCNN, the
decode and the final NMS (and the upload's uint8 normalisation), i.e. the
operations whose innermost span is `pb.detection`."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ms = tr.device_s_by_span().get('detection')
    return None if ms is None else ms * 1e3 / tr.frames
