"""Device idle ms per stream-frame while the host was in `jmodt.detection`
outside `jmodt.backbone`: the RPN heads, the proposal layer, RoI pooling,
the RCNN, the decode and the final NMS (perfbench/program_spans.py), in
the traced frames."""

from perfbench.program_spans import layer_idle_ms


def read(ctx):
    return None if ctx.trace is None else layer_idle_ms(ctx.trace, 'heads')
