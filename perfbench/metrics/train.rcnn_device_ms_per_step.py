"""Device ms per training step of the operations launched inside
`jmodt.forward.rcnn`: RoI sampling (`proposal_target_layer`), the RCNN
and the ReID heads' forward (perfbench/program_spans.py)."""

from perfbench.program_spans import device_ms


def read(ctx):
    if ctx.trace is None:
        return None
    return device_ms(ctx.trace, lambda n: n == 'jmodt.forward.rcnn')
