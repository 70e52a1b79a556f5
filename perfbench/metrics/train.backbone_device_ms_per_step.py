"""Device ms per training step of the operations launched inside
`jmodt.backbone` within `jmodt.train_step`: the frozen RPN backbone over
the step's frames (perfbench/program_spans.py)."""

from perfbench.program_spans import device_ms


def read(ctx):
    if ctx.trace is None:
        return None
    return device_ms(ctx.trace, lambda n: n == 'jmodt.backbone',
                     within='jmodt.train_step')
