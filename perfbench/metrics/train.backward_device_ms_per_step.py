"""Device ms per training step of the operations launched inside
`jmodt.backward`, from any host thread (the autograd engine's among them):
the backward and the gradients' sum over ranks
(perfbench/program_spans.py)."""

from perfbench.program_spans import device_ms


def read(ctx):
    if ctx.trace is None:
        return None
    return device_ms(ctx.trace, lambda n: n == 'jmodt.backward')
