"""Device ms per training step of the operations launched inside the
kernel wrappers' spans (`jmodt.kernel.*`) that are not hand-written
kernels: the wrappers' own sorts, gathers, casts, copies and allocations
(perfbench/program_spans.py `glue_ms`), in the traced steps."""

from perfbench.program_spans import glue_ms


def read(ctx):
    return None if ctx.trace is None else glue_ms(ctx.trace)
