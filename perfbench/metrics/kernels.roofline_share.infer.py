"""The hand-written kernels' share of their roofline on the inference
step: the least time their frames' work needs (perfbench/roofline.py,
from the configuration's shapes) over their measured device time, summed
over the kernels that the traced frames launched, in %."""

from perfbench.roofline import family


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    spent, seen = 0.0, set()
    for e in tr.kernels():
        key = family(e['name'])
        if key is not None:
            spent += e['dur'] / 1e6
            seen.add(key)
    if not seen or spent <= 0:
        return None
    frames = tr.frames / ctx.streams
    least = sum(ctx.bounds.get(k, 0.0) for k in seen) * frames
    return 100.0 * least / spent
