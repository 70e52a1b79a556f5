"""The hand-written kernels' share of their roofline on the training step:
the least time of a step's work at its shapes (perfbench/roofline.py
`train_step_bounds`) over their measured device time, summed over the
kernels that the traced steps launched, in %."""

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
    least = sum(ctx.bounds.get(k, 0.0) for k in seen) * tr.frames
    return 100.0 * least / spent
