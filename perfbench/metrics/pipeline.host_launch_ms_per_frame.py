"""Host milliseconds per stream-frame spent inside the runtime's kernel
launch calls (cudaLaunchKernel, cudaLaunchKernelExC, ...), in the traced
frames."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.launches:
        return None
    return sum(e['dur'] for e in tr.launches) / 1e3 / tr.frames
