"""The share of the traced frames' device operations whose launch record
is a CUDA graph's launch (`cudaGraphLaunch`), in %: how much of a frame
the host hands the card as replayed graphs rather than launch by launch.
None where the trace holds no graph launch (a program that replays
none)."""

GRAPH_LAUNCHES = ('cudaGraphLaunch', 'cuGraphLaunch')


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    graph_corr = {e['args']['correlation'] for e in tr.runtime
                  if e['name'].startswith(GRAPH_LAUNCHES)
                  and 'correlation' in e.get('args', {})}
    if not graph_corr:
        return None
    graphed = sum(1 for e in tr.device
                  if e.get('args', {}).get('correlation') in graph_corr)
    return 100.0 * graphed / len(tr.device)
