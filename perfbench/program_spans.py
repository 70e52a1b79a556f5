"""The program's own spans in a traced stretch: the `jmodt.<layer>` ranges
that the port opens with `torch.profiler.record_function` at its layer
boundaries while a profiler records (PERF.md §3 lists the names; nothing
of the program is imported here, the names are strings).

A device operation belongs to a span when the host call that launched it
(the runtime call of its correlation id, as in perfbench/trace.py) falls
inside the span on the host clock, whatever thread made the call: the
autograd engine's launches during `jmodt.backward` count as backward.
Each idle instant of the device, a moment between its first operation's
start and its last one's end when none runs, goes to the innermost of
the spans asked about that was open on the host at that instant (the
idle put on the host's clock by the launches, `idle_gaps`).

Every number is per stream-frame (per step in a training cell), in ms,
and None when the trace holds none of the spans asked about or no device
operation: a program without spans, or a run on the CPU, reads None, not
0.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from perfbench.roofline import family

PREFIX = 'jmodt.'
KERNEL = 'jmodt.kernel.'
# the inference layers, each by its root spans; an instant goes to the
# innermost of all of them, so a layer's time excludes its children's
LAYERS = {'pipeline': ('jmodt.joint', 'jmodt.upload', 'jmodt.top_k',
                       'jmodt.pack'),
          'backbone': ('jmodt.backbone',),
          'heads': ('jmodt.detection',),
          'tracker': ('jmodt.tracker',)}

Span = Tuple[float, float, str]        # (start us, end us, name)
GAP_WINDOW = 16        # gaps on either side that set a gap's clock offset


def spans(tr) -> List[Span]:
    """The program's spans of trace `tr`, in start order."""
    return sorted((e['ts'], e['ts'] + e['dur'], e['name'])
                  for e in tr.host_ops if e.get('cat') == 'user_annotation'
                  and e['name'].startswith(PREFIX))


def launch_ts(tr) -> np.ndarray:
    """The host time of the runtime call that launched each of
    `tr.device`'s operations, matched by correlation id (NaN where the
    trace has none: a library's launch through the driver API)."""
    by_corr = {}
    for e in tr.runtime:
        corr = e.get('args', {}).get('correlation')
        if corr is not None:
            by_corr[corr] = e['ts']
    return np.array([by_corr.get(e.get('args', {}).get('correlation'),
                                 np.nan) for e in tr.device],
                    dtype=np.float64)


def early_starts(tr) -> int:
    """Device operations that start before the host call that launched
    them: 0 when the host's and the device's clocks agree."""
    ts = launch_ts(tr)
    starts = np.array([e['ts'] for e in tr.device], dtype=np.float64)
    return int(np.sum(starts < ts))


def _merged(ivals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(ivals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(ts: np.ndarray, ivals: List[List[float]]) -> np.ndarray:
    """Which of the times `ts` fall inside the merged intervals `ivals`."""
    if not ivals:
        return np.zeros(len(ts), dtype=bool)
    lo = np.array([a for a, _ in ivals])
    hi = np.array([b for _, b in ivals])
    k = np.searchsorted(lo, ts, side='right') - 1
    ok = k >= 0
    kk = np.clip(k, 0, None)
    return ok & (ts <= hi[kk])


def device_ms(tr, match: Callable[[str], bool],
              within: Optional[str] = None,
              ops: Optional[Callable[[dict], bool]] = None
              ) -> Optional[float]:
    """Device ms per frame of the operations (those `ops` accepts, all by
    default) launched inside a span whose name `match` accepts (and, with
    `within`, which lies inside a span of that name); None when there is
    no such span.  An operation inside two such spans counts once."""
    if not tr.device:
        return None
    sp = spans(tr)
    chosen = [(a, b) for a, b, n in sp if match(n)]
    if within is not None:
        outer = _merged((a, b) for a, b, n in sp if n == within)
        chosen = [(a, b) for a, b in chosen
                  if _inside(np.array([a, b]), outer).all()]
    if not chosen:
        return None
    ts = launch_ts(tr)
    hit = _inside(ts, _merged(chosen))
    us = sum(e['dur'] for e, h in zip(tr.device, hit)
             if h and (ops is None or ops(e)))
    return us / 1e3 / tr.frames


def glue_ms(tr) -> Optional[float]:
    """Device ms per frame launched inside the kernel wrappers' spans
    (`jmodt.kernel.*`) by operations that are not hand-written kernels
    (perfbench/roofline.py `family`): the wrappers' own sorts, gathers,
    casts, copies and allocations."""
    return device_ms(tr, lambda n: n.startswith(KERNEL),
                     ops=lambda e: family(e['name']) is None)


def idle_gaps(tr) -> List[List[float]]:
    """The device's idle intervals, between its first operation's start
    and its last one's end, placed on the host's clock.  The device's
    timestamps can drift against the host's within a traced session
    (PERF.md §6), so each gap keeps the length the device measured and is
    moved back by the clock's offset there: the least lag from launch
    call to start among the GAP_WINDOW gaps on either side (an idle device
    starts what it is given within microseconds; the operation that ends
    one gap may have been queued long before)."""
    launch = launch_ts(tr)
    raw, reach = [], None
    for i in sorted(range(len(tr.device)), key=lambda i: tr.device[i]['ts']):
        a = tr.device[i]['ts']
        if reach is not None and a > reach:
            raw.append((reach, a, a - launch[i]))
        b = a + tr.device[i]['dur']
        reach = b if reach is None else max(reach, b)
    lag = np.array([g[2] for g in raw], dtype=np.float64)
    lag[~np.isfinite(lag)] = np.inf
    pad = np.pad(lag, GAP_WINDOW, constant_values=np.inf)
    off = np.lib.stride_tricks.sliding_window_view(
        pad, 2 * GAP_WINDOW + 1).min(axis=1) if len(lag) else lag
    off[~np.isfinite(off)] = 0.0
    return [[a - o, b - o] for (a, b, _), o in zip(raw, off)]


def idle_by_span(tr, names: Iterable[str]) -> Optional[Dict[str, float]]:
    """{name: device idle ms per frame while that span was the innermost
    of the spans `names` open on the host}, and under None the idle while
    none of them was open; None when the trace holds none of them.  Each
    gap of `idle_gaps` is cut at every span boundary inside it, so a gap
    that straddles two spans is split between them."""
    names = set(names)
    sp = [s for s in spans(tr) if s[2] in names]
    if not sp or not tr.device:
        return None
    # the innermost open span between consecutive boundaries: the latest
    # start, then the shortest; at one instant ends go first
    marks = sorted([(a, 1, i) for i, (a, _, _) in enumerate(sp)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(sp)])
    cuts, owner, active = [], [], []
    for t, opens, i in marks:
        if opens:
            active.append(i)
        else:
            active.remove(i)
        cuts.append(t)
        owner.append(sp[max(active, key=lambda j: (sp[j][0], -sp[j][1]))][2]
                     if active else None)
    out: Dict[Optional[str], float] = {n: 0.0 for _, _, n in sp}
    out[None] = 0.0
    for lo, hi in idle_gaps(tr):
        k = bisect.bisect_right(cuts, lo) - 1
        t = lo
        while t < hi:
            end = cuts[k + 1] if k + 1 < len(cuts) else hi
            end = min(max(end, t), hi)
            out[owner[k] if k >= 0 else None] += end - t
            t, k = end, k + 1
    return {k: v / 1e3 / tr.frames for k, v in out.items()}


def layer_idle_ms(tr, layer: str) -> Optional[float]:
    """Device idle ms per frame while the host was in inference layer
    `layer` (a key of LAYERS) and in no other layer nested inside it."""
    by = idle_by_span(tr, [n for roots in LAYERS.values() for n in roots])
    if by is None or not any(n in by for n in LAYERS[layer]):
        return None
    return sum(by.get(n, 0.0) for n in LAYERS[layer])
