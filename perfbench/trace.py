"""A traced stretch of a run: torch.profiler over a few frames, read from
the profiler's chrome trace into what the per-layer readers need.

Spans are `torch.profiler.record_function` ranges that the benchmark's
own hooks and wrappers open around the calls into each layer (named
`pb.<layer>`).  A device operation belongs to the innermost span open on
the host when the call that launched it ran (the runtime call and the
device operation share a correlation id).
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import os
import tempfile
from typing import Dict, List

import numpy as np

from perfbench.stats import union_length

LAUNCHES = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cudaLaunchKernelEx',
            'cuLaunchKernel', 'cuLaunchKernelEx',
            'cudaLaunchCooperativeKernel')
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
SPAN_PREFIX = 'pb.'


class Spans:
    """Opens `pb.<name>` ranges while `on`; off they cost a flag test."""

    def __init__(self):
        self.on = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch
        with torch.profiler.record_function(SPAN_PREFIX + name):
            yield

    def hook(self, module, name: str):
        """Forward pre / post hooks that hold `pb.<name>` open around
        `module`'s forward; returns the two handles."""
        open_ = []

        def pre(_mod, _args):
            if self.on:
                import torch
                rf = torch.profiler.record_function(SPAN_PREFIX + name)
                rf.__enter__()
                open_.append(rf)

        def post(_mod, _args, _out):
            if open_:
                open_.pop().__exit__(None, None, None)

        return (module.register_forward_pre_hook(pre),
                module.register_forward_hook(post))


class Trace:
    """The parsed events of one profiled stretch of `frames` stream-frames
    lasting `window_s` seconds on the host's clock."""

    def __init__(self, events: List[dict], frames: int, window_s: float):
        self.frames = frames
        self.window_s = window_s
        xs = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
        self.device = [e for e in xs if e.get('cat') in DEVICE_CATS]
        self.runtime = [e for e in xs if e.get('cat') == 'cuda_runtime']
        self.launches = [e for e in self.runtime if e['name'] in LAUNCHES]
        self.spans = [e for e in xs if e.get('cat') == 'user_annotation'
                      and e['name'].startswith(SPAN_PREFIX)]
        self.host_ops = [e for e in xs if e.get('cat') in (
            'cpu_op', 'cuda_runtime', 'user_annotation', 'python_function')]
        self._span_of = None

    def busy_s(self) -> float:
        return union_length((e['ts'], e['ts'] + e['dur'])
                            for e in self.device) / 1e6

    def kernels(self) -> List[dict]:
        return [e for e in self.device if e.get('cat') == 'kernel']

    def span_of_device(self) -> Dict[int, str]:
        """{index into `device`: the innermost span's layer name} for the
        device operations launched inside a span."""
        if self._span_of is not None:
            return self._span_of
        by_corr = {}
        for e in self.runtime:
            corr = e.get('args', {}).get('correlation')
            if corr is not None:
                by_corr[corr] = (e['ts'], e.get('tid'))
        ts = np.array([by_corr.get(e.get('args', {}).get('correlation'),
                                   (np.nan, None))[0] for e in self.device],
                      dtype=np.float64)
        label = np.full(len(self.device), -1, dtype=np.int64)
        names = []
        # outer spans first, so an inner one overwrites its parent
        for s in sorted(self.spans, key=lambda s: -s['dur']):
            names.append(s['name'][len(SPAN_PREFIX):])
            inside = (ts >= s['ts']) & (ts <= s['ts'] + s['dur'])
            label[inside] = len(names) - 1
        self._span_of = {i: names[k] for i, k in enumerate(label) if k >= 0}
        return self._span_of

    def device_s_by_span(self) -> Dict[str, float]:
        out = collections.Counter()
        for i, name in self.span_of_device().items():
            out[name] += self.device[i]['dur'] / 1e6
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, and the longest idle
        gaps of the device, each named by the innermost host operation
        running at its middle."""
        by_name = collections.Counter()
        for e in self.device:
            by_name[e['name'][:120]] += e['dur'] / 1e6
        ivals = sorted((e['ts'], e['ts'] + e['dur']) for e in self.device)
        gaps, reach = [], None
        for start, end in ivals:
            if reach is not None and start > reach:
                gaps.append((start - reach, reach, start))
            reach = end if reach is None else max(reach, end)
        gaps.sort(reverse=True)
        named = []
        for dur, a, b in gaps[:top]:
            mid = (a + b) / 2
            cover = [e for e in self.host_ops
                     if e['ts'] <= mid <= e['ts'] + e['dur']]
            name = (min(cover, key=lambda e: e['dur'])['name'][:120]
                    if cover else 'no host op')
            named.append([name, dur / 1e6])
        return {'device_ops': [[k, v] for k, v in by_name.most_common(top)],
                'idle_gaps': named}


def profile(run_frames, frames: int, sync) -> Trace:
    """Run `run_frames()` (which runs `frames` stream-frames) under
    torch.profiler with CPU and CUDA activities, and parse the trace from
    a temporary file; `sync()` waits for the device."""
    import time

    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        run_frames()
        sync()
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        opener = gzip.open if path.endswith('.gz') else open
        with opener(path, 'rt') as f:
            events = json.load(f).get('traceEvents', [])
    return Trace(events, frames, window)
