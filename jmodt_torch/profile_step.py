"""Where a frame's time goes on the CUDA card.

    python3 -m jmodt_torch.profile_step [--path joint|batched|detection]
                                        [--streams S] [--frames N]
                                        [--dtype bfloat16]
                                        [--set KEY VALUE ...]

`--path joint` (the default) runs the joint detect + track step at the
default Config() with RPN.MEGA_SA (16384 points, 384x1280 uint8 image,
detector weights from seed 0, a link head from seed 1, 64 track slots, the
top 16 detections, score threshold 0.2, Hungarian assignment);
`--path batched` runs the same step on `--streams` (default 4) streams in
lockstep (`make_batched_joint_step`), a frame being one lockstep frame of
all streams; `--path detection` runs the detection step alone at the
default Config().  `--set` overrides config keys
(`config.config_from_overrides`, e.g. `--set LI_FUSION.FUSED_PYRAMID
True`) and takes the rest of the line.  Synthetic frames; one warm-up
frame first, then the frames as the step runs them by default (on the card
the sections of `utils/graphs.py` captured in the first and replayed as
CUDA graphs after), and again under `graphs.eager()` where the port's
Python has to run.  Prints:

* host syncs per frame: every synchronizing CUDA call of the frame (torch's
  sync debug mode), in all and by call site (the file:line whose call
  synchronized), and, joint and batched, the tracker's own device-to-host
  reads (`device_tracker.host_syncs`);
* frame: unsynchronized wall ms per frame over N frames (batched: also per
  stream-frame), the device time per frame from torch.profiler as the
  union of the kernels' intervals (kernels that overlap, as K5's two
  grids do, count once) beside the sum of their durations, and the
  device's idle share by the union (and by the sum), replayed and eager;
* spans: each of the port's `jmodt.` spans (`utils/trace.py`) in the
  eager profiled frames (a replay opens only the spans around its
  section), with its calls a frame, the device ms a frame of the
  operations launched inside it (all of them, and those whose innermost
  span it is) and the device's idle ms a frame while it was the innermost
  span open on the host; the innermost columns add up, with '(none)', to
  the frames' summed device time and their idle between device
  operations;
* the kernels with the most device time per frame, and the host ops with
  the most CPU time, of the eager frames.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import json
import math
import os
import tempfile
import time
import warnings

import numpy as np
import torch


def union_length(spans) -> float:
    """Total length covered by the (start, end) intervals `spans`: time
    in which at least one of them runs."""
    total, reach = 0.0, float('-inf')
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _detection(cfg):
    """run(frame) of the detection step."""
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.models.point_rcnn import build_detector

    step = make_detection_step(cfg, build_detector(cfg, seed=0))
    return lambda f: step(f['pts_input'], f['img'], f['pts_xy'])


def _joint(cfg, streams=None):
    """run(frame) of the joint step, or with `streams` the lockstep step
    over that many streams, which numbers the frames 1, 2, ... as they
    come."""
    from jmodt_torch import pipeline
    from jmodt_torch.models.point_rcnn import build_detector, init_weights
    from jmodt_torch.models.rcnn import CorrelationHead
    from jmodt_torch.tracking.device_tracker import (init_batched_state,
                                                     init_state)

    feat_dim = cfg.RCNN.SA_CONFIG.MLPS[-1][-1]
    model = build_detector(cfg, seed=0)
    head = CorrelationHead(feat_dim, cfg.REID.LINK_FC, use_bn=cfg.REID.USE_BN)
    init_weights(head, 1)
    kw = dict(track_k=16, det_score_thresh=0.2, assign='hungarian')
    if streams is None:
        joint = pipeline.make_joint_step(cfg, model, head, **kw)
        state = [init_state(64, feat_dim), 0]   # tracker state, frame id
    else:
        joint = pipeline.make_batched_joint_step(cfg, model, head, **kw)
        state = [init_batched_state(streams, 64, feat_dim), 0]

    def run(f):
        state[1] += 1
        fid = (state[1] if streams is None
               else np.full(streams, state[1], np.int32))
        state[0], packed = joint(state[0], fid, f['pts_input'], f['img'],
                                 f['pts_xy'])
        return packed

    return run


def sync_sites(run, n_frames: int):
    """Run `run()` under torch's sync debug mode ('warn') and return the
    synchronizing CUDA calls it made per frame, by call site: {"file:line":
    calls a frame}, the file relative to the package's parent."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    sites = collections.Counter(
        f'{os.path.relpath(w.filename, root)}:{w.lineno}' for w in seen
        if 'called a synchronizing' in str(w.message))
    return {k: v / n_frames for k, v in sites.most_common()}


def _host_syncs(run, frames):
    """(tracker device-to-host reads, synchronizing CUDA calls, those calls
    by call site) per frame, over `frames` run one after the other."""
    from jmodt_torch.tracking import device_tracker
    before = device_tracker.host_syncs

    def all_frames():
        for f in frames:
            run(f)

    sites = sync_sites(all_frames, len(frames))
    torch.cuda.synchronize()
    return ((device_tracker.host_syncs - before) / len(frames),
            sum(sites.values()), sites)


def device_time(run, frames) -> dict:
    """`run` over `frames`, unsynchronized but for a synchronize at the
    end, under torch.profiler: wall ms a frame, device ms a frame as the
    union of the kernels' intervals and as the sum of their durations, the
    idle share by each, the kernels' key averages and the profile."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            run(f)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(frames)
    cuda = torch.autograd.DeviceType.CUDA

    def on_device(e):     # the spans' device-side ranges are no device work
        return e.device_type == cuda and not e.is_user_annotation

    kern = [e for e in prof.key_averages() if on_device(e)]
    summed = sum(e.self_device_time_total for e in kern) / 1e3 / len(frames)
    dev = union_length((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if on_device(e)) / 1e3 / len(frames)
    return dict(wall_ms=wall, device_ms=dev, summed_ms=summed,
                idle=max(0.0, 1 - dev / wall),
                idle_by_sum=max(0.0, 1 - summed / wall), kernels=kern,
                profile=prof)


def _innermost(spans, times):
    """The index into `spans` ((start, end, name), in start order) of the
    innermost span open at each of the ascending `times`, -1 for none."""
    marks = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    out, active, m = [], [], 0
    for t in times:
        while m < len(marks) and marks[m][0] <= t:
            _, opens, i = marks[m]
            if opens:
                active.append(i)
            else:
                active.remove(i)
            m += 1
        out.append(max(active, key=lambda j: (spans[j][0], -spans[j][1]))
                   if active else -1)
    return out


def span_table(profile, n_frames: int) -> dict:
    """{span name: (calls, device ms inside, device ms as innermost, idle
    ms as innermost)}, each a frame, of the port's `jmodt.` spans in a
    profile taken by `device_time`, '(none)' for what no span holds.  A
    device operation belongs to the spans open on the host when its
    launch call ran (matched by correlation id, whatever the thread); an
    idle instant between two device operations to the innermost span
    open then, so a gap may split between spans."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        profile.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)['traceEvents']
                      if e.get('ph') == 'X' and 'dur' in e]
    spans = sorted((e['ts'], e['ts'] + e['dur'], e['name']) for e in events
                   if e.get('cat') == 'user_annotation'
                   and e['name'].startswith('jmodt.'))
    launch = {e['args']['correlation']: e['ts'] for e in events
              if e.get('cat') == 'cuda_runtime'
              and 'correlation' in e.get('args', {})}
    ops = sorted((launch[e['args']['correlation']], e['dur']) for e in events
                 if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')
                 and e.get('args', {}).get('correlation') in launch)
    names = sorted({n for _, _, n in spans}) + ['(none)']
    rows = {n: [0.0, 0.0, 0.0, 0.0] for n in names}
    for _, _, n in spans:
        rows[n][0] += 1
    for name in names[:-1]:
        # a name's spans do not overlap: the last one to start before t
        starts = [a for a, _, n in spans if n == name]
        ends = [b for _, b, n in spans if n == name]
        rows[name][1] = sum(d for t, d in ops if (
            (k := bisect.bisect_right(starts, t) - 1) >= 0 and t <= ends[k]))
    for (_, d), k in zip(ops, _innermost(spans, [t for t, _ in ops])):
        rows['(none)' if k < 0 else spans[k][2]][2] += d
    # idle: the gaps between device operations.  The device's clock can
    # drift from the host's in a session, so a gap is placed on the host's
    # clock by the least launch-to-start lag of the 16 gaps on either side
    # (an idle device starts a launch within microseconds)
    busy = sorted((e['ts'], e['ts'] + e['dur'],
                   launch.get(e.get('args', {}).get('correlation')))
                  for e in events
                  if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'))
    gaps, reach = [], None
    for a, b, t in busy:
        if reach is not None and a > reach:
            gaps.append((reach, a, math.inf if t is None else a - t))
        reach = b if reach is None else max(reach, b)
    marks = sorted({t for s in spans for t in s[:2]})
    cuts = []
    for i, (a, b, _) in enumerate(gaps):
        off = min(g[2] for g in gaps[max(0, i - 16):i + 17])
        a, b = (a - off, b - off) if off < math.inf else (a, b)
        inner = marks[bisect.bisect_right(marks, a):
                      bisect.bisect_left(marks, b)]
        cuts += list(zip([a] + inner, inner + [b]))
    for (a, b), k in zip(cuts, _innermost(spans, [a for a, _ in cuts])):
        rows['(none)' if k < 0 else spans[k][2]][3] += b - a
    return {n: (r[0] / n_frames, *(x / 1e3 / n_frames for x in r[1:]))
            for n, r in rows.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--path', default='joint',
                    choices=('joint', 'batched', 'detection'))
    ap.add_argument('--streams', type=int, default=4,
                    help='streams of --path batched')
    ap.add_argument('--frames', type=int, default=3)
    ap.add_argument('--dtype', default='bfloat16',
                    choices=('bfloat16', 'float32'))
    ap.add_argument('--set', dest='set_cfgs', default=None,
                    nargs=argparse.REMAINDER,
                    help='config overrides KEY VALUE ... (the rest of the '
                         'line)')
    args = ap.parse_args()

    from jmodt_torch.config import Config, config_from_overrides
    from jmodt_torch.data.synthetic import make_eval_frame
    from jmodt_torch.utils import graphs

    cfg = dataclasses.replace(Config(), DTYPE=args.dtype)
    if args.set_cfgs:
        cfg = config_from_overrides(cfg, args.set_cfgs)
    if args.path != 'detection':
        cfg = dataclasses.replace(
            cfg, RPN=dataclasses.replace(cfg.RPN, MEGA_SA=True))
    streams = args.streams if args.path == 'batched' else None
    per = streams or 1
    frames = []
    for t in range(args.frames + 1):
        fs = [make_eval_frame(t * per + s, cfg, raw_u8=True)
              for s in range(per)]
        frames.append({k: np.concatenate([f[k] for f in fs])
                       for k in ('pts_input', 'img', 'pts_xy')})
    run = _detection(cfg) if args.path == 'detection' else _joint(cfg,
                                                                 streams)
    run(frames[0])                                       # warm-up
    torch.cuda.synchronize()
    what = args.path + (f', {streams} streams' if streams else '')

    trk, allsync, sites = _host_syncs(run, frames[1:])
    print(f'host syncs per frame: tracker {trk:.1f} (device-to-host '
          f'reads), whole frame {allsync:.1f} (synchronizing CUDA calls, '
          f'sync debug mode; {args.frames} frames); by call site: '
          + (', '.join(f'{k} {v:g}' for k, v in sites.items()) or 'none'))

    for how in ('replayed', 'eager'):
        with graphs.eager() if how == 'eager' else contextlib.nullcontext():
            prof = device_time(run, frames[1:])
        wall, dev, summed, kern = (prof[k] for k in (
            'wall_ms', 'device_ms', 'summed_ms', 'kernels'))
        print(f'frame ({how}): {wall:.3f} ms wall, {dev:.3f} ms of device '
              f'time (union of kernel intervals; sum of kernel durations '
              f'{summed:.3f}), idle share {prof["idle"]:.3f} (by the sum '
              f'{prof["idle_by_sum"]:.3f}) ({args.frames} frames, profiled)')
        if streams:
            print(f'stream-frame ({how}): {wall / streams:.3f} ms wall, '
                  f'{dev / streams:.3f} ms of device time ({streams} '
                  'streams)')
    print(f'spans of a profiled {what} frame ({args.dtype}, eager): calls, '
          'device ms of the ops launched inside / as the innermost span, '
          'idle ms as the innermost span:')
    for name, (calls, inside, own, idle) in sorted(
            span_table(prof['profile'], args.frames).items(),
            key=lambda kv: -kv[1][1]):
        print(f'  {name:36s} {calls:5.1f} {inside:9.3f} {own:9.3f} '
              f'{idle:9.3f}')
    print('kernels by device time per frame, ms:')
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:20]:
        print(f'  {e.self_device_time_total / 1e3 / args.frames:9.3f}  '
              f'x{e.count // args.frames:<5d} {e.key[:90]}')
    host = [e for e in prof['profile'].key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    print('host ops by self CPU time per frame, ms:')
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:20]:
        print(f'  {e.self_cpu_time_total / 1e3 / args.frames:9.3f}  '
              f'x{e.count // args.frames:<5d} {e.key[:90]}')


if __name__ == '__main__':
    with torch.no_grad():
        main()
