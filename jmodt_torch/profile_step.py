"""Where a frame's time goes on the CUDA card.

    python3 -m jmodt_torch.profile_step [--path joint|batched|detection]
                                        [--streams S] [--frames N]
                                        [--dtype bfloat16]

`--path joint` (the default) runs the joint detect + track step at the
default Config() with RPN.MEGA_SA (16384 points, 384x1280 uint8 image,
detector weights from seed 0, a link head from seed 1, 64 track slots, the
top 16 detections, score threshold 0.2, Hungarian assignment);
`--path batched` runs the same step on `--streams` (default 4) streams in
lockstep (`make_batched_joint_step`), a frame being one lockstep frame of
all streams; `--path detection` runs the detection step alone at the
default Config().  Synthetic frames; one warm-up frame first.  Prints:

* stages: wall ms of each stage of one frame, with the device synchronized
  at every stage boundary (the syncs remove overlap, so the stages add up
  to a little more than an unsynchronized frame).  Joint and batched:
  detection, top-K and packing, tracker; detection: the backbone's and
  heads' modules, proposals, RoI pooling and the final NMS;
* joint and batched: host syncs per frame, the tracker's own device-to-host
  reads (`device_tracker.host_syncs`) and every synchronizing CUDA call of
  the frame (torch's sync debug mode);
* frame: unsynchronized wall ms per frame over N frames (batched: also per
  stream-frame), the device time per frame from torch.profiler as the
  union of the kernels' intervals (kernels that overlap, as K5's two
  grids do, count once) beside the sum of their durations, and the
  device's idle share by the union (and by the sum);
* the kernels with the most device time per frame, and the host ops with
  the most CPU time;
* deconvs: wall ms per frame with each NonOverlapDeconv computed as the
  port does (matmul + K6) and as one F.conv_transpose2d call, the two
  taking frames in turn.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F


def union_length(spans) -> float:
    """Total length covered by the (start, end) intervals `spans`: time
    in which at least one of them runs."""
    total, reach = 0.0, float('-inf')
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _stage_hooks(model, times):
    """Forward hooks that time each top-level stage with device syncs."""
    names = {}
    for name, mod in model.named_modules():
        parts = name.split('.')
        if (len(parts) == 3 and parts[:2] == ['rpn', 'backbone']) or \
                name in ('rpn.cls_head', 'rpn.reg_head') or \
                (len(parts) == 2 and parts[0] == 'rcnn'):
            names[mod] = name
    start = {}

    def pre(mod, _args):
        torch.cuda.synchronize()
        start[mod] = time.perf_counter()

    def post(mod, _args, _out):
        torch.cuda.synchronize()
        times[names[mod]] += (time.perf_counter() - start[mod]) * 1e3

    return [h for mod in names for h in (mod.register_forward_pre_hook(pre),
                                         mod.register_forward_hook(post))]


def _timed(fn, times, name):
    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times[name] += (time.perf_counter() - t0) * 1e3
        return out
    return wrapped


def _detection(cfg, times):
    """(run(frame), stage setup -> undo) for the detection step."""
    from jmodt_torch.models import inference, point_rcnn
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.models.point_rcnn import build_detector

    model = build_detector(cfg, seed=0)
    step = make_detection_step(cfg, model)

    def run(f):
        return step(f['pts_input'], f['img'], f['pts_xy'])

    def stages():
        hooks = _stage_hooks(model, times)
        saved = (point_rcnn.proposal_layer, point_rcnn.pool_rois_for_eval,
                 inference.nms_bev)
        point_rcnn.proposal_layer = _timed(saved[0], times, 'proposal_layer')
        point_rcnn.pool_rois_for_eval = _timed(saved[1], times,
                                               'pool_rois_for_eval')
        inference.nms_bev = _timed(saved[2], times, 'final nms_bev')

        def undo():
            for h in hooks:
                h.remove()
            (point_rcnn.proposal_layer, point_rcnn.pool_rois_for_eval,
             inference.nms_bev) = saved
        return undo

    return run, stages


def _joint(cfg, times, streams=None):
    """(run(frame), stage setup -> undo) for the joint step, or with
    `streams` the lockstep step over that many streams, which numbers the
    frames 1, 2, ... as they come.  The step is built twice, plain and with
    synchronized timers around its detection and tracker steps (the rest of
    a frame is top-K and packing)."""
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
        make, trk = pipeline.make_joint_step, 'make_device_tracker_step'
        state = [init_state(64, feat_dim), 0]   # tracker state, frame id
    else:
        make, trk = pipeline.make_batched_joint_step, \
            'make_batched_tracker_step'
        state = [init_batched_state(streams, 64, feat_dim), 0]
    joint = make(cfg, model, head, **kw)
    saved = (pipeline.make_detection_step, getattr(pipeline, trk))
    pipeline.make_detection_step = \
        lambda *a, **k: _timed(saved[0](*a, **k), times, 'detection')
    setattr(pipeline, trk,
            lambda *a, **k: _timed(saved[1](*a, **k), times, 'tracker'))
    try:
        timed_joint = make(cfg, model, head, **kw)
    finally:
        pipeline.make_detection_step = saved[0]
        setattr(pipeline, trk, saved[1])
    use = [joint]

    def run(f):
        state[1] += 1
        fid = (state[1] if streams is None
               else np.full(streams, state[1], np.int32))
        state[0], packed = use[0](state[0], fid, f['pts_input'], f['img'],
                                  f['pts_xy'])
        return packed

    def stages():
        use[0] = timed_joint

        def undo():
            use[0] = joint
        return undo

    return run, stages


def _host_syncs(run, frames):
    """(tracker device-to-host reads, synchronizing CUDA calls) per frame,
    over `frames` run one after the other."""
    from jmodt_torch.tracking import device_tracker
    before = device_tracker.host_syncs
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            for f in frames:
                run(f)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    syncs = sum('synchroniz' in str(w.message) for w in seen)
    n = len(frames)
    return (device_tracker.host_syncs - before) / n, syncs / n


def _compare_deconv(run, frames):
    """(ms a frame with matmul + K6, ms a frame with conv_transpose2d),
    wall clock, the two taking frames in turn."""
    from jmodt_torch.models.image_backbone import NonOverlapDeconv
    port = NonOverlapDeconv.forward
    weights = {}

    def library(mod, x):
        if mod not in weights:
            weights[mod] = (mod.weight.to(mod.dtype), mod.bias.to(mod.dtype))
        w, b = weights[mod]
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(mod.dtype), w, b,
                               stride=mod.kernel)
        return y.permute(0, 2, 3, 1)

    total = [0.0, 0.0]
    try:
        for f in frames:
            for i, forward in enumerate((port, library)):
                NonOverlapDeconv.forward = forward
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(f)
                torch.cuda.synchronize()
                total[i] += (time.perf_counter() - t0) * 1e3
    finally:
        NonOverlapDeconv.forward = port
    return total[0] / len(frames), total[1] / len(frames)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--path', default='joint',
                    choices=('joint', 'batched', 'detection'))
    ap.add_argument('--streams', type=int, default=4,
                    help='streams of --path batched')
    ap.add_argument('--frames', type=int, default=3)
    ap.add_argument('--dtype', default='bfloat16',
                    choices=('bfloat16', 'float32'))
    args = ap.parse_args()

    from jmodt_torch.config import Config
    from jmodt_torch.data.synthetic import make_eval_frame

    cfg = dataclasses.replace(Config(), DTYPE=args.dtype)
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
    times = collections.defaultdict(float)
    if args.path == 'detection':
        run, stages = _detection(cfg, times)
    else:
        run, stages = _joint(cfg, times, streams)

    run(frames[0])                                       # warm-up
    torch.cuda.synchronize()

    # stages of one frame, synchronized at each boundary
    undo = stages()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(frames[1])
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
    rest = ('(rest: decode, scoring, glue)' if args.path == 'detection'
            else '(rest: top-K, packing)')
    what = args.path + (f', {streams} streams' if streams else '')
    print(f'stages of one synchronized {what} frame ({args.dtype}), ms:')
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f'  {name:32s} {ms:9.3f}')
    print(f'  {rest:32s} {total - sum(times.values()):9.3f}')
    print(f'  {"total":32s} {total:9.3f}')

    if args.path != 'detection':
        trk, allsync = _host_syncs(run, frames[1:])
        print(f'host syncs per frame: tracker {trk:.1f} (device-to-host '
              f'reads), whole frame {allsync:.1f} (synchronizing CUDA calls, '
              f'sync debug mode; {args.frames} frames)')

    # unsynchronized frames under the profiler
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames[1:]:
            run(f)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.frames
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    summed = sum(e.self_device_time_total for e in kern) / 1e3 / args.frames
    dev = union_length((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == cuda) / 1e3 / args.frames
    print(f'frame: {wall:.3f} ms wall, {dev:.3f} ms of device time (union '
          f'of kernel intervals; sum of kernel durations {summed:.3f}), '
          f'idle share {max(0.0, 1 - dev / wall):.3f} (by the sum '
          f'{max(0.0, 1 - summed / wall):.3f}) ({args.frames} frames, '
          'profiled)')
    if streams:
        print(f'stream-frame: {wall / streams:.3f} ms wall, '
              f'{dev / streams:.3f} ms of device time ({streams} streams)')
    print('kernels by device time per frame, ms:')
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:20]:
        print(f'  {e.self_device_time_total / 1e3 / args.frames:9.3f}  '
              f'x{e.count // args.frames:<5d} {e.key[:90]}')
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    print('host ops by self CPU time per frame, ms:')
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:20]:
        print(f'  {e.self_cpu_time_total / 1e3 / args.frames:9.3f}  '
              f'x{e.count // args.frames:<5d} {e.key[:90]}')

    _compare_deconv(run, frames[:1])                 # warm-up of both
    port, library = _compare_deconv(run, frames[1:])
    print(f'deconvs: {port:.3f} ms a frame with matmul + K6, {library:.3f} '
          f'ms with F.conv_transpose2d ({args.frames} frames each, in turn, '
          'wall clock)')


if __name__ == '__main__':
    with torch.no_grad():
        main()
