"""Where the detection step's time goes on the CUDA card.

    python3 -m jmodt_torch.profile_step [--frames N] [--dtype bfloat16]

Runs the detection step at the default Config() (16384 points, 384x1280
uint8 image, random weights from seed 0) on synthetic frames, after one
warm-up frame, and prints:

* stages: wall ms of each stage of one frame, with the device synchronized
  at every stage boundary (the syncs remove overlap, so the stages add up
  to a little more than an unsynchronized frame);
* frame: unsynchronized wall ms per frame over N frames, the device time of
  all kernels per frame from torch.profiler, and the device's idle share;
* the kernels with the most device time per frame.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import torch


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=3)
    ap.add_argument('--dtype', default='bfloat16',
                    choices=('bfloat16', 'float32'))
    args = ap.parse_args()

    from jmodt_torch.config import Config
    from jmodt_torch.data.synthetic import make_eval_frame
    from jmodt_torch.models import inference, point_rcnn
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.models.point_rcnn import build_detector

    cfg = dataclasses.replace(Config(), DTYPE=args.dtype)
    frames = [make_eval_frame(s, cfg, raw_u8=True)
              for s in range(args.frames + 1)]
    model = build_detector(cfg, seed=0)
    step = make_detection_step(cfg, model)

    def run(f):
        return step(f['pts_input'], f['img'], f['pts_xy'])

    run(frames[0])                                       # warm-up
    torch.cuda.synchronize()

    # stages of one frame, synchronized at each boundary
    times = collections.defaultdict(float)
    hooks = _stage_hooks(model, times)
    saved = (point_rcnn.proposal_layer, point_rcnn.pool_rois_for_eval,
             inference.nms_bev)
    point_rcnn.proposal_layer = _timed(saved[0], times, 'proposal_layer')
    point_rcnn.pool_rois_for_eval = _timed(saved[1], times,
                                           'pool_rois_for_eval')
    inference.nms_bev = _timed(saved[2], times, 'final nms_bev')
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(frames[1])
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for h in hooks:
            h.remove()
        (point_rcnn.proposal_layer, point_rcnn.pool_rois_for_eval,
         inference.nms_bev) = saved
    print(f'stages of one synchronized frame ({args.dtype}), ms:')
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f'  {name:32s} {ms:9.3f}')
    print(f'  {"(rest: decode, scoring, glue)":32s} '
          f'{total - sum(times.values()):9.3f}')
    print(f'  {"total":32s} {total:9.3f}')

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
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in kern) / 1e3 / args.frames
    print(f'frame: {wall:.3f} ms wall, {dev:.3f} ms of kernels on the '
          f'device, idle share {max(0.0, 1 - dev / wall):.3f} '
          f'({args.frames} frames, profiled)')
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


if __name__ == '__main__':
    with torch.no_grad():
        main()
