"""The port's spans (`jmodt_torch/utils/trace.py`) on the CPU, at the small
config in float32 with RPN.MEGA_SA: under torch.profiler a joint step at
S = 1, a lockstep step at S = 2 and a finetune train step each record one
root span a call with its layers nested under it; with the profiler off
the span API never enters `record_function`; and the lookups that the
benchmark's own wrappers depend on still happen at each build and call.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jmodt_torch import pipeline
from jmodt_torch.config import small_config
from jmodt_torch.data.synthetic import make_eval_frame, make_pair_batch
from jmodt_torch.models.point_rcnn import build_detector, init_weights
from jmodt_torch.models.rcnn import CorrelationHead
from jmodt_torch.tracking.device_tracker import init_batched_state, init_state
from jmodt_torch.train import train_step as ts
from jmodt_torch.utils import trace

KW = dict(track_k=8, det_score_thresh=0.0)
LEVELS = range(4)
# each structural span and the spans directly under it, as the port opens
# them; the kernel wrappers' spans sit under the finer spans of FRAME_KERNELS
FRAME = {
    'jmodt.joint': {'jmodt.upload', 'jmodt.detection', 'jmodt.top_k',
                    'jmodt.tracker', 'jmodt.pack'},
    'jmodt.detection': {'jmodt.backbone', 'jmodt.detection.rpn_heads',
                        'jmodt.detection.proposal',
                        'jmodt.detection.roi_pool', 'jmodt.detection.rcnn',
                        'jmodt.detection.decode'},
    'jmodt.backbone': ({f'jmodt.backbone.sa{k}' for k in LEVELS}
                       | {f'jmodt.backbone.image{k}' for k in LEVELS}
                       | {f'jmodt.backbone.fp{k}' for k in LEVELS}
                       | {'jmodt.backbone.pyramid'}),
    'jmodt.tracker': {f'jmodt.tracker.{s}' for s in (
        'predict', 'affinity', 'assign', 'update', 'births', 'emit')},
}
FRAME_KERNELS = {
    'jmodt.kernel.sa_level': {f'jmodt.backbone.sa{k}' for k in LEVELS},
    'jmodt.kernel.three_nn': {f'jmodt.backbone.fp{k}' for k in LEVELS},
    'jmodt.kernel.depth_to_space': {'jmodt.backbone.pyramid'},
    'jmodt.kernel.nms': {'jmodt.detection.proposal',
                         'jmodt.detection.decode'},
    'jmodt.kernel.fps': {'jmodt.detection.rcnn'},
    'jmodt.kernel.grouped_gather_mlp_max': {'jmodt.detection.rcnn'},
    'jmodt.kernel.kalman_predict': {'jmodt.tracker.predict'},
    'jmodt.kernel.lap': {'jmodt.tracker.assign'},
}
STEP = {
    'jmodt.train_step': {'jmodt.upload', 'jmodt.forward', 'jmodt.backward',
                         'jmodt.optimizer'},
    'jmodt.forward': {'jmodt.backbone', 'jmodt.detection.rpn_heads',
                      'jmodt.detection.proposal', 'jmodt.forward.rcnn'},
    'jmodt.backbone': FRAME['jmodt.backbone'],
}


def _cfg(finetune=False):
    cfg = small_config()
    cfg = dataclasses.replace(cfg, DTYPE='float32', RPN=dataclasses.replace(
        cfg.RPN, MEGA_SA=True, FIXED=cfg.RPN.FIXED or finetune))
    if finetune:
        cfg = dataclasses.replace(
            cfg, TRAIN=dataclasses.replace(cfg.TRAIN, FINETUNE=True),
            REID=dataclasses.replace(cfg.REID, FG_THRESH=0.0))
    return cfg


@pytest.fixture(scope='module')
def parts():
    cfg = _cfg()
    model = build_detector(cfg, device='cpu', seed=0)
    feat_dim = cfg.RCNN.SA_CONFIG.MLPS[-1][-1]
    head = CorrelationHead(feat_dim, cfg.REID.LINK_FC,
                           use_bn=cfg.REID.USE_BN)
    init_weights(head, 1)
    frames = [make_eval_frame(s, cfg, img_hw=(64, 128), raw_u8=True)
              for s in range(2)]
    return cfg, model, head, feat_dim, frames


def _s1(parts):
    """call() of the joint step at S = 1."""
    cfg, model, head, feat_dim, frames = parts
    joint = pipeline.make_joint_step(cfg, model, head, device='cpu', **KW)
    state = [init_state(16, feat_dim, 'cpu')]

    def call():
        f = frames[0]
        state[0], packed = joint(state[0], 1, f['pts_input'], f['img'],
                                 f['pts_xy'])
        return packed
    return call


def _s2(parts):
    cfg, model, head, feat_dim, frames = parts
    joint = pipeline.make_batched_joint_step(cfg, model, head, device='cpu',
                                             **KW)
    state = [init_batched_state(2, 16, feat_dim, 'cpu')]
    stacked = {k: np.concatenate([f[k] for f in frames])
               for k in ('pts_input', 'img', 'pts_xy')}

    def call():
        state[0], packed = joint(state[0], np.array([1, 1], np.int32),
                                 stacked['pts_input'], stacked['img'],
                                 stacked['pts_xy'])
        return packed
    return call


def _train():
    cfg = _cfg(finetune=True)
    model = build_detector(cfg, mode='TRAIN', device='cpu', seed=0)
    opt = ts.make_optimizer(cfg, model, steps_per_epoch=2)
    step = ts.make_train_step(cfg, model, opt, seed=0, device='cpu')
    batch = make_pair_batch(seed=0, cfg=cfg, num_pairs=1, img_hw=(64, 128))
    return model, opt, lambda: step(batch)


def _profiled_spans(call):
    """The `jmodt.` spans of one call under the CPU profiler, each with the
    name of the innermost span around it (None at the top)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    ev = sorted((e for e in prof.events() if e.name.startswith('jmodt.')),
                key=lambda e: (e.time_range.start, -e.time_range.end))
    out = []
    for i, e in enumerate(ev):
        around = [p for p in ev[:i] if p.thread == e.thread
                  and p.time_range.end >= e.time_range.end]
        out.append((e.name, around[-1].name if around else None))
    return out


def _children(found):
    kids = {}
    for name, parent in found:
        kids.setdefault(parent, set()).add(name)
    return kids


@pytest.mark.parametrize('build', [_s1, _s2], ids=['s1', 'lockstep-s2'])
def test_a_joint_step_records_its_span_tree(parts, build):
    call = build(parts)
    call()                                   # the first call builds caches
    found = _profiled_spans(call)
    kids = _children(found)
    assert kids[None] == {'jmodt.joint'}
    assert [n for n, _ in found].count('jmodt.joint') == 1
    for parent, want in FRAME.items():
        assert kids[parent] - set(FRAME_KERNELS) == want, parent
    for name, parent in found:
        if name in FRAME_KERNELS:
            assert parent in FRAME_KERNELS[name], (name, parent)
    assert set(FRAME_KERNELS) <= {n for n, _ in found}


def test_a_train_step_records_its_span_tree():
    _, _, call = _train()
    found = _profiled_spans(call)
    kids = _children(found)
    assert kids[None] == {'jmodt.train_step'}
    assert [n for n, _ in found].count('jmodt.train_step') == 1
    for parent, want in STEP.items():
        assert kids[parent] - set(FRAME_KERNELS) == want, parent
    assert 'jmodt.kernel.fps' in kids['jmodt.forward.rcnn']


def test_off_the_spans_never_enter_record_function(parts, monkeypatch):
    calls = []
    real = trace.record_function

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(trace, 'record_function', counted)
    joint = _s1(parts)
    _, _, step = _train()
    joint()
    step()
    assert calls == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        joint()
    assert calls.count('jmodt.joint') == 1 and len(calls) > 40


def test_the_benchmarks_lookups_still_happen(parts, monkeypatch):
    """make_joint_step looks its step makers up in `pipeline` when it is
    built, the train step calls `compute_losses` and `to_device` through
    its module and `step` through the optimizer instance, and the
    backbone runs as `model.rpn.backbone`."""
    seen = []

    def watched(maker, tag):
        def make(*a, **k):
            step = maker(*a, **k)

            def run(*args):
                seen.append(tag)
                return step(*args)
            return run
        return make

    for name in ('make_detection_step', 'make_device_tracker_step',
                 'make_batched_tracker_step'):
        monkeypatch.setattr(pipeline, name,
                            watched(getattr(pipeline, name), name))
    _s1(parts)()
    _s2(parts)()
    assert seen == ['make_detection_step', 'make_device_tracker_step',
                    'make_detection_step', 'make_batched_tracker_step']

    model, opt, step = _train()
    for name in ('compute_losses', 'to_device'):
        fn = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda *a, _f=fn, _n=name, **k: (
            seen.append(_n), _f(*a, **k))[1])
    real_step = opt.step
    opt.step = lambda: (seen.append('optimizer'), real_step())[1]
    hook = model.rpn.backbone.register_forward_hook(
        lambda *_: seen.append('backbone'))
    try:
        step()
    finally:
        hook.remove()
    assert seen[4:] == ['to_device', 'backbone', 'compute_losses',
                        'optimizer']


def test_profile_step_tables_the_spans(parts):
    """profile_step's span table of two profiled frames: calls a frame by
    span; on the CPU no device operation, so no device or idle ms."""
    from jmodt_torch import profile_step
    call = _s1(parts)
    call()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
        call()
    table = profile_step.span_table(prof, 2)
    assert table['jmodt.joint'][0] == 1
    assert table['jmodt.kernel.nms'][0] == 3
    assert table['jmodt.backbone.fp0'][0] == 1
    assert all(row[1:] == (0.0, 0.0, 0.0) for row in table.values())


class _Profile:
    """A profile whose chrome trace is `events`."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        import json
        with open(path, 'w') as f:
            json.dump({'traceEvents': self.events}, f)


def test_profile_step_puts_device_time_and_idle_under_the_host_spans():
    """Two kernels launched at 12 and 60 us, inside and after the
    backbone; the device's clock runs 5 us behind the host's, so the idle
    between them, 30-60 us on the host's clock, is 20 us in the backbone
    and 10 in the joint step."""
    from jmodt_torch import profile_step

    def x(cat, name, ts, dur, **args):
        return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
                'args': args}
    events = [x('user_annotation', 'jmodt.joint', 0, 100),
              x('user_annotation', 'jmodt.backbone', 10, 40),
              x('cuda_runtime', 'cudaLaunchKernel', 12, 2, correlation=1),
              x('cuda_runtime', 'cudaLaunchKernel', 60, 2, correlation=2),
              x('kernel', 'k1', 7, 18, correlation=1),
              x('kernel', 'k2', 55, 10, correlation=2)]
    table = profile_step.span_table(_Profile(events), 1)
    assert table['jmodt.joint'] == pytest.approx((1, 0.028, 0.010, 0.010))
    assert table['jmodt.backbone'] == pytest.approx((1, 0.018, 0.018,
                                                     0.020))
    assert table['(none)'] == (0, 0, 0, 0)
