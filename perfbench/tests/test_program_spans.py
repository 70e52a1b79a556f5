"""The readers of the program's spans (perfbench/program_spans.py and the
metrics that use it) on hand-made chrome events: idle split across nested
spans and at a gap's inner boundaries, a backward launched from another
thread, glue against hand-written kernels, and a trace with no `jmodt.`
span.  On the card: the span API's gate under emit_nvtx, and a traced
joint step read through them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import harness, program_spans
from perfbench.trace import Trace

INFER = ('pipeline.idle_ms_per_frame', 'backbone.idle_ms_per_frame',
         'heads.idle_ms_per_frame', 'tracker.idle_ms_per_frame',
         'kernels.glue_device_ms.infer')
TRAIN = ('train.backbone_device_ms_per_step',
         'train.rcnn_device_ms_per_step',
         'train.backward_device_ms_per_step', 'kernels.glue_device_ms.train')


def span(name, ts, end, tid=1):
    return {'ph': 'X', 'cat': 'user_annotation', 'name': name, 'ts': ts,
            'dur': end - ts, 'tid': tid}


class Ops:
    """Launch calls and the device operations they make, one correlation
    id each."""

    def __init__(self, first=1):
        self.events = []
        self.first = first

    def op(self, name, launch, start, end, tid=1):
        corr = self.first + len(self.events) // 2
        self.events += [
            {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
             'ts': launch, 'dur': 1, 'tid': tid,
             'args': {'correlation': corr}},
            {'ph': 'X', 'cat': 'kernel', 'name': name, 'ts': start,
             'dur': end - start, 'args': {'correlation': corr}}]
        return self


def read(name, tr):
    return harness.reader(harness.ROOT, name)(SimpleNamespace(trace=tr))


def joint_frame():
    """One frame, times in us: device idle [15, 30] in the backbone, [45,
    62] split 5 / 12 between the backbone and the heads, [80, 97] split
    15 / 2 between the tracker and packing, [99, 120] 1 in packing and 20
    after the frame."""
    spans = [span('jmodt.joint', 0, 100), span('jmodt.upload', 0, 10),
             span('jmodt.detection', 10, 70),
             span('jmodt.backbone', 10, 50),
             span('jmodt.backbone.sa0', 12, 40),
             span('jmodt.detection.rcnn', 55, 65),
             span('jmodt.tracker', 70, 95),
             span('jmodt.tracker.assign', 75, 90),
             span('jmodt.pack', 95, 100), span('pb.joint', 0, 101)]
    # an operation that ends a gap starts when the host launches it
    ops = (Ops().op('copy', 2, 5, 15).op('gemm', 30, 30, 45)
           .op('rcnn', 62, 62, 80).op('cat', 97, 97, 99)
           .op('after', 120, 120, 125))
    return Trace(spans + ops.events, frames=1, window_s=125e-6)


def shifted(tr, us):
    """`tr` with the device's clock `us` ahead of the host's."""
    return Trace(tr.host_ops + [dict(e, ts=e['ts'] + us) for e in tr.device],
                 tr.frames, tr.window_s)


def test_idle_goes_to_the_innermost_layer_at_each_instant():
    tr = joint_frame()
    got = {n: read(n, tr) for n in INFER[:4]}
    assert got == pytest.approx({
        'pipeline.idle_ms_per_frame': 3e-3,
        'backbone.idle_ms_per_frame': 20e-3,
        'heads.idle_ms_per_frame': 12e-3,
        'tracker.idle_ms_per_frame': 15e-3})
    by = program_spans.idle_by_span(tr, [
        n for roots in program_spans.LAYERS.values() for n in roots])
    # the four layers and the idle outside every frame make the whole
    assert by[None] == pytest.approx(20e-3)
    gaps = program_spans.idle_gaps(tr)
    assert sum(got.values()) + by[None] == pytest.approx(
        sum(b - a for a, b in gaps) / 1e3)


@pytest.mark.parametrize('us', [-7.0, 40.0])
def test_a_device_clock_off_the_hosts_moves_no_idle(us):
    """The device's timestamps drift against the host's on the card: each
    gap is put back on the host's clock by the launch that ends it."""
    tr = joint_frame()
    assert program_spans.early_starts(shifted(tr, us)) == (5 if us < 0
                                                           else 0)
    assert {n: read(n, shifted(tr, us)) for n in INFER[:4]} == \
        pytest.approx({n: read(n, tr) for n in INFER[:4]})


def test_a_gap_ended_by_a_queued_operation_takes_its_neighbours_offset():
    """An operation launched long before the device reached it (it waited
    behind others) does not set its gap's place: the least lag of the gaps
    around it does."""
    spans = [span('jmodt.joint', 0, 100), span('jmodt.backbone', 0, 40),
             span('jmodt.tracker', 40, 100)]
    ops = (Ops().op('a', 1, 1, 10).op('b', 20, 20, 30)
           .op('queued', 25, 50, 60).op('c', 70, 70, 80))
    tr = Trace(spans + ops.events, 1, 100e-6)
    # gaps [10, 20] and [60, 70] end at their launches; [30, 50] stays put
    assert program_spans.idle_gaps(tr) == [[10, 20], [30, 50], [60, 70]]
    assert read('backbone.idle_ms_per_frame', tr) == pytest.approx(20e-3)
    assert read('tracker.idle_ms_per_frame', tr) == pytest.approx(20e-3)


def test_finer_spans_split_the_same_idle():
    by = program_spans.idle_by_span(joint_frame(), [
        'jmodt.backbone', 'jmodt.backbone.sa0', 'jmodt.tracker',
        'jmodt.tracker.assign'])
    # [15, 30] inside sa0; [45, 50] in the backbone outside it; [80, 90]
    # in the assignment, [90, 95] in the tracker outside it
    assert by['jmodt.backbone.sa0'] == pytest.approx(15e-3)
    assert by['jmodt.backbone'] == pytest.approx(5e-3)
    assert by['jmodt.tracker.assign'] == pytest.approx(10e-3)
    assert by['jmodt.tracker'] == pytest.approx(5e-3)


def train_step():
    """A step: the backbone and the RCNN in the forward on thread 1, the
    backward's launches from the autograd engine's thread 2 while thread
    1 waits in `jmodt.backward`, then the optimizer."""
    spans = [span('jmodt.train_step', 0, 200),
             span('jmodt.forward', 0, 100),
             span('jmodt.backbone', 10, 50),
             span('jmodt.forward.rcnn', 60, 100),
             span('jmodt.backward', 100, 180),
             span('jmodt.optimizer', 180, 200)]
    ops = (Ops().op('conv', 20, 25, 35).op('gemm', 70, 72, 77)
           .op('gemm_bwd', 120, 121, 128, tid=2)
           .op('reduce_bwd', 150, 151, 154, tid=2)
           .op('adam', 190, 191, 193))
    return Trace(spans + ops.events, frames=1, window_s=200e-6)


def test_a_backward_launched_from_another_thread_counts_as_backward():
    tr = train_step()
    got = {n: read(n, tr) for n in TRAIN[:3]}
    assert got == pytest.approx({
        'train.backbone_device_ms_per_step': 10e-3,
        'train.rcnn_device_ms_per_step': 5e-3,
        'train.backward_device_ms_per_step': 10e-3})


def test_a_backbone_outside_a_train_step_is_not_the_steps():
    tr = train_step()
    late = Trace(tr.host_ops + tr.device + [
        span('jmodt.backbone', 300, 320)] + Ops(first=99).op(
            'conv', 305, 306, 316).events, frames=1, window_s=320e-6)
    assert read('train.backbone_device_ms_per_step', late) == \
        pytest.approx(10e-3)


def test_glue_is_what_the_wrappers_launch_besides_their_kernels():
    spans = [span('jmodt.joint', 0, 100),
             span('jmodt.kernel.nms', 10, 50),
             span('jmodt.kernel.lap', 60, 70)]
    ops = (Ops().op('void at::native::bitonicSortKVInPlace<...>', 11, 12, 16)
           .op('nms_mask_kernel(float const*)', 20, 21, 27)
           .op('nms_scan_kernel(unsigned long const*)', 30, 31, 32)
           .op('void at::native::elementwise_kernel<...>', 55, 56, 65)
           .op('lap_kernel(float const*)', 61, 66, 68)
           .op('void at::native::vectorized_elementwise_kernel<cast>', 62,
               70, 73))
    tr = Trace(spans + ops.events, frames=2, window_s=100e-6)
    # the sort (4 us) and the cast (3 us), over 2 frames
    assert read('kernels.glue_device_ms.infer', tr) == pytest.approx(3.5e-3)
    assert read('kernels.glue_device_ms.train', tr) == pytest.approx(3.5e-3)


def test_a_trace_without_the_programs_spans_reads_none():
    """The parent's program opens no `jmodt.` span: every reader is None,
    not 0; so is a trace with spans and no device operation (the CPU)."""
    tr = joint_frame()
    bare = Trace([e for e in tr.host_ops + tr.device
                  if not e['name'].startswith('jmodt.')], 1, 125e-6)
    assert bare.device and program_spans.spans(bare) == []
    cpu = Trace(tr.host_ops, 1, 125e-6)
    for t in (bare, cpu):
        assert {n: read(n, t) for n in INFER + TRAIN} == dict.fromkeys(
            INFER + TRAIN)


def test_early_starts_count_ops_before_their_launch():
    tr = joint_frame()
    assert program_spans.early_starts(tr) == 0
    ops = Ops().op('early', 50, 40, 45)
    assert program_spans.early_starts(Trace(ops.events, 1, 1e-4)) == 1


@pytest.mark.card
def test_the_span_gate_is_open_under_emit_nvtx(card):
    import torch
    from jmodt_torch.utils import trace
    assert not trace._recording()
    with torch.autograd.profiler.emit_nvtx():
        assert trace._recording()
    with torch.profiler.profile():
        assert trace._recording()


@pytest.mark.card
def test_a_traced_joint_step_on_the_card(card):
    """A small joint step traced on the card: every launch call lies inside
    the torch operation that made it (the host's two clocks agree; the
    device's may drift, which `idle_gaps` absorbs), the readers read
    numbers, and the four layers' idle is the idle inside the frames."""
    import numpy as np
    from conftest import small_tree
    from perfbench.drivers.joint import JointRun
    from perfbench.trace import profile
    trk = {'max_tracks': 64, 'track_k': 16, 'det_score_thresh': 0.2,
           'assign': 'hungarian'}
    traffic = {'streams': 1, 'pool_frames': 4, 'cars': [2, 7],
               'speed': [1.5, 0.3], 'image_hw': [64, 128]}
    run = JointRun(small_tree(), trk, traffic, 2 ** 31 + 5, 'cuda')
    run.warm_up(2)
    tr = profile(lambda: [run.frame() for _ in range(3)], 3, run.sync)
    run.close()
    ops = {e['args']['External id']: e for e in tr.host_ops
           if e.get('cat') == 'cpu_op' and 'External id' in e.get('args', {})}
    calls = [(e, ops[e['args']['External id']]) for e in tr.runtime
             if e.get('args', {}).get('External id') in ops]
    assert calls and all(o['ts'] <= e['ts'] and e['ts'] + e['dur'] <=
                         o['ts'] + o['dur'] for e, o in calls)
    got = {n: read(n, tr) for n in INFER}
    assert all(v is not None and v >= 0 for v in got.values()), got
    by = program_spans.idle_by_span(tr, [
        n for roots in program_spans.LAYERS.values() for n in roots])
    assert sum(got[n] for n in INFER[:4]) == pytest.approx(
        sum(v for k, v in by.items() if k is not None))
    assert np.isfinite(program_spans.launch_ts(tr)).mean() > 0.95
