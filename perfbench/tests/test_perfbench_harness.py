"""The harness on the CPU at the port's small configuration: no card, no
run; a cell and a metric added as files and entries alone; sound runs
correct, and each fault the cells can have, and the lower-precision
control, not correct."""

from __future__ import annotations

import json
import time

import pytest
import torch

from perfbench import check, harness
from perfbench.program import Program, plain_changes

SEED = 2 ** 31 + 977


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = harness.main(['--workload', 'fusion.online_s1', '--seed', '1',
                       '--seconds', '1'], time.perf_counter())
    out = capsys.readouterr()
    assert rc == 2 and out.out == '' and 'CUDA' in out.err


def _run(root, name, seed=SEED, trace=False, **extra):
    spec = harness.cell_spec(root, name, seed, 2.0, trace, 'cpu',
                             time.perf_counter())
    for k, v in extra.items():
        setattr(spec, k, v)
    return harness.run(spec)


def test_a_cell_and_a_metric_added_as_files(small_root):
    root, add_cell = small_root
    add_cell('small.s1', 1)
    # a new per-layer reader: a file and an entry, nothing else
    (root / 'perfbench/metrics/checked.frames.py').write_text(
        'def read(ctx):\n    return 7.0\n')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['per_layer'].append({
        'name': 'checked.frames', 'unit': 'frames', 'better': 'higher',
        'source': 'program_counter', 'layer': 'test', 'moves':
        'frames_per_s', 'workloads': ['small.s1']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    out = _run(root, 'small.s1')
    assert set(out['metrics']) == {'frames_per_s', 'frame_latency_p95_ms',
                                   'setup_s'}
    assert out['metrics']['frames_per_s']['unit'] == 'frames/s'
    assert check.correct(out['checks']), out['checks']
    assert out['checked'] == 3 and out['attempted'] > 0
    traced = _run(root, 'small.s1', trace=True)
    # on the CPU no device metric has anything to read
    assert traced['metrics'] == {'checked.frames': {'value': 7.0,
                                                     'unit': 'frames'}}
    assert check.correct(traced['checks'])


def test_same_seed_same_checks(small_root):
    root, add_cell = small_root
    add_cell('small.s2', 2)
    a, b = _run(root, 'small.s2'), _run(root, 'small.s2')
    assert a['checks'] == b['checks'] and check.correct(a['checks'])


def _patch_step(monkeypatch, name, fault):
    """Wrap the program's `pipeline.<name>` so the steps it makes pass
    their results through `fault`."""
    from jmodt_torch import pipeline
    make = getattr(pipeline, name)

    def faulty(*a, **k):
        step = make(*a, **k)
        return lambda *args: fault(args, step(*args))
    monkeypatch.setattr(pipeline, name, faulty)


def _state_unchanged(args, result):
    return args[0], result[1]


def _answer_altered(args, det):
    det = dict(det)
    det['boxes'] = det['boxes'] + 1e-3
    return det


def _half_left_out(args, det):
    h = det['boxes'].shape[0] // 2
    return {k: torch.cat([v[:h], v[:1].expand(v.shape[0] - h,
                                              *v.shape[1:])])
            for k, v in det.items()}


@pytest.mark.parametrize('streams, maker, fault, caught', [
    (1, 'make_device_tracker_step', _state_unchanged, 'track_mismatch'),
    (2, 'make_batched_tracker_step', _state_unchanged, 'track_mismatch'),
    (1, 'make_detection_step', _answer_altered, 'detection_mismatch'),
    (2, 'make_detection_step', _half_left_out, 'detection_mismatch'),
], ids=['state-unchanged-s1', 'state-unchanged-s2', 'answer-altered',
        'half-left-out'])
def test_a_fault_is_not_correct(small_root, monkeypatch, streams, maker,
                                fault, caught):
    root, add_cell = small_root
    add_cell('small.f', streams)
    _patch_step(monkeypatch, maker, fault)
    out = _run(root, 'small.f')
    assert not check.correct(out['checks'])
    assert out['checks'][caught]['value'] > out['checks'][caught]['limit']


def test_the_control_is_not_correct(small_root):
    """The reference in the program's place with float8 products (the
    step below bfloat16) fails the networks' limits that bfloat16 passes;
    here at the small configuration, with limits set as for the cells."""
    from perfbench.reference.models.layers import mark_fp8
    root, add_cell = small_root
    add_cell('small.c', 1, limits={
        'rpn_err': 0.2, 'rcnn_err': 0.2, 'proposal_mismatch': 0,
        'detection_mismatch': 0, 'track_mismatch': 0})
    sound = _run(root, 'small.c')
    assert check.correct(sound['checks']), sound['checks']
    control = _run(root, 'small.c', program=Program('perfbench.reference'),
                   changes=plain_changes('bfloat16'), mark=mark_fp8)
    assert not check.correct(control['checks']), control['checks']


def test_reference_agrees_with_the_port_in_float32(small_root):
    """At float32 the reference and the port's step (K5's plain version,
    N1-N3's plain versions on the CPU) agree to rounding."""
    from conftest import small_tree
    from perfbench.drivers.joint import JointRun, window
    tree = small_tree('float32')
    trk = {'max_tracks': 64, 'track_k': 16, 'det_score_thresh': 0.2,
           'assign': 'hungarian'}
    traffic = {'streams': 1, 'pool_frames': 4, 'cars': [2, 7],
               'speed': [1.5, 0.3], 'image_hw': [64, 128]}
    run = JointRun(tree, trk, traffic, SEED, 'cpu')
    w = window(run, 0.5, {0, 1, 2})
    ref = check.Reference(tree, trk, run.model_state, run.head_state, 'cpu')
    for cap in w['captures']:
        num = ref.compare(cap)
        assert num['rpn_err'] < 1e-4 and num['rcnn_err'] < 1e-4, num
        assert num['proposal_mismatch'] == num['detection_mismatch'] == 0
        assert num['track_mismatch'] == 0


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    """One short run of the first cell through the command."""
    import subprocess
    import sys
    res = subprocess.run([sys.executable, '-m', 'perfbench', '--workload',
                          'fusion.online_s1', '--seed', str(SEED),
                          '--seconds', '2', '--trace', '0'],
                         capture_output=True, text=True, timeout=600,
                         cwd=harness.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['device']['platform'] == 'gpu'


TRAIN_LIMITS = {'rpn_err': 0.2, 'proposal_mismatch': 0, 'target_mismatch': 0,
                'loss_gap': 0.004, 'delta_gap': 0.5}


def test_a_training_cell(small_root):
    root, add_cell = small_root
    add_cell('small.t', None, limits=TRAIN_LIMITS)
    out = _run(root, 'small.t')
    assert set(out['metrics']) == {'train_pairs_per_s', 'setup_s'}
    assert check.correct(out['checks']), out['checks']
    assert out['checked'] == 3 and out['attempted'] > 0


def _state_unchanged_step(self):
    self.count += 1


@pytest.mark.parametrize('fault, caught', [
    ('state-unchanged', 'delta_gap'), ('half-pairs', 'loss_gap'),
    ('control', 'rpn_err')])
def test_a_training_fault_is_not_correct(small_root, monkeypatch, fault,
                                         caught):
    from jmodt_torch.train import train_step
    from perfbench import readings
    root, add_cell = small_root
    add_cell('small.tf', None, limits=TRAIN_LIMITS)
    extra = {}
    if fault == 'state-unchanged':
        monkeypatch.setattr(train_step.Optimizer, 'step',
                            _state_unchanged_step)
    elif fault == 'half-pairs':
        # recorded first, so that the teardown puts the real one back
        monkeypatch.setattr(train_step, 'compute_losses',
                            train_step.compute_losses)
        readings.half_pairs_loss(Program('jmodt_torch'))
    else:
        extra = readings._control()
    out = _run(root, 'small.tf', **extra)
    assert not check.correct(out['checks'])
    assert out['checks'][caught]['value'] > out['checks'][caught]['limit']
