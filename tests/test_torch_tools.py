"""The port's tools (`python -m jmodt_torch.tools.*`) against the JAX
package's (`tools/*.py`) on the CPU, on the same files.

- `oracle_ap` and `recall_diagnosis` on one synthetic KITTI-format tree
  (`data/synthetic.py::write_synthetic_kitti_tree`, converted), the
  recall over the oracle's jittered detections, and `recall_diagnosis`
  on a hand-made split that fills every bucket: the same JSON, keys,
  counts and buckets exact; `median_best_iou`, an IoU, within 1e-6 (each
  package rounds its float32 rotated IoU in its own order).  Both tools
  refuse to run without a card unless given `--device`.
- `ladder_report` on the log of a port ladder run: the same report.
- `synthetic_ladder` at its smallest on the CPU: three stages and the
  evaluation run, and its JSON line has the JAX tool's keys (read from
  the JAX tool's source: running it costs three JAX train compiles).
- `viewer`: the same bird's-eye and 3D PNGs, byte for byte, as
  `tools/visualization/viewer.py` (Agg), and the same painted points.
"""

import ast
import json
import os
import sys

import numpy as np
import pytest
import torch

from jmodt_torch.config import small_config
from jmodt_torch.data.converter import create_train_sample_data
from jmodt_torch.data.synthetic import write_synthetic_kitti_tree
from jmodt_torch.tools import (ladder_report, oracle_ap, recall_diagnosis,
                               synthetic_ladder, viewer)
from jmodt_torch.utils.png import write_png
from tests.test_data_layer import CALIB_TXT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import ladder_report as jax_ladder_report  # noqa: E402
from tools import oracle_ap as jax_oracle_ap  # noqa: E402
from tools import recall_diagnosis as jax_recall_diagnosis  # noqa: E402


def _jax_viewer():
    sys.path.insert(0, os.path.join(REPO, 'tools', 'visualization'))
    import viewer as jax_viewer
    return jax_viewer


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """A synthetic KITTI tracking tree (validation sequence 0000 and
    training sequence 0001, 6 frames each, 128x256 images) converted."""
    root = tmp_path_factory.mktemp('tools') / 'data'
    write_synthetic_kitti_tree(str(root / 'tracking'), small_config(),
                               n_frames=6, img_hw=(128, 256), seed=4)
    create_train_sample_data(str(root / 'tracking'),
                             str(root / 'tracking_object'), num_seqs=2)
    return root


def _run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['tool'] + argv)
    return mod.main()


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _assert_same_json(got, want, float_tol=1e-6):
    """Equal JSON: the same keys in the same order and equal values, but
    floats within `float_tol`."""
    assert type(got) is type(want), (got, want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same_json(got[k], want[k], float_tol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_json(g, w, float_tol)
    elif isinstance(want, float):
        assert abs(got - want) <= float_tol, (got, want)
    else:
        assert got == want


def test_oracle_ap_and_recall_match_jax(tree, tmp_path, monkeypatch,
                                        capsys):
    args = ['--data_root', str(tree), '--jitter', '0.3']
    oracle_ap.main(args + ['--out', str(tmp_path / 'port'), '--device',
                           'cpu'])
    port = _last_json(capsys.readouterr().out)
    _run_jax_main(jax_oracle_ap, args + ['--out', str(tmp_path / 'jax')],
                  monkeypatch)
    want = _last_json(capsys.readouterr().out)
    assert port == want
    assert port['oracle_dets'] > 0 and port['gt_valid_easy_mod_hard'][1] > 0
    for name in sorted(os.listdir(tmp_path / 'jax' / 'txt_jitter')):
        assert (tmp_path / 'port' / 'txt_jitter' / name).read_text() == \
            (tmp_path / 'jax' / 'txt_jitter' / name).read_text()

    dets = str(tmp_path / 'port' / 'txt_jitter')
    for iou in ('0.5', '0.7'):
        argv = ['--data_root', str(tree), '--det_dir', dets, '--iou', iou]
        got = recall_diagnosis.main(argv + ['--device', 'cpu'])
        want = jax_recall_diagnosis.main(argv)
        _assert_same_json(got, want)
        assert got['n_gt'] > 0


def _label_line(name, bbox, hwl, xyz, ry, score=None):
    parts = [name, '0', '0', '0.0', *['%.2f' % v for v in bbox],
             '%.2f %.2f %.2f' % hwl, '%.2f %.2f %.2f' % xyz, '%.4f' % ry]
    if score is not None:
        parts.append('%.4f' % score)
    return ' '.join(parts)


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')


def test_recall_diagnosis_buckets_match_jax(tmp_path):
    """A hit, a pure miss, a poor localization, an orientation flip and a
    far false positive (`tests/test_recall_diagnosis.py`'s cases), plus a
    frame without detections and one without gt."""
    obj = tmp_path / 'data' / 'tracking_object'
    labels, dets = obj / 'training' / 'label_2', tmp_path / 'det'
    _write(str(obj / 'ImageSets' / 'val.txt'),
           ['000000', '000001', '000002', '000003'])
    tall, short = (100.0, 100.0, 180.0, 150.0), (100.0, 100.0, 180.0, 130.0)
    car = (1.5, 1.6, 4.0)
    _write(str(labels / '000000.txt'), [
        _label_line('Car', tall, car, (0.0, 1.5, 8.0), 0.1),
        _label_line('Car', short, car, (12.0, 1.5, 25.0), 0.0)])
    _write(str(dets / '000000.txt'), [
        _label_line('Car', tall, car, (0.0, 1.5, 8.0), 0.1, score=0.9)])
    _write(str(labels / '000001.txt'), [
        _label_line('Car', tall, car, (0.0, 1.5, 8.0), 0.0),
        _label_line('Car', tall, (2.0, 4.0, 4.0), (-10.0, 2.0, 15.0), 0.0)])
    _write(str(dets / '000001.txt'), [
        _label_line('Car', tall, car, (0.0, 1.5, 9.0), 0.0, score=0.8),
        _label_line('Car', tall, (2.0, 4.0, 4.0), (-10.0, -1.0, 15.0),
                    np.pi / 2, score=0.7),
        _label_line('Car', tall, car, (40.0, 1.5, 90.0), 0.0, score=0.2)])
    _write(str(labels / '000002.txt'), [
        _label_line('Car', tall, car, (3.0, 1.5, 35.0), 0.0)])
    _write(str(labels / '000003.txt'), [
        _label_line('Pedestrian', tall, car, (3.0, 1.5, 35.0), 0.0)])
    _write(str(dets / '000003.txt'), [
        _label_line('Car', tall, car, (3.0, 1.5, 12.0), 0.0, score=0.4)])
    argv = ['--data_root', str(tmp_path / 'data'), '--det_dir', str(dets)]
    got = recall_diagnosis.main(argv + ['--device', 'cpu', '--json_out',
                                        str(tmp_path / 'port.json')])
    want = jax_recall_diagnosis.main(argv)
    _assert_same_json(got, want)
    assert got['n_gt'] == 5 and got['fp_count'] == 4
    with open(tmp_path / 'port.json') as f:
        assert json.load(f) == got


def test_tools_need_a_card_or_a_device(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        oracle_ap.main(['--data_root', str(tree)])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        recall_diagnosis.main(['--data_root', str(tree), '--det_dir',
                               str(tmp_path)])


@pytest.fixture(scope='module')
def ladder(tmp_path_factory):
    """The ladder at its smallest on the CPU: its JSON and a log of the
    run (each stage's train.log, then the evaluation's lines and the
    JSON line)."""
    out = tmp_path_factory.mktemp('ladder')
    with pytest.MonkeyPatch.context() as mp:
        lines = []
        mp.setattr('builtins.print', lambda *a, **kw: lines.append(
            ' '.join(str(x) for x in a)))
        result = synthetic_ladder.main([
            '--out', str(out), '--frames', '3', '--seqs', '2',
            '--epochs1', '1', '--epochs2', '1', '--epochs3', '1',
            '--batch', '2', '--device', 'cpu'])
    log = out / 'ladder.log'
    with open(log, 'w') as f:
        for stage in ('stage1', 'stage2', 'stage3'):
            f.write((out / stage / 'train.log').read_text())
        f.write('\n'.join(lines) + '\n')
    return result, out, log


def _json_keys_of_jax_ladder():
    """The keys of the dict literal that `tools/synthetic_ladder.py` passes
    to `json.dumps`."""
    with open(os.path.join(REPO, 'tools', 'synthetic_ladder.py')) as f:
        mod = ast.parse(f.read())
    for node in ast.walk(mod):
        if (isinstance(node, ast.Call) and getattr(node.func, 'attr', '')
                == 'dumps' and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError('no json.dumps({...}) in tools/synthetic_ladder.py')


def test_synthetic_ladder_json_keys_match_jax(ladder):
    result, out, log = ladder
    assert list(result) == _json_keys_of_jax_ladder()
    assert result['stages'] == [1, 1, 1]
    assert json.loads(log.read_text().strip().splitlines()[-1]) == result
    for stage in ('stage1', 'stage2', 'stage3'):
        assert os.path.exists(out / stage / 'ckpt' /
                              'checkpoint_epoch_1.pth'), stage
    # stage 1 wrote the 3 validation frames; stage 2 tracked what passed
    # its score threshold (with random weights, maybe nothing)
    assert sorted(os.listdir(out / 'det' / 'txt')) == [
        '000000.txt', '000001.txt', '000002.txt']
    assert os.path.isdir(out / 'mot' / 'ladder' / 'val')


def test_ladder_report_matches_jax(ladder, tmp_path, monkeypatch):
    """The ladder's log (random weights: no MOTA), twice over as a
    relaunch does, and again with a scored final line and a stage header
    without fusion=: the JAX tool's report.  (A null MOTA is written as
    n/a by the port; the JAX tool stops on it, so that log is compared
    with a scored final line.)"""
    result, _, log = ladder
    stages, eval_lines, final = ladder_report.parse([str(log)])
    # one step an epoch under --log_every 50: each stage logs the
    # placeholder loss 0.0, which the parser drops
    assert [(s['finetune'], s['fusion'], s['hist']) for s in stages] == [
        (False, False, []), (False, True, []), (True, True, [])]
    assert final == result and eval_lines
    port = ladder_report.main(['--log', str(log), '--out',
                               str(tmp_path / 'null.md')])
    assert '- MOTA: **n/a**' in open(port).read()

    scored = tmp_path / 'scored.log'
    scored.write_text(
        log.read_text() + 'INFO  finetune=False epochs=3\nINFO  epoch 1: '
        'train_loss=2.0 (1.0s, 1 its)\nCar AP@0.70, 0.50, 0.50:\n'
        'bev  AP:1.0, 2.0, 3.0\n3d   AP:0.5, 0.6, 0.7\n' + json.dumps(
            {'ap_3d_moderate': 0.6, 'ap_bev_moderate': 2.0, 'mota': 0.25,
             'stages': [3, 1, 1]}) + '\n')
    for logs in ([scored], [log, scored]):      # a relaunch: merged
        argv = ['--log', *map(str, logs), '--title', 't', '--out']
        port = ladder_report.main(argv + [str(tmp_path / 'port.md')])
        _run_jax_main(jax_ladder_report, argv + [str(tmp_path / 'jax.md')],
                      monkeypatch)
        assert (tmp_path / 'jax.md').read_text() == open(port).read()
        assert '- MOTA: **0.2500**' in open(port).read()


@pytest.fixture(scope='module')
def seq(tmp_path_factory):
    """A raw tracking sequence: 3 frames of 4000-point sweeps, red
    375x1242 PNGs and two tracked cars."""
    root = tmp_path_factory.mktemp('viewer')
    for sub in ('calib', 'velodyne/0000', 'image_02/0000', 'labels'):
        os.makedirs(root / sub)
    (root / 'calib' / '0000.txt').write_text(CALIB_TXT)
    rng = np.random.RandomState(0)
    rows = []
    for f in range(3):
        pts = np.stack([rng.uniform(3, 60, 4000), rng.uniform(-20, 20, 4000),
                        rng.uniform(-2, 1, 4000), np.zeros(4000)],
                       1).astype(np.float32)
        pts.tofile(root / 'velodyne' / '0000' / f'{f:06d}.bin')
        img = np.zeros((375, 1242, 3), np.uint8)
        img[..., 0] = 200
        img[..., 1] = rng.randint(0, 50, (375, 1242))
        write_png(str(root / 'image_02' / '0000' / f'{f:06d}.png'), img)
        for tid, x, z in ((1, 0.5 * f, 12.0 + f), (2, -4.0, 20.0 - f)):
            rows.append(f'{f} {tid} Car 0 0 -1.5 100 100 150 200 1.5 1.6 '
                        f'3.9 {x} 1.6 {z} 0.1\n')
    (root / 'labels' / '0000.txt').write_text(''.join(rows))
    return root


def test_viewer_writes_the_frames_jax_writes(seq, tmp_path):
    jax_viewer = _jax_viewer()
    kw = dict(root_dir=str(seq), seq=0, label_dir=str(seq / 'labels'))
    port = viewer.KittiSequenceViewer(output_dir=str(tmp_path / 'p'), **kw)
    want = jax_viewer.KittiSequenceViewer(output_dir=str(tmp_path / 'j'),
                                          **kw)
    pts, colors = port.get_painted_point_cloud('000001')
    wpts, wcolors = want.get_painted_point_cloud('000001')
    np.testing.assert_array_equal(pts, wpts)
    np.testing.assert_array_equal(colors, wcolors)
    assert len(pts) > 100
    port.visualize(view='both')
    want.visualize(view='both')
    names = sorted(os.listdir(tmp_path / 'j'))
    assert names == sorted(os.listdir(tmp_path / 'p'))
    assert len(names) == 6
    for name in names:
        assert (tmp_path / 'p' / name).read_bytes() == \
            (tmp_path / 'j' / name).read_bytes(), name
    assert set(port._trajectories_for_frame(2)) == {1, 2}
