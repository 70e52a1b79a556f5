"""`python -m jmodt_torch.eval.mot_sweep` against `tools/mot_sweep.py` on the
CPU, over the same persisted stage-1 files with the same link / se heads.

The tree is a raw KITTI tracking tree of two validation sequences
(`data/synthetic.py::write_synthetic_kitti_tree`), converted by the port's
converter.  The stage-1 files are its gt boxes with noise the sweep can
rank: scores spread over the grid's detection gates, some cars missed in
some frames, and false positives.  The heads are the port's random ones
from a seed: the JAX sweep reads them from a flax checkpoint
(`export_jax_variables`), the port from a `.pth` of the same tensors.

- Every config's tracking txt byte-equal, its MOTA within 1e-6, the same
  ranking and the same `best`, with MIP and with `--hungarian`.
- The module runs from the command line at `--device cpu`.
- The best config's rerun line and `sweep_results.json` name
  `--hungarian` when the sweep ran with it.
"""

import importlib.util
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jmodt_torch.config import small_config
from jmodt_torch.data.converter import create_train_sample_data
from jmodt_torch.data.synthetic import write_synthetic_kitti_tree
from jmodt_torch.eval import mot_sweep
from jmodt_torch.models.point_rcnn import build_detector
from jmodt_torch.utils.object3d import get_objects_from_label
from jmodt_torch.weights import (export_jax_variables,
                                 jax_variables_to_state_dict)

ROOT = Path(__file__).resolve().parents[1]
MOTA_TOL = 1e-6
SEQS = ('0000', '0002')
N_FRAMES = 6
GRIDS = {
    False: {'cls_thresh': [0.3, 0.6, 0.85], 't_miss': [1, 3], 't_hit': [0],
            'w_app': [2.0, 0.5]},
    True: {'cls_thresh': [0.3, 0.7], 't_miss': [2], 't_hit': [0, 1]},
}


def _noisy_detections(root, det, feat_dim):
    """The gt cars of every converted sample as stage-1 files: each kept
    with probability 0.85, a score uniform in [0.2, 1), a feature per track
    id plus noise; and a false positive (a shifted box, a random feature)
    in about a third of the frames."""
    rng = np.random.RandomState(0)
    ids = rng.randn(64, feat_dim).astype(np.float32)
    labels = root / 'tracking_object' / 'training' / 'label_2'
    os.makedirs(det / 'txt')
    os.makedirs(det / 'feat')
    row = ('Car -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
           '%.4f %.4f %.4f\n')
    for name in sorted(os.listdir(labels)):
        rows, feats = [], []
        for o in get_objects_from_label(str(labels / name)):
            if o.cls_type != 'Car' or rng.rand() > 0.85:
                continue
            rows.append(row % (o.alpha, *o.box2d, o.h, o.w, o.l, *o.pos,
                               o.ry, rng.uniform(0.2, 1.0)))
            feats.append(ids[int(o.score)] + 0.05 * rng.randn(feat_dim))
            if rng.rand() < 0.15:
                x, y, z = o.pos
                rows.append(row % (o.alpha, *o.box2d, o.h, o.w, o.l,
                                   x + rng.uniform(3, 5), y, z, o.ry,
                                   rng.uniform(0.2, 1.0)))
                feats.append(rng.randn(feat_dim))
        (det / 'txt' / name).write_text(''.join(rows))
        np.save(det / 'feat' / name.replace('.txt', '.npy'),
                np.asarray(feats, np.float32).reshape(-1, feat_dim))


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """(KITTI root, stage-1 dir, JAX checkpoint, port .pth)."""
    from jmodt_tpu.train.checkpoint import checkpoint_state, save_checkpoint
    base = tmp_path_factory.mktemp('mot_sweep')
    cfg = small_config()
    root = base / 'KITTI'
    write_synthetic_kitti_tree(str(root / 'tracking'), cfg, seq_ids=SEQS,
                               n_frames=N_FRAMES, img_hw=(64, 128),
                               npoints=256, seed=4)
    create_train_sample_data(str(root / 'tracking'),
                             str(root / 'tracking_object'))
    _noisy_detections(root, base / 'det', cfg.RCNN.SA_CONFIG.MLPS[-1][-1])
    variables = export_jax_variables(build_detector(cfg, device='cpu',
                                                    seed=5))
    jax_ckpt = save_checkpoint(checkpoint_state(variables),
                               str(base / 'jax_model'))
    port_pth = str(base / 'port_model.pth')
    torch.save({'epoch': 1, 'it': 1, 'optimizer_state': None,
                'model_state': jax_variables_to_state_dict(variables)},
               port_pth)
    return root, base / 'det', jax_ckpt, port_pth


def _run_jax_sweep(monkeypatch, argv):
    spec = importlib.util.spec_from_file_location(
        'jax_mot_sweep', ROOT / 'tools' / 'mot_sweep.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, 'argv', ['mot_sweep.py', *argv])
    mod.main()


def _ranking(summary):
    return [r['tag'] for r in sorted(
        (r for r in summary['results'] if r['mota'] is not None),
        key=lambda r: -r['mota'])]


@pytest.mark.parametrize('hungarian', [False, True],
                         ids=['mip', 'hungarian'])
def test_sweep_matches_jax(setup, tmp_path, monkeypatch, hungarian):
    root, det, jax_ckpt, port_pth = setup
    grid = json.dumps(GRIDS[hungarian])
    flags = ['--grid', grid] + (['--hungarian'] if hungarian else [])
    common = ['--det_output', str(det), '--data_root', str(root)]
    _run_jax_sweep(monkeypatch, common + ['--ckpt', jax_ckpt,
                                          '--output_dir',
                                          str(tmp_path / 'jax'), *flags])
    got = mot_sweep.main(common + ['--ckpt', port_pth, '--output_dir',
                                   str(tmp_path / 'port'), '--device',
                                   'cpu', *flags])
    want = json.loads((tmp_path / 'jax' / 'sweep_results.json').read_text())
    assert json.loads((tmp_path / 'port' / 'sweep_results.json')
                      .read_text()) == json.loads(json.dumps(got))
    assert got['grid'] == want['grid'] and got['base'] == want['base']
    assert len(got['results']) == len(want['results']) == int(np.prod(
        [len(v) for v in GRIDS[hungarian].values()]))
    motas = []
    for a, b in zip(got['results'], want['results']):
        assert {k: v for k, v in a.items() if k != 'mota'} == \
            {k: v for k, v in b.items() if k != 'mota'}
        assert (a['mota'] is None) == (b['mota'] is None), a['tag']
        if b['mota'] is not None:
            assert abs(a['mota'] - b['mota']) <= MOTA_TOL, a['tag']
            motas.append(b['mota'])
        for seq in SEQS:
            rel = Path(a['tag']) / 'val' / f'{seq}.txt'
            assert (tmp_path / 'port' / rel).read_text() == \
                (tmp_path / 'jax' / rel).read_text(), (rel, hungarian)
    # the sweep ranks distinct values
    assert len(set(np.round(motas, 6))) >= 3
    assert _ranking(got) == _ranking(want)
    assert got['best']['tag'] == want['best']['tag']
    assert got['best'] == {**want['best'], 'mota': got['best']['mota']}


def test_sweep_module_runs(setup, tmp_path):
    root, det, _, port_pth = setup
    res = subprocess.run(
        [sys.executable, '-m', 'jmodt_torch.eval.mot_sweep', '--det_output',
         str(det), '--data_root', str(root), '--ckpt', port_pth,
         '--output_dir', str(tmp_path), '--device', 'cpu', '--grid',
         json.dumps({'cls_thresh': [0.3, 0.5], 't_miss': [2],
                     't_hit': [0]})], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    summary = json.loads((tmp_path / 'sweep_results.json').read_text())
    assert [r['tag'] for r in summary['results']] == ['cfg000', 'cfg001']
    assert summary['best']['mota'] is not None
    assert 'rerun with: python -m jmodt_torch.eval --only_tracking' \
        in res.stderr



@pytest.mark.parametrize('hungarian', [False, True],
                         ids=['mip', 'hungarian'])
def test_rerun_line_keeps_hungarian(setup, tmp_path, caplog, hungarian):
    """The best config's rerun line and sweep_results.json carry the
    assignment the sweep ranked with (`tools/mot_sweep.py` drops
    `--hungarian` from both)."""
    root, det, _, port_pth = setup
    with caplog.at_level(logging.INFO, logger='jmodt_torch.eval.mot_sweep'):
        summary = mot_sweep.main(
            ['--det_output', str(det), '--data_root', str(root), '--ckpt',
             port_pth, '--output_dir', str(tmp_path), '--device', 'cpu',
             '--grid', json.dumps({'cls_thresh': [0.3], 't_miss': [2],
                                   't_hit': [0]})]
            + (['--hungarian'] if hungarian else []))
    saved = json.loads((tmp_path / 'sweep_results.json').read_text())
    assert saved['hungarian'] is summary['hungarian'] is hungarian
    rerun = [r.getMessage() for r in caplog.records
             if 'rerun with' in r.getMessage()]
    assert len(rerun) == 1 and summary['best'] is not None
    flags = rerun[0].split('--only_tracking', 1)[1].split()
    assert ('--hungarian' in flags) == hungarian
    assert flags[:6] == ['--cls_thresh', '0.3', '--t_hit', '0', '--t_miss',
                         '2']
