"""`python -m jmodt_torch.eval` end to end on the CPU, against `tools/eval.py`
on the same KITTI-format tree with the same weights.

The tree is a raw KITTI tracking tree of two validation sequences
(`data/synthetic.py::write_synthetic_kitti_tree`), converted by the port's
converter.  The weights are the small config's, the port's random ones from a seed:
the JAX CLI reads them as its flax checkpoint, the port as a `.pth` of the
same tensors.  Both CLIs run in this process, through their
stage functions.  Both datasets are pinned to their numpy loaders,
whose samples are bit-equal (the C++ loaders round the projection in
float64), and the JAX 3-NN to its Pallas kernel's semantics, as
tests/test_torch_models.py does and explains.

- Stage 1: every frame's `packed` rows within 1e-4 of their scale, keep
  masks and counts exact; the recall counters exact; the AP dict within
  1e-4.
- Stage 2, on the same perfect detections (the gt boxes written as
  stage-1 files): each sequence's tracking txt byte-equal and the CLEAR-MOT
  MOTA equal (1.0) for the host tracker with MIP and Hungarian, the device
  tracker and `--batch_seqs`; the port's `--batch_seqs` output equal to its
  serial `--device_tracker` output.
- A reference-layout `.pth` (`export_model_state`) strict-loads into the
  port and holds the same tensors as the port's own `.pth`.
- The module runs both stages from the command line at `--small --device
  cpu`, with no `--data_root`.
"""

import dataclasses
import importlib.util
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__
from jmodt_torch import config as torch_config
from jmodt_torch.data.converter import create_train_sample_data
from jmodt_torch.data.synthetic import write_synthetic_kitti_tree
from jmodt_torch.eval import __main__ as port_cli
from jmodt_torch.models.point_rcnn import build_detector
from jmodt_torch.train.checkpoint import load_checkpoint
from jmodt_torch.utils.object3d import get_objects_from_label
from jmodt_torch.weights import (export_jax_variables,
                                 jax_variables_to_state_dict,
                                 reference_state_to_state_dict)
from tests.test_torch_models import _three_nn_kernel_semantics

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
SEQS = ('0000', '0002')
N_FRAMES = 4
MODES = {'mip': [], 'hungarian': ['--hungarian'],
         'device': ['--device_tracker'], 'batch': ['--batch_seqs']}

logger = logging.getLogger('torch_eval_cli')
logger.addHandler(logging.NullHandler())


def _jax_cli():
    spec = importlib.util.spec_from_file_location('jax_eval_cli',
                                                  ROOT / 'tools' / 'eval.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs():
    jcfg = dataclasses.replace(__graft_entry__._small_config(),
                               DTYPE='float32')
    return jcfg, torch_config._merge(torch_config.Config(),
                                     dataclasses.asdict(jcfg))


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """(KITTI root, JAX checkpoint, port .pth, reference .pth, variables):
    the weights are the port's from seed 5, as a flax tree."""
    from jmodt_tpu.train.checkpoint import checkpoint_state, save_checkpoint
    from jmodt_tpu.utils.torch_import import export_model_state
    base = tmp_path_factory.mktemp('eval_cli')
    jcfg, tcfg = _cfgs()
    root = base / 'KITTI'
    write_synthetic_kitti_tree(str(root / 'tracking'), tcfg, seq_ids=SEQS,
                               n_frames=N_FRAMES, img_hw=(128, 256),
                               npoints=1024, seed=3)
    create_train_sample_data(str(root / 'tracking'),
                             str(root / 'tracking_object'))
    variables = export_jax_variables(build_detector(tcfg, device='cpu',
                                                    seed=5))
    jax_ckpt = save_checkpoint(checkpoint_state(variables),
                               str(base / 'jax_model'))
    port_pth = str(base / 'port_model.pth')
    torch.save({'epoch': 3, 'it': 12, 'optimizer_state': None,
                'model_state': jax_variables_to_state_dict(variables)},
               port_pth)
    ref_pth = str(base / 'reference_model.pth')
    torch.save({'epoch': 3, 'it': 12, 'model_state': {
        k: torch.from_numpy(np.array(v))
        for k, v in export_model_state(variables).items()}}, ref_pth)
    return root, jax_ckpt, port_pth, ref_pth, variables


def _args(root, out, ckpt, *flags):
    return port_cli.build_parser().parse_args(
        ['--data_root', str(root), '--det_output', str(out / 'det'),
         '--output_dir', str(out), '--ckpt', ckpt, '--small',
         '--device', 'cpu', *flags])


def _recording(module, name, key):
    """Wrap module.<name> (a step factory) so every step output's `key`
    is kept, as numpy."""
    seen = []
    make = getattr(module, name)

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def run(*x):
            out = step(*x)
            seen.append(np.array(out[key][0]))
            return out
        return run
    return wrapped, seen


def test_stage1_matches_jax(setup, tmp_path, monkeypatch):
    import jmodt_tpu.models.pointnet2 as jax_pointnet2
    import jmodt_tpu.native
    import jmodt_torch.native
    root, jax_ckpt, port_pth, _, _ = setup
    jcfg, tcfg = _cfgs()
    jax_cli = _jax_cli()
    # both datasets read with numpy, whose samples are bit-equal
    monkeypatch.setattr(jmodt_tpu.native, 'get_lib', lambda: None)
    monkeypatch.setattr(jmodt_torch.native, 'get_lib', lambda: None)
    monkeypatch.setattr(jax_pointnet2, 'three_nn', _three_nn_kernel_semantics)
    wrapped, seen_j = _recording(jax_cli, 'make_detection_step', 'packed')
    monkeypatch.setattr(jax_cli, 'make_detection_step', wrapped)
    wrapped, seen_t = _recording(port_cli, 'make_detection_step', 'packed')
    monkeypatch.setattr(port_cli, 'make_detection_step', wrapped)
    acc_j = []
    jax_recall = jax_cli.make_recall_fn

    def make_recall_fn(*a, **kw):       # keep the JAX counters for the test
        fn = jax_recall(*a, **kw)
        inner = fn.accumulate
        fn.accumulate = lambda acc, out, gt: acc_j.append(
            inner(acc, out, gt)) or acc_j[-1]
        return fn
    monkeypatch.setattr(jax_cli, 'make_recall_fn', make_recall_fn)
    # the JAX CLI draws frame 0 once before its loop, as the example its
    # model is initialized on, which advances the dataset's sampling draws;
    # the port's needs no example, so the test draws it the same way
    frames_of = port_cli.detection_frames

    def detection_frames(*a):
        ids, frames, dataset = frames_of(*a)
        next(frames())
        return ids, frames, dataset
    monkeypatch.setattr(port_cli, 'detection_frames', detection_frames)

    ap_j = jax_cli.eval_joint_detection(
        _args(root, tmp_path / 'jax', jax_ckpt), jcfg, logger)
    res = port_cli.eval_joint_detection(
        _args(root, tmp_path / 'port', port_pth), tcfg, logger)

    n = len(SEQS) * N_FRAMES
    assert len(seen_j) == len(seen_t) == res['frames'] == n
    kept = 0
    for pj, pt in zip(seen_j, seen_t):
        np.testing.assert_array_equal(pt[:, 8], pj[:, 8])     # keep mask
        k = pj[:, 8] > 0.5
        kept += k.sum()
        scale = max(np.abs(pj[k]).max(initial=0.0), 1.0)
        np.testing.assert_allclose(pt[k], pj[k], rtol=0, atol=TOL * scale)
    assert kept > 0
    np.testing.assert_array_equal(res['recall'], np.asarray(acc_j[-1]))
    assert res['recall'][10] > 0
    assert ap_j.keys() == res['ap'].keys()
    for key in ap_j:
        assert abs(res['ap'][key] - ap_j[key]) <= TOL, key
    for sid in sorted(os.listdir(tmp_path / 'jax' / 'det' / 'txt')):
        a = (tmp_path / 'jax' / 'det' / 'txt' / sid).read_text().split()
        b = (tmp_path / 'port' / 'det' / 'txt' / sid).read_text().split()
        assert len(a) == len(b), sid


def _perfect_detections(root, det, feat_dim):
    """The gt boxes of every converted sample as stage-1 files, with a
    feature per track id plus noise."""
    rng = np.random.RandomState(0)
    ids = rng.randn(64, feat_dim).astype(np.float32)
    labels = root / 'tracking_object' / 'training' / 'label_2'
    os.makedirs(det / 'txt')
    os.makedirs(det / 'feat')
    for name in sorted(os.listdir(labels)):
        objs = [o for o in get_objects_from_label(str(labels / name))
                if o.cls_type == 'Car']
        rows, feats = [], []
        for o in objs:
            rows.append('Car -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
                        '%.4f %.4f %.4f %.4f 0.95\n' % (
                            o.alpha, *o.box2d, o.h, o.w, o.l, *o.pos, o.ry))
            feats.append(ids[int(o.score)] + 0.01 * rng.randn(feat_dim))
        (det / 'txt' / name).write_text(''.join(rows))
        np.save(det / 'feat' / name.replace('.txt', '.npy'),
                np.asarray(feats, np.float32).reshape(-1, feat_dim))


def _tracks(out, seq):
    return (out / 'mot_data' / 'val' / f'{seq}.txt').read_text()


def test_stage2_matches_jax(setup, tmp_path):
    root, jax_ckpt, port_pth, _, _ = setup
    jcfg, tcfg = _cfgs()
    jax_cli = _jax_cli()
    det = tmp_path / 'det'
    _perfect_detections(root, det, tcfg.RCNN.SA_CONFIG.MLPS[-1][-1])
    for mode, flags in MODES.items():
        outs = {}
        for name, cli, cfg, ckpt in (('jax', jax_cli, jcfg, jax_ckpt),
                                     ('port', port_cli, tcfg, port_pth)):
            args = _args(root, tmp_path / name / mode, ckpt, *flags,
                         '--only_tracking')
            args.det_output = str(det)
            outs[name] = cli.eval_tracking(args, cfg, logger)
        assert outs['port']['mota'] == outs['jax'] == pytest.approx(1.0), mode
        assert outs['port']['frames'] == len(SEQS) * N_FRAMES
        for seq in SEQS:
            text = _tracks(tmp_path / 'port' / mode, seq)
            assert text == _tracks(tmp_path / 'jax' / mode, seq), (mode, seq)
            assert len(text.splitlines()) >= 2 * N_FRAMES
    for seq in SEQS:
        assert _tracks(tmp_path / 'port' / 'batch', seq) == \
            _tracks(tmp_path / 'port' / 'device', seq)


def test_reference_pth_strict_loads(setup):
    _, _, port_pth, ref_pth, variables = setup
    _, tcfg = _cfgs()
    want = jax_variables_to_state_dict(variables)
    state = torch.load(ref_pth, weights_only=True)['model_state']
    got = reference_state_to_state_dict(state)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for path in (ref_pth, port_pth):              # the CLI's loader
        model = build_detector(tcfg, device='cpu', seed=1)
        assert load_checkpoint(path, model, strict=True) == (12, 3)
        got = model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match='unrecognized reference key'):
        reference_state_to_state_dict(
            dict(state, **{'rcnn_net.extra.weight': torch.zeros(1)}))


def test_module_runs_both_stages(tmp_path):
    res = subprocess.run(
        [sys.executable, '-m', 'jmodt_torch.eval', '--small', '--device',
         'cpu', '--synthetic_frames', '2', '--cls_thresh', '0.0',
         '--det_output', str(tmp_path / 'det'), '--output_dir',
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert 'total bbox recall' in res.stderr
    assert 'frames per second' in res.stderr
    assert sorted(os.listdir(tmp_path / 'det' / 'txt')) == [
        '000000.txt', '000001.txt']
    assert (tmp_path / 'mot_data' / 'val' / '0000.txt').read_text().strip()
