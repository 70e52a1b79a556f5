"""Hygiene of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points run on the CUDA card unless asked for the CPU,
its kernel wrappers refuse what their kernels do not take, and
`chip_smoke.py` gives no result without a card."""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__
from jmodt_torch import config as torch_config
from jmodt_torch import pipeline, profile_step, weights
from jmodt_torch.models import inference, point_rcnn
from jmodt_torch.models.rcnn import CorrelationHead
from jmodt_torch.ops import (depth_to_space, fused_sa, interpolate, kernels,
                             sa_level, sampling)
from jmodt_torch.tracking import device_tracker

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / 'jmodt_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'jmodt_tpu')


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path}: imports {bad}'


def test_importing_the_port_loads_no_jax():
    mods = sorted('.'.join(p.relative_to(ROOT).with_suffix('').parts)
                  for p in PORT_FILES if p.name != 'chip_smoke.py')
    mods = [m.removesuffix('.__init__') for m in mods]
    code = ('import sys\n' + ''.join(f'import {m}\n' for m in mods)
            + 'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            f'{FORBIDDEN!r})\nprint(bad)\nassert not bad, bad\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


EVAL_SLICE_MODULES = (
    'jmodt_torch.utils.calibration', 'jmodt_torch.utils.object3d',
    'jmodt_torch.utils.png', 'jmodt_torch.utils.kitti_io',
    'jmodt_torch.data.kitti_dataset', 'jmodt_torch.data.converter',
    'jmodt_torch.tracking.kalman', 'jmodt_torch.tracking.track',
    'jmodt_torch.tracking.data_association', 'jmodt_torch.tracking.tracker',
    'jmodt_torch.eval', 'jmodt_torch.eval.detection_ap',
    'jmodt_torch.eval.clear_mot', 'jmodt_torch.eval.__main__')


KITTI_TRAIN_SLICE_MODULES = (
    'jmodt_torch.train.trainer', 'jmodt_torch.train.checkpoint',
    'jmodt_torch.train.__main__', 'jmodt_torch.eval.mot_sweep',
    'jmodt_torch.utils.kitti_utils', 'jmodt_torch.utils.flops')


def _imports_with_jax_blocked(modules, also_blocked=()):
    blocked = FORBIDDEN + ('PIL',) + tuple(also_blocked)
    code = ('import sys\n'
            + ''.join(f'sys.modules[{m!r}] = None\n' for m in blocked)
            + ''.join(f'import {m}\n' for m in modules)
            + 'print("ok")\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and 'ok' in res.stdout, res.stderr


def test_eval_slice_imports_with_jax_blocked():
    """Every module of the evaluation path imports with JAX, flax and the
    JAX package blocked from `sys.modules` (an import of any of them
    raises), and without PIL."""
    _imports_with_jax_blocked(EVAL_SLICE_MODULES)


def test_kitti_train_slice_imports_with_jax_blocked():
    """So do the modules of training from KITTI files, the MOT sweep and
    the host utilities."""
    _imports_with_jax_blocked(KITTI_TRAIN_SLICE_MODULES)


PARALLEL_SLICE_MODULES = (
    'jmodt_torch.parallel', 'jmodt_torch.parallel.mesh',
    'jmodt_torch.train.data_parallel', 'jmodt_torch.pipeline')


def test_parallel_slice_imports_with_jax_blocked():
    """So do data-parallel training and the split lockstep step."""
    _imports_with_jax_blocked(PARALLEL_SLICE_MODULES)


REMAINDER_SLICE_MODULES = (
    'jmodt_torch.native', 'jmodt_torch.tools',
    'jmodt_torch.tools.export_torch_weights', 'jmodt_torch.tools.oracle_ap',
    'jmodt_torch.tools.recall_diagnosis', 'jmodt_torch.tools.ladder_report',
    'jmodt_torch.tools.synthetic_ladder', 'jmodt_torch.tools.viewer',
    'jmodt_torch.models.image_backbone')


def test_remainder_slice_imports_with_jax_blocked():
    """So do the native loader and the tools, the viewer also without
    matplotlib and cv2 (the card's machine has neither); the scan of
    every port file covers both subpackages, and the loader's C++ source
    is the port's own copy."""
    _imports_with_jax_blocked(REMAINDER_SLICE_MODULES,
                              also_blocked=('matplotlib', 'cv2'))
    scanned = {p.relative_to(ROOT).parts[1] for p in PORT_FILES
               if len(p.relative_to(ROOT).parts) > 2}
    assert {'native', 'tools'} <= scanned
    src = (ROOT / 'jmodt_torch' / 'native' / 'src' / 'pointcloud.cpp')
    assert '#include "' not in src.read_text()


def test_tools_need_a_card_unless_asked(monkeypatch, tmp_path):
    from jmodt_torch.tools import synthetic_ladder
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        synthetic_ladder.main(['--out', str(tmp_path / 'ladder')])
    assert not (tmp_path / 'ladder').exists()


def test_data_parallel_needs_a_card_unless_asked(monkeypatch):
    """A rank joins on a card unless it is given the CPU; without a card
    it raises before it joins a group."""
    from jmodt_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mesh.init(0, 1, 'tcp://localhost:1')
    assert not torch.distributed.is_initialized()


def test_eval_needs_a_card_unless_asked(monkeypatch, tmp_path):
    from jmodt_torch.eval import __main__ as eval_main
    from jmodt_torch.eval import detection_ap
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        eval_main.main(['--small', '--det_output', str(tmp_path / 'det'),
                        '--output_dir', str(tmp_path)])
    assert not (tmp_path / 'det').exists()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inference.make_recall_fn()
    box = np.array([[0.0, 0.0, 4.0, 2.0, 0.3]])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        detection_ap.rotate_iou_eval(box, box)
    inference.make_recall_fn(device='cpu')
    assert detection_ap.rotate_iou_eval(box, box, 2, device='cpu')[0, 0] \
        == pytest.approx(8.0)


def test_mot_sweep_needs_a_card_unless_asked(monkeypatch, tmp_path):
    from jmodt_torch.eval import mot_sweep
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mot_sweep.main(['--det_output', str(tmp_path / 'det'),
                        '--data_root', str(tmp_path), '--ckpt',
                        str(tmp_path / 'model.pth'), '--output_dir',
                        str(tmp_path / 'out')])
    assert not (tmp_path / 'out').exists()


def _small_cfg():
    return torch_config._merge(torch_config.Config(), dataclasses.asdict(
        dataclasses.replace(__graft_entry__._small_config(),
                            DTYPE='float32')))


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = _small_cfg()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        point_rcnn.build_detector(cfg)
    model = point_rcnn.build_detector(cfg, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inference.make_detection_step(cfg, model)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        weights.load_jax_variables(model, {'params': {}})
    assert next(model.parameters()).device.type == 'cpu'


def test_tracker_and_joint_step_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = _small_cfg()
    head = CorrelationHead(8, (8,))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        device_tracker.init_state(4, 8)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        device_tracker.make_device_tracker_step(head)
    model = point_rcnn.build_detector(cfg, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pipeline.make_joint_step(cfg, model, head)
    state = device_tracker.init_state(4, 8, device='cpu')
    assert state.mean.device.type == 'cpu'
    device_tracker.make_device_tracker_step(head, device='cpu')
    pipeline.make_joint_step(cfg, model, head, device='cpu')
    assert next(head.parameters()).device.type == 'cpu'


def test_lockstep_and_scan_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = _small_cfg()
    head = CorrelationHead(8, (8,))
    model = point_rcnn.build_detector(cfg, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        device_tracker.init_batched_state(2, 4, 8)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        device_tracker.make_batched_tracker_step(head)
    for make in (pipeline.make_batched_joint_step, pipeline.make_scan_step):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make(cfg, model, head)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pipeline.ScanPipeline(cfg, model, head, 8)
    states = device_tracker.init_batched_state(2, 4, 8, device='cpu')
    assert states.tid.shape == (2, 4) and states.next_id.shape == (2,)
    assert states.mats.f.shape == (10, 10)       # shared by the streams
    pipeline.make_batched_joint_step(cfg, model, head, device='cpu')
    assert pipeline.ScanPipeline(cfg, model, head, 8, device='cpu'
                                 ).state.tid.device.type == 'cpu'


def test_training_needs_a_card_unless_asked(monkeypatch, tmp_path):
    from jmodt_torch.train import __main__ as train_main
    from jmodt_torch.train import train_step, trainer
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = _small_cfg()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        point_rcnn.build_detector(cfg, mode='TRAIN')
    model = point_rcnn.build_detector(cfg, mode='TRAIN', device='cpu')
    opt = train_step.make_optimizer(cfg, model, 4)
    for make in (lambda: train_step.make_train_step(cfg, model, opt),
                 lambda: train_step.make_val_step(cfg, model),
                 lambda: trainer.Trainer(cfg, model, opt, str(tmp_path))):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_main.main(['--small', '--output_dir', str(tmp_path)])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_main.main(['--small', '--data_root', str(tmp_path),
                         '--output_dir', str(tmp_path)])
    train_step.make_train_step(cfg, model, opt, device='cpu')
    trainer.Trainer(cfg, model, opt, str(tmp_path), device='cpu')


def test_build_detector_is_seeded():
    cfg = _small_cfg()
    a = point_rcnn.build_detector(cfg, device='cpu', seed=3).state_dict()
    b = point_rcnn.build_detector(cfg, device='cpu', seed=3).state_dict()
    c = point_rcnn.build_detector(cfg, device='cpu', seed=4).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert all(torch.isfinite(v.float()).all() for v in a.values())


def test_kernel_wrapper_checks():
    with pytest.raises(ValueError, match='CUDA tensor'):
        kernels.check_cuda('x', torch.zeros(2, 3), torch.float32, (2, 3))
    t = torch.arange(12.0).reshape(4, 3)
    # a CPU tensor never reaches the kernel library: plain versions run
    assert sampling.farthest_point_sample(t[None], 2).tolist() == [[0, 3]]
    d, i = interpolate.three_nn(t[None], t[None])
    assert i.shape == (1, 4, 3) and d.shape == (1, 4, 3)
    out = fused_sa.grouped_gather_mlp_max(
        torch.ones(1, 4, 2), torch.zeros(1, 3, 4, dtype=torch.int32),
        torch.zeros(1, 3, 2), torch.zeros(2),
        [(torch.eye(2), torch.zeros(2))])
    assert torch.equal(out, torch.ones(1, 3, 2))


def _k5_args():
    """A valid two-scale level: N=64, C=5, M=16, S 8 and 16."""
    layers = [((torch.zeros(8, 16), torch.zeros(16)),
               (torch.zeros(16, 32), torch.zeros(32)))] * 2
    return dict(xyz=torch.zeros(2, 64, 3), feats=torch.zeros(2, 64, 5),
                npoint=16, radii=(0.5, 1.0), nsamples=(8, 16),
                folded_per_scale=layers)


@pytest.mark.parametrize('bad,match', [
    (dict(xyz=torch.zeros(2, 64, 3, dtype=torch.float64)), 'float32'),
    (dict(feats=torch.zeros(2, 5, 64).transpose(1, 2)), 'contiguous'),
    (dict(feats=torch.zeros(2, 63, 5)), 'shape'),
    (dict(nsamples=(8, 6)), 'nsample'),
    (dict(npoint=65), 'npoint'),
    (dict(radii=(0.5,) * 5, nsamples=(8,) * 5), 'scales'),
    (dict(folded_per_scale=[((torch.zeros(7, 16), torch.zeros(16)),
                             (torch.zeros(16, 32), torch.zeros(32)))] * 2),
     'shape'),
    (dict(folded_per_scale=[((torch.zeros(8, 16), torch.zeros(16)),)] * 2),
     'layers'),
])
def test_k5_wrapper_checks(bad, match):
    """K5's wrapper refuses what its CUDA entry does not take (the checks
    run on CPU tensors here, without the device check), and a CPU tensor
    never reaches the kernel library."""
    args = _k5_args()
    assert len(sa_level._k5_plan(**args, check=kernels.check_layout)) == 2
    with pytest.raises(ValueError, match=match):
        sa_level._k5_plan(**(args | bad), check=kernels.check_layout)
    with pytest.raises(ValueError, match='CUDA tensor'):
        sa_level._k5_plan(**args)
    new_xyz, pooled, idx = sa_level.sa_level_fused(**args)
    assert pooled.shape == (2, 16, 64) and idx.dtype == torch.int32


def _k6_args():
    k, r, h0, w0 = 4, 16, 3, 5
    return dict(taps=torch.zeros(2, h0 * w0, k * k * r), k=k, r=r, h0=h0,
                w0=w0, bias=torch.zeros(r))


@pytest.mark.parametrize('bad,match', [
    (dict(taps=torch.zeros(2, 15, 256, dtype=torch.float64)), 'bfloat16'),
    (dict(taps=torch.zeros(2, 16, 256)), 'shape'),
    (dict(taps=torch.zeros(2, 256, 15).transpose(1, 2)), 'contiguous'),
    (dict(bias=torch.zeros(16, dtype=torch.bfloat16)), 'float32'),
    (dict(bias=torch.zeros(8)), 'shape'),
    (dict(k=0), 'k=0'),
    (dict(k=1, r=3, taps=torch.zeros(2, 15, 3), bias=torch.zeros(3)),
     'multiple of 4'),
    (dict(taps=torch.zeros(2 * 15 * 256 + 1)[1:].view(2, 15, 256)),
     'aligned'),
])
def test_k6_wrapper_checks(bad, match):
    """K6's wrapper refuses what its CUDA entry does not take (checked on
    CPU tensors here, without the device check)."""
    args = _k6_args()
    depth_to_space._check(**args, check=kernels.check_layout)
    with pytest.raises(ValueError, match=match):
        depth_to_space._check(**(args | bad), check=kernels.check_layout)
    with pytest.raises(ValueError, match='CUDA tensor'):
        depth_to_space._check(**args)


def test_k5_fits_the_main_path():
    """Every MEGA_SA level of the default config (RPN levels 1-3) passes
    K5's checks."""
    cfg = torch_config.Config()
    sa = cfg.RPN.SA_CONFIG
    n, cin = cfg.RPN.NUM_POINTS, 0
    for k in range(4):
        cout = sum(m[-1] for m in sa.MLPS[k])
        if k > 0:
            layers = []
            for mlp in sa.MLPS[k]:
                widths = [3 + cin, *mlp]
                layers.append([(torch.zeros(a, b), torch.zeros(b))
                               for a, b in zip(widths[:-1], widths[1:])])
            plan = sa_level._k5_plan(
                torch.zeros(1, n, 3), torch.zeros(1, n, cin),
                sa.NPOINTS[k], sa.RADIUS[k], sa.NSAMPLE[k], layers,
                check=kernels.check_layout)
            assert [w[-1] for w in plan] == [m[-1] for m in sa.MLPS[k]]
        n, cin = sa.NPOINTS[k], cout


def test_k4_shared_memory_fits_the_main_path():
    """Every K4 call of the default config's main path fits in the 227 KB
    a block can use (RPN levels 1-3 and RCNN sa_0 / sa_1)."""
    cfg = torch_config.Config()
    sa = cfg.RPN.SA_CONFIG
    for k in (1, 2, 3):
        for mlp, s in zip(sa.MLPS[k], sa.NSAMPLE[k]):
            assert fused_sa._k4_smem_bytes(s, list(mlp)) <= 232448
    for mlp, s in zip(cfg.RCNN.SA_CONFIG.MLPS[:2], cfg.RCNN.SA_CONFIG.NSAMPLE):
        assert fused_sa._k4_smem_bytes(s, list(mlp)) <= 232448


def test_kernel_library_name_follows_the_sources():
    path = kernels.library_path()
    assert path.parent == ROOT / 'build'
    assert path.name.startswith('libjmodt_kernels_')
    assert path == kernels.library_path()


def test_chip_smoke_gives_no_result_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    # alone, without the rest of the repository
    shutil.copy(ROOT / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_synthetic_frame_shapes():
    from jmodt_torch.data.synthetic import make_eval_frame
    cfg = _small_cfg()
    f = make_eval_frame(0, cfg, img_hw=(32, 64), raw_u8=True)
    assert f['pts_input'].shape == (1, cfg.RPN.NUM_POINTS, 3)
    assert f['img'].shape == (1, 32, 64, 3) and f['img'].dtype == np.uint8
    assert f['pts_xy'].shape == (1, cfg.RPN.NUM_POINTS, 2)
    assert np.abs(f['pts_xy']).max() <= 1.0


@pytest.mark.parametrize('spans,length', [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (3.0, 4.0)], 3.0),             # disjoint
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),             # one inside another
    ([(2.0, 5.0), (0.0, 3.0), (4.0, 6.0)], 6.0),  # overlapping, unsorted
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),             # touching
])
def test_profile_union_of_kernel_intervals(spans, length):
    """profile_step's device time counts overlapping kernels (K5's two
    grids) once: the length of the union of their intervals."""
    assert profile_step.union_length(spans) == length
