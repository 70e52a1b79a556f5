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
from jmodt_torch.models import inference, point_rcnn
from jmodt_torch.ops import fused_sa, interpolate, kernels, sampling
from jmodt_torch import weights

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
