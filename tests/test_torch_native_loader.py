"""The port's native point-cloud loader (`jmodt_torch/native`) against the
JAX package's (`jmodt_tpu/native`) and against the port's numpy path.

- The same C++ source built with the same flags: `load_velodyne` and
  `project_and_filter` bit-equal to `jmodt_tpu.native`'s, and a
  `KittiDataset` sample read natively bit-equal to the JAX package's
  native sample with the same seed.
- Against the numpy path (`use_native=False`): within rtol 2e-4 / atol
  1e-3, the gate of `tests/test_native_loader.py`, a point on a filter's
  edge excepted.
- Two processes building a fresh build directory at once leave one whole
  library, which both load; no temporary file is left.
- Without a compiler `get_lib` warns and returns None, and the dataset
  reads with numpy.
- `native.loads` counts the frames the library read.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from jmodt_tpu import native as jax_native
from jmodt_tpu.config import Config as JaxConfig
from jmodt_tpu.data.kitti_dataset import KittiDataset as JaxKittiDataset
from jmodt_torch import native
from jmodt_torch.config import Config
from jmodt_torch.data import converter
from jmodt_torch.data.kitti_dataset import KittiDataset
from jmodt_torch.utils.calibration import Calibration
from jmodt_torch.utils.png import write_png
from tests.test_data_layer import CALIB_TXT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCOPE = ((-40.0, 40.0), (-1.0, 3.0), (0.0, 70.4))
IMG_SHAPE = (375, 1242, 3)
FRAMES = 3


def _sweep(rng, n=20000):
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.uniform(1, 90, n)          # x forward
    pts[:, 1] = rng.uniform(-40, 40, n)
    pts[:, 2] = rng.uniform(-3, 2, n)
    pts[:, 3] = rng.rand(n)
    return pts


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    """The port's library, and the JAX package's built from its own source
    with its own flags into a temporary directory: its `get_lib` builds
    into its package directory, which other test processes may be reading
    meanwhile."""
    path = tmp_path_factory.mktemp('jax_native') / 'libjmodt_native.so'
    subprocess.run(['g++', '-O3', '-shared', '-fPIC', '-std=c++17', '-o',
                    str(path), jax_native._SRC], check=True,
                   capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, '_LIB_PATH', str(path))
        mp.setattr(jax_native, '_lib', None)
        mp.setattr(jax_native, '_build_failed', False)
        assert jax_native.get_lib() is not None
        assert native.get_lib() is not None
        yield native.get_lib()


@pytest.fixture(scope='module')
def kitti_root(tmp_path_factory):
    """A raw KITTI tracking tree (validation sequence 0000, KITTI's
    calibration and image size, sweeps reaching past the image and the
    range scope), converted by the port's converter."""
    base = tmp_path_factory.mktemp('native_kitti')
    raw = base / 'tracking' / 'training'
    rng = np.random.RandomState(0)
    for sub in ('image_02/0000', 'velodyne/0000', 'calib', 'label_02'):
        os.makedirs(raw / sub)
    (raw / 'calib' / '0000.txt').write_text(CALIB_TXT)
    rows = []
    for fr in range(FRAMES):
        write_png(str(raw / 'image_02' / '0000' / f'{fr:06d}.png'),
                  rng.randint(0, 256, IMG_SHAPE).astype(np.uint8))
        _sweep(rng).tofile(raw / 'velodyne' / '0000' / f'{fr:06d}.bin')
        rows.append(f'{fr} 0 Car 0 0 0.1 100 120 300 250 1.5 1.6 3.9 '
                    f'{rng.uniform(-5, 5):.2f} 1.6 {rng.uniform(8, 30):.2f} '
                    '0.3\n')
    (raw / 'label_02' / '0000.txt').write_text(''.join(rows))
    converter.create_train_sample_data(str(base / 'tracking'),
                                       str(base / 'tracking_object'))
    return base


def _calib(tmp_path):
    path = tmp_path / 'calib.txt'
    path.write_text(CALIB_TXT)
    return Calibration(str(path))


def test_load_velodyne_matches_jax(lib, tmp_path):
    pts = _sweep(np.random.RandomState(1), 5000)
    path = str(tmp_path / 'f.bin')
    pts.tofile(path)
    before = native.loads['load_velodyne']
    got = native.load_velodyne(path)
    np.testing.assert_array_equal(got, pts)
    np.testing.assert_array_equal(got, jax_native.load_velodyne(path))
    assert native.loads['load_velodyne'] == before + 1
    with pytest.raises(FileNotFoundError):
        native.load_velodyne(str(tmp_path / 'missing.bin'))


@pytest.mark.parametrize('scope', [None, SCOPE])
def test_project_and_filter_matches_jax(lib, tmp_path, scope):
    calib = _calib(tmp_path)
    pts = _sweep(np.random.RandomState(2))
    got = native.project_and_filter(pts, calib.V2C, calib.R0, calib.P2,
                                    IMG_SHAPE, scope=scope)
    want = jax_native.project_and_filter(pts, calib.V2C, calib.R0, calib.P2,
                                         IMG_SHAPE, scope=scope)
    assert 1000 < len(got[0]) < len(pts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_project_and_filter_matches_numpy(lib, tmp_path):
    """Against calibration.py's float32 numpy projection and the dataset's
    filter: the points that both keep agree within rtol 2e-4; at most 3
    points on a filter's edge differ."""
    calib = _calib(tmp_path)
    pts = _sweep(np.random.RandomState(3))
    pts_rect = calib.lidar_to_rect(pts[:, 0:3])
    pts_img, pts_depth = calib.rect_to_img(pts_rect)
    flag = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < IMG_SHAPE[1])
            & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < IMG_SHAPE[0])
            & (pts_depth >= 0))
    for axis, (lo, hi) in enumerate(SCOPE):
        flag &= (pts_rect[:, axis] >= lo) & (pts_rect[:, axis] <= hi)
    rect, inten, uv = native.project_and_filter(
        pts, calib.V2C, calib.R0, calib.P2, IMG_SHAPE, scope=SCOPE)
    assert abs(len(rect) - int(flag.sum())) <= 3
    want = {float(k): (r, u) for k, r, u in zip(pts[flag, 3], pts_rect[flag],
                                                pts_img[flag])}
    common = 0
    for k, r, u in zip(inten, rect, uv):
        if float(k) in want:
            np.testing.assert_allclose(r, want[float(k)][0], rtol=2e-4,
                                       atol=1e-3)
            np.testing.assert_allclose(u, want[float(k)][1], rtol=2e-4,
                                       atol=1e-2)
            common += 1
    assert common >= min(len(rect), int(flag.sum())) - 3


def _dataset_kw(npoints):
    return dict(npoints=npoints, split='val', mode='EVAL', max_gt=8,
                fixed_img_size=(384, 1280), seed=7)


@pytest.mark.parametrize('npoints', [2048, 16384])
def test_dataset_native_matches_jax_native(lib, kitti_root, npoints):
    """Default loaders of both packages (native): bit-equal samples."""
    a = JaxKittiDataset(str(kitti_root), cfg=JaxConfig(), use_native=True,
                        **_dataset_kw(npoints))
    b = KittiDataset(str(kitti_root), cfg=Config(), **_dataset_kw(npoints))
    assert b.use_native and a.sample_id_list == b.sample_id_list
    before = native.loads['project_and_filter']
    for i in range(len(b)):
        x, y = a[i], b[i]
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(y[k], x[k], err_msg=k)
    assert native.loads['project_and_filter'] == before + len(b) == \
        before + FRAMES


def test_dataset_native_matches_numpy(lib, kitti_root):
    """Each package's own gate between its loaders (rtol 2e-4, atol
    1e-3), at npoints below the points in view so both draw the same
    rows."""
    kw = _dataset_kw(1024)
    a = KittiDataset(str(kitti_root), cfg=Config(), **kw)
    b = KittiDataset(str(kitti_root), cfg=Config(), use_native=False, **kw)
    for i in range(len(a)):
        x, y = a[i], b[i]
        np.testing.assert_allclose(x['pts_input'], y['pts_input'],
                                   rtol=2e-4, atol=1e-3)
        np.testing.assert_allclose(x['pts_xy'], y['pts_xy'], atol=1e-3)


_BUILD_ONE = """
import sys
from pathlib import Path
import numpy as np
import jmodt_torch.native as native
native._BUILD = Path(sys.argv[1])
lib = native.get_lib()
assert lib is not None
pts = np.arange(16, dtype=np.float32).reshape(4, 4)
path = Path(sys.argv[1]).parent / (sys.argv[2] + '.bin')
pts.tofile(path)
assert (native.load_velodyne(str(path)) == pts).all()
print(native.library_path().name)
"""


def test_two_processes_building_at_once(lib, tmp_path):
    build = tmp_path / 'build'
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, '-c', _BUILD_ONE, str(build),
                               f'p{i}'], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names = {o[0].strip() for o in outs}
    assert names == {native.library_path().name}
    assert sorted(os.listdir(build)) == sorted(names)


def test_without_a_compiler_the_dataset_reads_numpy(kitti_root, monkeypatch,
                                                    caplog):
    def no_gxx(*a, **kw):
        raise FileNotFoundError('g++')

    monkeypatch.setattr(native, '_lib', [])
    monkeypatch.setattr(native, '_failed', [])
    monkeypatch.setattr(native, 'library_path',
                        lambda: native._BUILD / 'libjmodt_native_absent.so')
    monkeypatch.setattr(native.subprocess, 'run', no_gxx)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.get_lib() is None
    assert 'numpy fallback' in caplog.text
    kw = _dataset_kw(1024)
    got = KittiDataset(str(kitti_root), cfg=Config(), **kw)[0]
    want = KittiDataset(str(kitti_root), cfg=Config(), use_native=False,
                        **kw)[0]
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
