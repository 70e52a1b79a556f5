"""The port's KITTI data layer against the JAX package's, on the same files
and seeds: calibration, label records, the output writers, the PNG reader
(against PIL), the dataset's samples in EVAL, TEST and TRAIN mode, and the
tracking -> tracking_object converter.  Everything here is host numpy, so
every comparison is exact: arrays bit-equal, files byte-equal.
"""

import dataclasses
import filecmp
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import jmodt_tpu.config as jax_config
from jmodt_tpu.data import converter as jax_converter
from jmodt_tpu.data.kitti_dataset import KittiDataset as JaxKittiDataset
from jmodt_tpu.utils import kitti_io as jax_kitti_io
from jmodt_tpu.utils.calibration import Calibration as JaxCalibration
from jmodt_tpu.utils.object3d import Object3d as JaxObject3d
from jmodt_torch import config as torch_config
from jmodt_torch.data import converter
from jmodt_torch.data.kitti_dataset import KittiDataset
from jmodt_torch.utils import kitti_io, png
from jmodt_torch.utils.calibration import Calibration
from jmodt_torch.utils.object3d import Object3d

# KITTI's calibration with the camera matrices scaled to a third of its
# 375 x 1242 image
_KITTI_CALIB = {
    'P0': '721.5377 0.0 609.5593 0.0 0.0 721.5377 172.854 0.0 0.0 0.0 1.0 0.0',
    'P1': '721.5377 0.0 609.5593 0.0 0.0 721.5377 172.854 0.0 0.0 0.0 1.0 0.0',
    'P2': '721.5377 0.0 609.5593 44.85728 0.0 721.5377 172.854 0.2163791 '
          '0.0 0.0 1.0 0.002745884',
    'P3': '721.5377 0.0 609.5593 -339.5242 0.0 721.5377 172.854 2.199936 '
          '0.0 0.0 1.0 0.002729905'}


def _scaled(row):
    v = np.array(row.split(), np.float64).reshape(3, 4)
    v[:2] /= 3.0
    return ' '.join('%.7g' % x for x in v.ravel())


CALIB_TXT = ''.join(f'{k}: {_scaled(v)}\n' for k, v in _KITTI_CALIB.items()) + (
    'R0_rect: 0.9999239 0.00983776 -0.007445048 -0.0098698 0.9999421 '
    '-0.004278459 0.007402527 0.004351614 0.9999631\n'
    'Tr_velo_to_cam: 0.007533745 -0.9999714 -0.000616602 -0.004069766 '
    '0.01480249 0.0007280733 -0.9998902 -0.07631618 0.9998621 0.00752379 '
    '0.01480755 -0.2717806\n')
IMG_H, IMG_W = 125, 414


def _labels(rng, fr):
    rows = []
    for tid in (1, 2, 3):
        x, z = rng.uniform(-8, 8), rng.uniform(6, 50)
        rows.append(f'{fr} {tid} {"Car" if tid < 3 else "Van"} 0 0 '
                    f'{rng.uniform(-3, 3):.2f} 100 40 200 90 1.5 1.6 3.9 '
                    f'{x:.2f} 1.6 {z:.2f} {rng.uniform(-3, 3):.2f}\n')
    rows.append(f'{fr} -1 DontCare -1 -1 -10 0 0 0 0 -1 -1 -1 -1000 -1000 '
                f'-1000 -10\n')
    return rows


@pytest.fixture(scope='module')
def kitti_tree(tmp_path_factory):
    """A raw KITTI tracking tree: sequences 0000 and 0002 (validation) and
    0001 (training) of 4 frames, KITTI's calibration at a third of its image
    size, PIL-written PNGs
    (with its adaptive row filters) and lidar sweeps whose points fall on
    both sides of the image border and the 40 m split."""
    root = tmp_path_factory.mktemp('kitti') / 'tracking'
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:IMG_H, 0:IMG_W]
    for split, seqs in (('training', ('0000', '0001', '0002')),
                        ('testing', ('0000',))):
        for seq in seqs:
            for sub in ('image_02', 'velodyne'):
                os.makedirs(root / split / sub / seq)
            os.makedirs(root / split / 'calib', exist_ok=True)
            os.makedirs(root / split / 'label_02', exist_ok=True)
            (root / split / 'calib' / f'{seq}.txt').write_text(CALIB_TXT)
            rows = []
            for fr in range(4):
                img = np.stack([(xx * 0.7 + fr * 9) % 256,
                                (yy * 1.3 + xx * 0.1) % 256,
                                rng.randint(0, 256, xx.shape)], -1)
                Image.fromarray(img.astype(np.uint8)).save(
                    root / split / 'image_02' / seq / f'{fr:06d}.png')
                n = 3000
                pts = np.stack([rng.uniform(2, 70, n), rng.uniform(-30, 30, n),
                                rng.uniform(-2.0, 0.5, n), rng.rand(n)],
                               1).astype(np.float32)
                pts.tofile(root / split / 'velodyne' / seq / f'{fr:06d}.bin')
                rows += _labels(rng, fr)
            (root / split / 'label_02' / f'{seq}.txt').write_text(
                ''.join(rows))
    return root


@pytest.fixture(scope='module')
def converted(kitti_tree, tmp_path_factory):
    """The tree converted by both packages: (JAX's root, the port's)."""
    out = {}
    for name, mod in (('jax', jax_converter), ('torch', converter)):
        base = tmp_path_factory.mktemp(f'conv_{name}')
        os.symlink(kitti_tree, base / 'tracking')
        mod.create_train_sample_data(str(kitti_tree),
                                     str(base / 'tracking_object'))
        mod.create_test_sample_data(str(kitti_tree),
                                    str(base / 'tracking_object'),
                                    seq_ids=('0000',))
        out[name] = base
    return out['jax'], out['torch']


# ---------------------------------------------------------------- utils

def test_calibration_matches_jax(tmp_path):
    path = tmp_path / 'calib.txt'
    path.write_text(CALIB_TXT)
    a, b = JaxCalibration(str(path)), Calibration(str(path))
    for k in ('P2', 'R0', 'V2C'):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    rng = np.random.RandomState(0)
    pts = np.stack([rng.uniform(2, 70, 500), rng.uniform(-30, 30, 500),
                    rng.uniform(-2, 1, 500)], 1).astype(np.float32)
    rect_a, rect_b = a.lidar_to_rect(pts), b.lidar_to_rect(pts)
    np.testing.assert_array_equal(rect_a, rect_b)
    for x, y in zip(a.rect_to_img(rect_a), b.rect_to_img(rect_b)):
        np.testing.assert_array_equal(x, y)
    uv, depth = b.rect_to_img(rect_b)
    np.testing.assert_array_equal(a.img_to_rect(uv[:, 0], uv[:, 1], depth),
                                  b.img_to_rect(uv[:, 0], uv[:, 1], depth))
    corners = rng.uniform(-5, 30, (7, 8, 3))
    for x, y in zip(a.corners3d_to_img_boxes(corners),
                    b.corners3d_to_img_boxes(corners)):
        np.testing.assert_array_equal(x, y)


def test_object3d_matches_jax():
    line = ('Car 0 0 -1.50 100.0 100.0 200.0 160.0 '
            '1.50 1.60 3.90 -2.00 1.60 12.00 0.10 7')
    a, b = JaxObject3d(line), Object3d(line)
    assert vars(a).keys() == vars(b).keys()
    for k, v in vars(a).items():
        np.testing.assert_array_equal(v, getattr(b, k))
    assert a.to_kitti_format() == b.to_kitti_format()


def test_kitti_io_writes_the_same_bytes(tmp_path):
    calib = Calibration({'P2': np.array(
        [[720.0, 0, 620, 0], [0, 720.0, 190, 0], [0, 0, 1, 0]], np.float32),
        'R0': np.eye(3, dtype=np.float32),
        'Tr_velo2cam': np.eye(3, 4, dtype=np.float32)})
    rng = np.random.RandomState(1)
    boxes = np.stack([rng.uniform(-10, 10, 12), rng.uniform(1, 2, 12),
                      rng.uniform(3, 60, 12), rng.uniform(1.4, 1.7, 12),
                      rng.uniform(1.5, 1.8, 12), rng.uniform(3.5, 4.5, 12),
                      rng.uniform(-3, 3, 12)], 1).astype(np.float32)
    boxes[0, 2] = 0.5                                  # too wide: dropped
    scores = rng.rand(12).astype(np.float32)
    feats = rng.randn(12, 16).astype(np.float32)
    n = {}
    for name, mod in (('jax', jax_kitti_io), ('torch', kitti_io)):
        for sub in ('txt', 'feat'):
            os.makedirs(tmp_path / name / sub)
        n[name] = mod.save_kitti_detection_format(
            7, calib, boxes, str(tmp_path / name / 'txt'), scores,
            (375, 1242, 3), feats, str(tmp_path / name / 'feat'))
        objs = [Object3d(line) for line in
                (tmp_path / name / 'txt' / '000007.txt').read_text()
                .splitlines()]
        with open(tmp_path / name / 'trk.txt', 'w') as f:
            mod.save_kitti_tracking_format(
                [(i + 3, o, o.score) for i, o in enumerate(objs)], 5, f)
    assert n['jax'] == n['torch'] < 12
    for rel in ('txt/000007.txt', 'feat/000007.npy', 'trk.txt'):
        assert filecmp.cmp(tmp_path / 'jax' / rel, tmp_path / 'torch' / rel,
                           shallow=False), rel


# ---------------------------------------------------------------- PNG

@pytest.mark.parametrize('mode', ['RGB', 'L', 'RGBA'])
def test_png_reads_what_pil_writes(tmp_path, mode):
    rng = np.random.RandomState(2)
    yy, xx = np.mgrid[0:37, 0:53]
    img = np.stack([(xx * 3 + yy) % 256, (xx * yy) % 256,
                    rng.randint(0, 256, xx.shape), (yy * 7) % 256], -1
                   ).astype(np.uint8)
    img = {'RGB': img[..., :3], 'L': img[..., 0], 'RGBA': img}[mode]
    path = str(tmp_path / 'a.png')
    Image.fromarray(img, mode).save(path)
    got = png.read_png(path)
    np.testing.assert_array_equal(got.reshape(img.shape),
                                  np.asarray(Image.open(path)))
    np.testing.assert_array_equal(png.read_png_rgb(path), np.asarray(
        Image.open(path).convert('RGB')))
    assert png.png_size(path) == img.shape[:2]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(img, ftypes):
    """PNG-filter each row of (H, W, C) uint8 with its filter type."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    out = np.zeros((h, 1 + w * c), np.uint8)
    for r, t in enumerate(ftypes):
        left = np.concatenate([np.zeros(c, np.int32), x[r, :-c]])
        up = x[r - 1] if r else np.zeros(w * c, np.int32)
        ul = (np.concatenate([np.zeros(c, np.int32), up[:-c]]))
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, ul)][t]
        out[r, 0] = t
        out[r, 1:] = (x[r] - pred) & 255
    return out


def _png_bytes(h, w, ctype, rows, depth=8, interlace=0, extra=()):
    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype, 0,
                                         0, interlace))
            + b''.join(chunk(k, v) for k, v in extra)
            + chunk(b'IDAT', zlib.compress(rows.tobytes()))
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('ftypes', [(0,) * 9, (1,) * 9, (2,) * 9, (3,) * 9,
                                    (4,) * 9, (4, 3, 2, 1, 0, 1, 3, 4, 2)],
                         ids=['none', 'sub', 'up', 'average', 'paeth',
                              'mixed'])
def test_png_undoes_each_row_filter(tmp_path, ftypes):
    """Rows built by hand with each filter, decoded by the port and by
    PIL."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    img[4:] = np.minimum(img[4:], 40)             # smooth and noisy rows
    path = tmp_path / 'f.png'
    path.write_bytes(_png_bytes(9, 11, 2, _filter_rows(img, ftypes)))
    np.testing.assert_array_equal(png.read_png(str(path)), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_png_writer_round_trips(tmp_path):
    rng = np.random.RandomState(4)
    for shape in ((5, 7), (5, 7, 1), (5, 7, 3), (5, 7, 4)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / 'w.png')
        png.write_png(path, img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(path)).reshape(img.shape), img)
        np.testing.assert_array_equal(png.read_png(path).reshape(img.shape),
                                      img)


@pytest.mark.parametrize('what', ['16-bit', 'palette', 'grey-alpha',
                                  'interlaced', 'not-png'])
def test_png_rejects_what_it_does_not_read(tmp_path, what):
    path = tmp_path / 'bad.png'
    rows = np.zeros((2, 1 + 3 * 3), np.uint8)
    if what == '16-bit':
        path.write_bytes(_png_bytes(2, 3, 2, np.zeros((2, 19), np.uint8),
                                    depth=16))
    elif what == 'palette':
        Image.fromarray(np.zeros((2, 3), np.uint8), 'L').convert('P').save(
            path)
    elif what == 'grey-alpha':
        Image.fromarray(np.zeros((2, 3, 2), np.uint8), 'LA').save(path)
    elif what == 'interlaced':
        path.write_bytes(_png_bytes(2, 3, 2, rows, interlace=1))
    else:
        path.write_bytes(b'GIF89a' + bytes(40))
    with pytest.raises(ValueError):
        png.read_png(str(path))


# ---------------------------------------------------------------- converter

def test_converter_matches_jax(converted):
    jax_root, torch_root = converted
    a, b = jax_root / 'tracking_object', torch_root / 'tracking_object'
    files = sorted(str(p.relative_to(a)) for p in a.rglob('*')
                   if p.is_file())
    assert files == sorted(str(p.relative_to(b)) for p in b.rglob('*')
                           if p.is_file())
    assert 'training/seq2sample.txt' in files
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors
    for base in ('training', 'testing'):
        s2s = os.path.join(b, base, 'seq2sample.txt')
        s2f = os.path.join(b, base, 'sample2frame.txt')
        assert converter.read_seq2sample(s2s) == \
            jax_converter.read_seq2sample(s2s)
        assert converter.read_sample2frame(s2f) == \
            jax_converter.read_sample2frame(s2f)
    assert converter.read_seq2sample(
        os.path.join(b, 'training', 'seq2sample.txt'))['0002'] == [
            '000008', '000009', '000010', '000011']


def test_converter_entry_point(kitti_tree, tmp_path, converted):
    os.symlink(kitti_tree, tmp_path / 'tracking')
    converter.main(['--data_root', str(tmp_path), '--skip_test'])
    ref = converted[1] / 'tracking_object'
    assert not (tmp_path / 'tracking_object' / 'testing').exists()
    for rel in ('training/label_2/000005.txt', 'ImageSets/val.txt',
                'ImageSets/train.txt', 'training/sample2frame.txt'):
        assert filecmp.cmp(tmp_path / 'tracking_object' / rel, ref / rel,
                           shallow=False), rel


# ---------------------------------------------------------------- dataset

def _cfgs(**over):
    jcfg = dataclasses.replace(jax_config.Config(), DTYPE='float32', **over)
    return jcfg, torch_config._merge(torch_config.Config(),
                                     dataclasses.asdict(jcfg))


def _assert_samples_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize('mode,split,npoints,uint8', [
    # of a sweep's ~2300 points in view, ~1300 lie beyond 40 m
    ('EVAL', 'val', 512, True),          # more far points than npoints
    ('EVAL', 'val', 1500, True),         # near points drawn, far ones kept
    ('EVAL', 'val', 4096, False),        # padded by redrawing
    ('TEST', 'test', 1024, True),
])
def test_dataset_samples_match_jax(converted, mode, split, npoints, uint8):
    jax_root, torch_root = converted
    jcfg, tcfg = _cfgs()
    kw = dict(npoints=npoints, split=split, mode=mode, max_gt=8,
              fixed_img_size=(128, 416), raw_uint8_images=uint8, seed=5)
    a = JaxKittiDataset(str(jax_root), cfg=jcfg, use_native=False, **kw)
    b = KittiDataset(str(torch_root), cfg=tcfg, use_native=False, **kw)
    assert a.sample_id_list == b.sample_id_list
    assert len(b) == (8 if split == 'val' else 4)
    for i in range(len(b)):
        _assert_samples_equal(a[i], b[i])
    sid = b.sample_id_list[1]
    assert a.get_image_shape(sid) == b.get_image_shape(sid) == (IMG_H, IMG_W,
                                                                 3)
    _assert_samples_equal(a.collate_batch([a[0], a[1]]),
                          b.collate_batch([b[0], b[1]]))


def test_train_pairs_with_augmentation_match_jax(converted):
    """TRAIN pair mode: the filtered pair list, augmentation (rotation,
    scaling and flip all drawn) and the RPN labels."""
    jax_root, torch_root = converted
    jcfg, tcfg = _cfgs(AUG_DATA=True)
    jcfg = dataclasses.replace(jcfg, RPN=dataclasses.replace(jcfg.RPN,
                                                             FIXED=False))
    tcfg = dataclasses.replace(tcfg, RPN=dataclasses.replace(tcfg.RPN,
                                                             FIXED=False))
    kw = dict(npoints=512, split='train', mode='TRAIN', max_gt=8,
              fixed_img_size=(128, 416), seed=7)
    a = JaxKittiDataset(str(jax_root), cfg=jcfg, use_native=False, **kw)
    b = KittiDataset(str(torch_root), cfg=tcfg, use_native=False, **kw)
    assert a.sample_pair_id_list == b.sample_pair_id_list
    assert len(b) == 3                       # 0001 is the training sequence
    for i in range(len(b)):
        for x, y in zip(a[i], b[i]):
            _assert_samples_equal(x, y)
    batch = b.collate_batch([b[0], b[1]])
    _assert_samples_equal(a.collate_batch([a[0], a[1]]), batch)
    assert batch['pts_input'].shape == (4, 512, 4 if tcfg.RPN.USE_INTENSITY
                                        else 3)
    assert (batch['rpn_cls_label'] == 1).any()
