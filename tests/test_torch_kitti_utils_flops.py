"""`jmodt_torch.utils.kitti_utils` and `jmodt_torch.utils.flops` against the
JAX package's on the same inputs and configs.

- `in_hull`: exactly the JAX mask, on seeded boxes and points inside,
  outside, at the corners and just within and beyond them.
- `get_iou3d`: within 1e-6 of the JAX one on seeded boxes (overlapping,
  nested, disjoint and identical pairs).
- The re-exported geometry helpers agree with the JAX package's
  (bit-equal for the numpy ones, 1e-6 for the tensor ones).
- `detection_flops`: every term equal to the JAX one, integer for
  integer, at `Config()`, the small config, lidar-only, and with `rois`
  and the tracker's arguments.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import jmodt_tpu.config as jax_config
from jmodt_tpu.utils import flops as jax_flops
from jmodt_tpu.utils import kitti_utils as jax_ku
from jmodt_torch import config as torch_config
from jmodt_torch.utils import flops, kitti_utils

R = dataclasses.replace


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(-3, 3, n)
    b[:, 1] = rng.uniform(1.0, 2.0, n)
    b[:, 2] = rng.uniform(5, 11, n)
    b[:, 3:6] = rng.uniform(1.0, 4.5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _corners(boxes):
    return kitti_utils.boxes3d_to_corners3d(torch.from_numpy(boxes)).numpy()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_in_hull_equals_jax(seed):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, 6)
    corners = _corners(boxes)
    for box, c in zip(boxes, corners):
        centre = c.mean(0)
        pts = np.concatenate([
            box[None, :3] + rng.uniform(-3, 3, (400, 3)),   # in and out
            c,                                  # the corners, on the hull
            centre + 0.98 * (c - centre),       # just inside
            centre + 1.02 * (c - centre)]).astype(np.float32)   # outside
        got = kitti_utils.in_hull(pts, c)
        np.testing.assert_array_equal(got, jax_ku.in_hull(pts, c))
        assert got[:400].any() and not got[:400].all()
        assert got[408:416].all() and not got[416:].any()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_get_iou3d_matches_jax(seed):
    rng = np.random.RandomState(seed)
    a = _boxes(rng, 7)
    b = np.concatenate([_boxes(rng, 5), a[:2],
                        a[2:4] + [0.3, 0.1, 0.2, 0, 0, 0, 0.2],
                        a[4:5] * [1, 1, 1, 0.5, 0.5, 0.5, 1]]
                       ).astype(np.float32)
    ca, cb = _corners(a), _corners(b)
    got = kitti_utils.get_iou3d(ca, cb)
    want = jax_ku.get_iou3d(ca, cb)
    assert got.shape == want.shape == (7, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.diag(got[:2, 5:7]), 1.0, atol=1e-5)
    assert (got > 0).sum() >= 5 and (got == 0).any()


def test_reexported_helpers_match_jax():
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 5)
    pts = rng.uniform(-5, 5, (300, 4)).astype(np.float32)
    np.testing.assert_array_equal(kitti_utils.rotate_pc_along_y(pts, 0.7),
                                  jax_ku.rotate_pc_along_y(pts, 0.7))
    for box in boxes:
        np.testing.assert_array_equal(
            kitti_utils.in_box3d_mask(pts[:, :3], box, 0.2),
            jax_ku.in_box3d_mask(pts[:, :3], box, 0.2))
    tb = torch.from_numpy(boxes)
    for name, args in (('boxes3d_to_corners3d', ()), ('boxes3d_to_bev', ()),
                       ('enlarge_box3d', (0.3,))):
        got = getattr(kitti_utils, name)(tb, *args).numpy()
        want = np.asarray(getattr(jax_ku, name)(jnp.asarray(boxes), *args))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)
    cloud = rng.uniform(-5, 5, (5, 30, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, 5).astype(np.float32)
    np.testing.assert_allclose(
        kitti_utils.rotate_points_along_y(torch.from_numpy(cloud),
                                          torch.from_numpy(ang)).numpy(),
        np.asarray(jax_ku.rotate_points_along_y(jnp.asarray(cloud),
                                                jnp.asarray(ang))),
        rtol=0, atol=1e-5)


def _configs():
    small = __graft_entry__._small_config()
    full = jax_config.Config()
    return {'config': full, 'small': small,
            'lidar_only': R(full, LI_FUSION=R(full.LI_FUSION,
                                              ENABLED=False)),
            'small_lidar_only': R(small, LI_FUSION=R(small.LI_FUSION,
                                                     ENABLED=False))}


@pytest.mark.parametrize('name', sorted(_configs()))
@pytest.mark.parametrize('kw', [
    {},
    dict(rois=64, roi_points=256),
    dict(image_hw=(128, 416), npoints=4096, track_k=16, max_tracks=64),
    dict(rois=100, track_k=8, max_tracks=32, feat_dim=128),
], ids=['defaults', 'rois', 'tracker', 'rois_tracker'])
def test_detection_flops_equal_jax(name, kw):
    jcfg = _configs()[name]
    tcfg = torch_config._merge(torch_config.Config(), dataclasses.asdict(jcfg))
    got = flops.detection_flops(tcfg, **kw)
    want = jax_flops.detection_flops(jcfg, **kw)
    assert got == want
    assert all(v == int(v) and v >= 0 for v in got.values())
    assert ('image_cnn' in got) == jcfg.LI_FUSION.ENABLED
    assert ('tracker' in got) == bool(kw.get('track_k'))
    assert got['total'] == sum(v for k, v in got.items() if k != 'total')
