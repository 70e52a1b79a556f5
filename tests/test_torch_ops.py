"""The port's point and box operators (jmodt_torch/ops) against the JAX
package's, on the CPU.

Inputs come from numpy seeds and go through both packages.  Where the JAX
function is a Pallas kernel it runs in interpret mode, as the JAX package's
own tests run it; on a CPU tensor every port wrapper takes its plain
version, which `chip_smoke.py` holds against the CUDA kernel on the card.

Tolerances: index outputs and masks are exact.  Float outputs of the same
arithmetic in another order (matmul blocking, fused multiply-adds in XLA's
CPU code) are held to 1e-5 relative; the MLP chains of K4 to 1e-4
relative to the output's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmodt_tpu.models.bbox_codec import decode_bbox_target as jax_decode
from jmodt_tpu.ops import grouping as jax_grouping
from jmodt_tpu.ops import nms as jax_nms
from jmodt_tpu.ops import rotated_iou as jax_iou
from jmodt_tpu.ops.fused_sa import fused_sa_eval as jax_fused_sa_eval
from jmodt_tpu.ops.pallas.fps import (farthest_point_sample_batched_pallas,
                                      farthest_point_sample_pallas)
from jmodt_tpu.ops.pallas.grouped_gather_mlp import \
    grouped_gather_mlp_max as jax_ggmm
from jmodt_tpu.ops.pallas.three_nn import three_nn_pallas
from jmodt_tpu.ops.roipool3d import roipool3d as jax_roipool3d
from jmodt_torch.models.bbox_codec import decode_bbox_target
from jmodt_torch.ops import grouping, interpolate, nms, rotated_iou, sampling
from jmodt_torch.ops.fused_sa import (fused_sa_eval,
                                      grouped_gather_mlp_max,
                                      grouped_gather_mlp_max_plain)
from jmodt_torch.ops.roipool3d import roipool3d


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cloud(rng, b, n):
    """KITTI-scale points: x in [-30, 30], y in [-1, 3], z in [0, 70]."""
    lo = np.array([-30.0, -1.0, 0.0], np.float32)
    span = np.array([60.0, 4.0, 70.0], np.float32)
    return (rng.rand(b, n, 3).astype(np.float32) * span + lo)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# ---------------------------------------------------------------- FPS (K1/K2)

@pytest.mark.parametrize('n,npoint', [(256, 64), (512, 128)])
def test_fps_matches_pallas_kernel(n, npoint):
    xyz = _cloud(np.random.RandomState(n), 1, n)
    want = np.asarray(farthest_point_sample_pallas(xyz, npoint,
                                                   interpret=True))
    got = sampling.farthest_point_sample(_t(xyz), npoint)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('b,n,npoint', [(5, 128, 32), (3, 512, 128)])
def test_fps_batched_matches_pallas_kernel(b, n, npoint):
    xyz = np.random.RandomState(b).randn(b, n, 3).astype(np.float32) * 2
    want = np.asarray(farthest_point_sample_batched_pallas(
        xyz, npoint, interpret=True))
    got = sampling.farthest_point_sample(_t(xyz), npoint)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_ties_take_lowest_index():
    """Duplicated points tie on every distance: the first index wins."""
    base = np.random.RandomState(0).randn(32, 3).astype(np.float32)
    xyz = np.concatenate([base, base])[None]              # (1, 64, 3)
    got = sampling.farthest_point_sample(_t(xyz), 40).numpy()[0]
    want = np.asarray(farthest_point_sample_pallas(
        np.pad(xyz, ((0, 0), (0, 64), (0, 0)), mode='edge'), 40,
        interpret=True))[0]
    np.testing.assert_array_equal(got, want)
    assert (got[:32] < 32).all()


def test_gather_xyz():
    xyz = np.random.RandomState(1).randn(2, 50, 3).astype(np.float32)
    idx = np.random.RandomState(2).randint(0, 50, (2, 7)).astype(np.int32)
    got = sampling.gather_xyz(_t(xyz), _t(idx)).numpy()
    np.testing.assert_array_equal(got, np.take_along_axis(
        xyz, idx[:, :, None], axis=1))


# --------------------------------------------------------------- 3-NN (K3)

@pytest.mark.parametrize('n,m', [(256, 100), (512, 64), (128, 256)])
def test_three_nn_matches_pallas_kernel(n, m):
    rng = np.random.RandomState(n + m)
    u, k = _cloud(rng, 2, n), _cloud(rng, 2, m)
    # a few exact coincidences and duplicated known points (ties)
    u[:, :8] = k[:, :8]
    k[:, 20:24] = k[:, 10:14]
    d_want, i_want = three_nn_pallas(u, k, interpret=True)
    d_got, i_got = interpolate.three_nn(_t(u), _t(k))
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want),
                               rtol=1e-5, atol=1e-6)


def test_three_interpolate_fl():
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 20, 5).astype(np.float32)
    idx = rng.randint(0, 20, (2, 30, 3)).astype(np.int32)
    w = rng.rand(2, 30, 3).astype(np.float32)
    got = interpolate.three_interpolate_fl(_t(feats), _t(idx), _t(w))
    gathered = np.take_along_axis(feats, idx.reshape(2, 90, 1), axis=1)
    want = (gathered.reshape(2, 30, 3, 5) * w[..., None]).sum(2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------- grouped gather-MLP-max (K4)

def _k4_inputs(seed, b, n, m, s, widths):
    rng = np.random.RandomState(seed)
    feats1 = rng.randn(b, n, widths[0]).astype(np.float32)
    idx = rng.randint(0, n, (b, m, s)).astype(np.int32)
    cxw = rng.randn(b, m, widths[0]).astype(np.float32) * 0.5
    b1 = rng.randn(widths[0]).astype(np.float32) * 0.1
    layers = [((rng.randn(ci, co) / np.sqrt(ci)).astype(np.float32),
               (rng.randn(co) * 0.1).astype(np.float32))
              for ci, co in zip(widths[:-1], widths[1:])]
    return feats1, idx, cxw, b1, layers


@pytest.mark.parametrize('b,n,m,s,widths', [
    (2, 256, 128, 64, (32, 32, 48)),       # RCNN-like tile, S = 64
    (1, 512, 64, 16, (24, 40, 36)),        # backbone-like, S = 16
])
def test_grouped_gather_mlp_max_matches_pallas_kernel(b, n, m, s, widths):
    feats1, idx, cxw, b1, layers = _k4_inputs(0, b, n, m, s, widths)
    want = np.asarray(jax_ggmm(feats1, idx, cxw, b1,
                               tuple((w, bb) for w, bb in layers),
                               interpret=True))
    t_layers = [(_t(w), _t(bb)) for w, bb in layers]
    got = grouped_gather_mlp_max(_t(feats1), _t(idx), _t(cxw), _t(b1),
                                 t_layers)
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) < 1e-4
    plain = grouped_gather_mlp_max_plain(_t(feats1), _t(idx), _t(cxw),
                                         _t(b1), t_layers)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_fused_sa_eval_matches_xla_form():
    rng = np.random.RandomState(4)
    b, n, m, s, c = 2, 96, 24, 8, 10
    xyz = rng.randn(b, n, 3).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32)
    new_xyz = xyz[:, :m]
    idx = rng.randint(0, n, (b, m, s)).astype(np.int32)
    widths = (3 + c, 16, 16, 24)
    layers = [((rng.randn(ci, co) / np.sqrt(ci)).astype(np.float32),
               (rng.randn(co) * 0.1).astype(np.float32))
              for ci, co in zip(widths[:-1], widths[1:])]
    want = np.asarray(jax_fused_sa_eval(xyz, feats, new_xyz, idx,
                                        [(jnp.asarray(w), jnp.asarray(bb))
                                         for w, bb in layers],
                                        use_pallas=False))
    got = fused_sa_eval(_t(xyz), _t(feats), _t(new_xyz), _t(idx),
                        [(_t(w), _t(bb)) for w, bb in layers])
    assert _rel_err(got.numpy(), want) < 1e-4


# ------------------------------------------------------------- ball query

@pytest.mark.parametrize('radius,nsample', [(0.5, 8), (2.0, 16), (4.0, 32)])
def test_ball_query_matches_jax(radius, nsample):
    rng = np.random.RandomState(int(radius * 10))
    xyz = _cloud(rng, 2, 512)
    # dense clusters so that balls fill and the r^2 boundary is crowded
    xyz[:, :256] = xyz[:, :1] + rng.randn(2, 256, 3).astype(np.float32)
    new_xyz = xyz[:, ::8].copy()
    want = np.asarray(jax_grouping.ball_query(radius, nsample, xyz, new_xyz))
    got = grouping.ball_query(radius, nsample, _t(xyz), _t(new_xyz))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ball_query_multi_matches_jax():
    rng = np.random.RandomState(7)
    xyz = _cloud(rng, 1, 1024)
    xyz[:, :512] = xyz[:, :1] + rng.randn(1, 512, 3).astype(np.float32) * 0.3
    new_xyz = xyz[:, ::4].copy()
    want = jax_grouping.ball_query_multi((0.1, 0.5), (16, 32), xyz, new_xyz)
    got = grouping.ball_query_multi((0.1, 0.5), (16, 32), _t(xyz),
                                    _t(new_xyz))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_group_points_fl():
    rng = np.random.RandomState(8)
    feats = rng.randn(2, 40, 6).astype(np.float32)
    idx = rng.randint(0, 40, (2, 5, 4)).astype(np.int32)
    got = grouping.group_points_fl(_t(feats), _t(idx)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_grouping.group_points_fl(feats, idx)))


# --------------------------------------------------------- boxes, IoU, NMS

def _boxes3d(rng, n, spread=8.0):
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(-spread, spread, n)
    b[:, 1] = rng.uniform(1.4, 1.8, n)
    b[:, 2] = rng.uniform(10, 10 + 2 * spread, n)
    b[:, 3:6] = np.array([1.5, 1.6, 3.9], np.float32) * rng.uniform(
        0.8, 1.2, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _bev(b):
    return np.stack([b[:, 0] - b[:, 5] / 2, b[:, 2] - b[:, 4] / 2,
                     b[:, 0] + b[:, 5] / 2, b[:, 2] + b[:, 4] / 2, b[:, 6]],
                    axis=1).astype(np.float32)


def test_rotated_iou_matches_jax():
    rng = np.random.RandomState(9)
    a, b = _bev(_boxes3d(rng, 40, 3.0)), _bev(_boxes3d(rng, 30, 3.0))
    b[:5] = a[:5]                                   # identical boxes
    want = np.asarray(jax_iou.boxes_iou_bev(a, b))
    got = rotated_iou.boxes_iou_bev(_t(a), _t(b)).numpy()
    assert (want > 0).sum() > 40                    # real overlaps tested
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want_n = np.stack([np.asarray(jax_iou.iou_normal_one_to_many(r, b))
                       for r in a])
    np.testing.assert_allclose(
        rotated_iou.boxes_iou_normal(_t(a), _t(b)).numpy(), want_n,
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('rotated', [True, False])
@pytest.mark.parametrize('max_keep,thresh', [(40, 0.1), (12, 0.5)])
def test_nms_bev_matches_jax(rotated, max_keep, thresh):
    rng = np.random.RandomState(10 + max_keep)
    boxes = _bev(_boxes3d(rng, 96, 4.0))
    scores = rng.randn(96).astype(np.float32)
    scores[10:14] = scores[20]                      # exact score ties
    valid = rng.rand(96) > 0.2
    want_i, want_m = jax_nms.nms_bev(boxes, scores, thresh, max_keep,
                                     valid=valid, rotated=rotated)
    got_i, got_m = nms.nms_bev(_t(boxes), _t(scores), thresh, max_keep,
                               valid=_t(valid), rotated=rotated)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert 0 < got_m.sum() < max_keep or max_keep == 12


def test_roipool3d_matches_jax():
    rng = np.random.RandomState(11)
    pts = _cloud(rng, 1, 2048)
    boxes = _boxes3d(rng, 12, 6.0)[None]
    # put points into the first boxes, and one box far from every point
    for k in range(6):
        pts[0, k * 100:(k + 1) * 100] = boxes[0, k, :3] + rng.uniform(
            -0.6, 0.6, (100, 3)).astype(np.float32) * [1, 0, 1] - [0, 0.5, 0]
    boxes[0, 11, :3] = [500.0, 0.0, 500.0]
    feats = rng.randn(1, 2048, 4).astype(np.float32)
    want_p, want_e = jax_roipool3d(pts, feats, boxes, 0.2, sampled_pt_num=64)
    got_p, got_e = roipool3d(_t(pts), _t(feats), _t(boxes), 0.2,
                             sampled_pt_num=64)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    assert got_e[0, 11] == 1 and (got_e[0, :6] == 0).all()
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize('avg_by_bin,ry_with_bin', [(True, False),
                                                    (False, False),
                                                    (True, True)])
def test_decode_bbox_target_matches_jax(avg_by_bin, ry_with_bin):
    rng = np.random.RandomState(12)
    rois = _boxes3d(rng, 50)
    reg = rng.randn(50, 6 * 4 + 1 + 9 * 2 + 3).astype(np.float32)
    anchor = np.array([1.52, 1.63, 3.88], np.float32)
    kw = dict(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9,
              get_xz_fine=True, get_ry_fine=True, avg_by_bin=avg_by_bin,
              ry_with_bin=ry_with_bin)
    want = np.asarray(jax_decode(rois, reg, anchor, **kw))
    got = decode_bbox_target(_t(rois), _t(reg), _t(anchor), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # anchor-point (proposal) mode
    pts = rois[:, :3].copy()
    reg3 = rng.randn(50, 12 * 4 + 1 + 12 * 2 + 3).astype(np.float32)
    kw3 = dict(loc_scope=3.0, loc_bin_size=0.5, num_head_bin=12,
               get_xz_fine=True, avg_by_bin=avg_by_bin,
               ry_with_bin=ry_with_bin)
    want3 = np.asarray(jax_decode(pts, reg3, anchor, **kw3))
    got3 = decode_bbox_target(_t(pts), _t(reg3), _t(anchor), **kw3).numpy()
    np.testing.assert_allclose(got3, want3, rtol=1e-5, atol=1e-5)
