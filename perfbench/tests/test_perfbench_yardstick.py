"""The yardstick's arithmetic on hand-worked cases: the generator, the
order statistics, the interval union, the kernel bounds and the frozen
FLOP count."""

from __future__ import annotations

import math

import numpy as np
import pytest

from perfbench import generator, roofline, stats
from perfbench.flops import detection_flops
from perfbench.program import Program


def _seq(seed):
    return generator.make_sequence(seed, 3, 512, (16, 32), (1.5, 1.6, 3.9))


def test_generator_repeats_a_seed_and_not_another():
    a, b, c = _seq(2 ** 31 + 11), _seq(2 ** 31 + 11), _seq(2 ** 31 + 12)
    for fa, fb in zip(a, b):
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    assert not np.array_equal(a[0]['pts'], c[0]['pts'])
    assert a[0]['pts'].shape == (512, 3) and a[0]['img'].dtype == np.uint8
    assert a[0]['pts_xy'].min() >= -1 and a[0]['pts_xy'].max() <= 1


def test_stream_seeds_differ_and_fit_numpy():
    seeds = {generator.stream_seed(3 * 2 ** 31 + 5, s) for s in range(4)}
    assert len(seeds) == 4 and all(0 <= s < 2 ** 32 for s in seeds)


def test_no_image_without_camera():
    f = generator.make_sequence(1, 1, 512, None, (1.5, 1.6, 3.9))[0]
    assert f['img'] is None and f['pts_xy'].shape == (512, 2)


@pytest.mark.parametrize('spans, want', [
    ([], 0.0), ([(0, 1)], 1.0), ([(0, 2), (1, 3)], 3.0),
    ([(0, 1), (2, 3)], 2.0), ([(0, 5), (1, 2), (3, 4)], 5.0),
    ([(4, 6), (0, 1), (0.5, 1.5)], 3.5)])
def test_union_length(spans, want):
    assert stats.union_length(spans) == pytest.approx(want)


def test_percentile_linear_between_ranks():
    xs = list(range(1, 101))                  # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2], 50) == pytest.approx(1.5)


def test_spread_is_interquartile_over_median():
    # quantiles(n=4) of 1..7 (exclusive method): 2, 4, 6
    assert stats.spread([1, 2, 3, 4, 5, 6, 7]) == pytest.approx(1.0)


def test_kernel_bounds_hand_worked():
    # K1 at level 0: 9 FMAs-worth a pair over 67 TFLOP/s
    assert roofline.fps_s(1, 16384, 4096) == pytest.approx(
        9 * 16384 * 4096 / 67e12)
    # K6 is bound by its bytes: 2 bytes in and out a value
    assert roofline.bound_s(0.0, 3.35e9) == pytest.approx(1e-3)
    # K4 at the RCNN's sa_0: 3xTF32 products of 128 -> 128 -> 128
    rows = 100 * 128 * 64
    mma, other = roofline.mlp_ops(rows, [128, 128, 128])
    assert mma == rows * 2 * (2 * 128 * 128)
    assert other == rows * (3 * 128 + 2 * 128 + 2 * 128)
    assert roofline.grouped_mlp_s(100, 512, 128, 64, [128, 128, 128]) == \
        pytest.approx(3 * mma / 495e12 + other / 67e12)


def test_kernel_families():
    assert roofline.family('void fps_cluster_kernel<8>(float const*)') == \
        'fps_cluster_kernel'
    assert roofline.family('void nms_scan_kernel(...)') == 'nms'
    assert roofline.family('ampere_sgemm_128x64_nn') is None


def _cfg(name):
    import json
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    tree = json.loads((root / 'perfbench/configs' / f'{name}.json')
                      .read_text())['config']
    return Program('perfbench.reference').make_config(tree)


@pytest.mark.parametrize('name, gflop', [('jmodt_fusion', 244.150431744),
                                         ('jmodt_lidar_only', 131.974393856)])
def test_frozen_flop_count(name, gflop):
    f = detection_flops(_cfg(name))
    assert f['total'] / 1e9 == pytest.approx(gflop, rel=1e-12)
    with_tracker = detection_flops(_cfg(name), track_k=16, max_tracks=64)
    assert with_tracker['tracker'] > 0


def test_frame_bounds_cover_the_main_path():
    b1 = roofline.frame_bounds(_cfg('jmodt_fusion'), 1)
    b4 = roofline.frame_bounds(_cfg('jmodt_fusion'), 4)
    assert set(b1) == {'fps_cluster_kernel', 'sa_consumer_kernel',
                       'three_nn_kernel', 'd2s_kernel', 'fps_batched_kernel',
                       'grouped_gather_mlp_max_kernel', 'nms', 'lap_kernel',
                       'kalman_predict_kernel'}
    assert all(v > 0 for v in b1.values())
    for k in b1:
        assert b4[k] == pytest.approx(4 * b1[k])
    assert 'd2s_kernel' not in roofline.frame_bounds(
        _cfg('jmodt_lidar_only'), 1)
    assert b1['fps_cluster_kernel'] * 1e3 == pytest.approx(
        (9 * (16384 * 4096 + 4096 * 1024 + 1024 * 256 + 256 * 64)) / 67e9,
        rel=1e-9)
    assert math.isfinite(sum(b1.values()))


def test_train_step_bounds_and_flops():
    from perfbench.drivers.train import step_flops
    cfg = _cfg('jmodt_fusion_ft')
    b = roofline.train_step_bounds(cfg, 8)
    assert 'grouped_gather_mlp_max_kernel' not in b and 'lap_kernel' not in b
    assert b['fps_cluster_kernel'] == pytest.approx(
        8 * roofline.frame_bounds(cfg, 1)['fps_cluster_kernel'])
    assert b['fps_batched_kernel'] == pytest.approx(
        roofline.fps_s(8 * 64, 512, 128) + roofline.fps_s(8 * 64, 128, 32))
    per_frame = detection_flops(cfg, rois=64)['total']
    assert step_flops(cfg, 4) > 8 * per_frame
