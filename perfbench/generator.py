"""The benchmark's traffic generator: sequences of KITTI-shaped frames from
a seed.

A frozen copy of the port's synthetic scene (`make_scene`: car-shaped
point clusters on a ground plane with clutter, a pinhole projection for
`pts_xy`), with its image drawn directly as raw uint8, and a sequence
writer: a stream is one sequence of 2-6 cars moving at constant velocity,
as a KITTI tracking sequence is.  The same seed gives the same frames on
every commit; nothing here depends on the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# a KITTI-like P2 focal / centre
_FU, _FV, _CU, _CV = 720.0, 720.0, 620.0, 190.0


def _rotate_y(pts: np.ndarray, ry: float) -> np.ndarray:
    c, s = np.cos(ry), np.sin(ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return pts @ rot.T


def _car_surface_points(box: np.ndarray, n: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """Points on the visible faces of a box [x, y, z, h, w, l, ry]
    (y = bottom centre, KITTI rect convention)."""
    x, y, z, h, w, l, ry = box
    face = rng.randint(0, 3, n)
    u = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    local = np.zeros((n, 3), np.float32)
    side, rear, roof = face == 0, face == 1, face == 2
    local[side] = np.stack([np.sign(u[side]) * w / 2, -(v[side] + 0.5) * h,
                            u[side] * l], axis=1)
    local[rear] = np.stack([u[rear] * w, -(v[rear] + 0.5) * h,
                            np.sign(v[rear]) * l / 2], axis=1)
    local[roof] = np.stack([u[roof] * w, -h * np.ones(roof.sum(), np.float32),
                            v[roof] * l], axis=1)
    return _rotate_y(local, ry) + np.array([x, y, z], np.float32)


def make_frame(rng: np.random.RandomState, boxes: np.ndarray, npoints: int,
               img_hw) -> Dict[str, np.ndarray]:
    """One frame of the cars `boxes` (K, 7): pts (N, 3) float32, img
    (H, W, 3) raw uint8 (or None when `img_hw` is None) and pts_xy (N, 2)
    in [-1, 1]."""
    ncars = boxes.shape[0]
    per_car = max(32, int(npoints * 0.35) // max(ncars, 1))
    chunks = [_car_surface_points(boxes[k], per_car, rng)
              for k in range(ncars)]
    n_bg = npoints - per_car * ncars
    ground = np.stack([rng.uniform(-30.0, 30.0, n_bg),
                       rng.uniform(1.55, 1.75, n_bg),
                       rng.uniform(2.0, 70.0, n_bg)], axis=1).astype(
                           np.float32)
    clutter = rng.rand(n_bg) < 0.3
    ground[clutter, 1] = rng.uniform(-1.5, 1.5, clutter.sum())
    pts = np.concatenate(chunks + [ground], axis=0)[:npoints].astype(
        np.float32)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)

    h, w = img_hw if img_hw is not None else (384, 1280)
    z = np.clip(pts[:, 2], 1.0, None)
    u = _FU * pts[:, 0] / z + _CU
    v = _FV * pts[:, 1] / z + _CV
    xy = np.stack([np.clip(u / w, 0, 1) * 2 - 1,
                   np.clip(v / h, 0, 1) * 2 - 1], axis=1).astype(np.float32)
    img = (None if img_hw is None
           else rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return dict(pts=pts, img=img, pts_xy=xy)


def make_sequence(seed: int, frames: int, npoints: int, img_hw,
                  mean_size, cars=(2, 6), speed=(1.5, 0.3)
                  ) -> List[Dict[str, np.ndarray]]:
    """`frames` frames of one sequence: 2-6 (`cars`, upper bound exclusive)
    cars placed as `make_scene` places them, each moving at a constant
    velocity of up to `speed` = (dz, dx) metres a frame (up to 15 m/s
    along the road at KITTI's 10 Hz), kept inside the scene."""
    rng = np.random.RandomState(seed)
    ncars = rng.randint(*cars)
    boxes = np.zeros((ncars, 7), np.float32)
    boxes[:, 0] = rng.uniform(-15.0, 15.0, ncars)
    boxes[:, 1] = rng.uniform(1.4, 1.8, ncars)
    boxes[:, 2] = rng.uniform(8.0, 60.0, ncars)
    boxes[:, 3:6] = np.asarray(mean_size) * rng.uniform(0.9, 1.1, (ncars, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, ncars)
    vel = np.stack([rng.uniform(-speed[1], speed[1], ncars),
                    rng.uniform(-speed[0], speed[0], ncars)], 1)
    out = []
    for t in range(frames):
        cur = boxes.copy()
        cur[:, 0] = np.clip(cur[:, 0] + vel[:, 0] * t, -20.0, 20.0)
        cur[:, 2] = np.clip(cur[:, 2] + vel[:, 1] * t, 5.0, 70.0)
        out.append(make_frame(rng, cur, npoints, img_hw))
    return out


def stream_seed(seed: int, stream: int) -> int:
    """The numpy seed of stream `stream` of a run's `seed` (any whole
    number): numpy takes 32 bits."""
    return (int(seed) * 1000003 + 7919 * stream) % (2 ** 32)


def _random_boxes(rng: np.random.RandomState, mean_size, cars) -> np.ndarray:
    ncars = rng.randint(*cars)
    boxes = np.zeros((ncars, 7), np.float32)
    boxes[:, 0] = rng.uniform(-15.0, 15.0, ncars)
    boxes[:, 1] = rng.uniform(1.4, 1.8, ncars)
    boxes[:, 2] = rng.uniform(8.0, 60.0, ncars)
    boxes[:, 3:6] = np.asarray(mean_size) * rng.uniform(0.9, 1.1, (ncars, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, ncars)
    return boxes


def make_pairs(seed: int, pairs: int, npoints: int, img_hw, mean_size,
               cars=(2, 6), max_gt: int = 8) -> Dict[str, np.ndarray]:
    """A training batch of `pairs` (prev, next) frame pairs interleaved as
    rows (2i, 2i + 1), as the port's `make_pair_batch` lays them out:
    pts_input, img (float32, normalised; absent when `img_hw` is None),
    pts_xy, gt_boxes3d (zero-padded to `max_gt`) and gt_tids (0 = none).
    The next frame holds the same cars after a small constant-velocity
    move, under the same track ids."""
    rng = np.random.RandomState(seed)
    rows, tid_base = [], 1
    for _ in range(pairs):
        boxes = _random_boxes(rng, mean_size, cars)[:max_gt]
        moved = boxes.copy()
        moved[:, 0] += rng.uniform(-0.5, 0.5, len(boxes))
        moved[:, 2] += rng.uniform(-1.5, 0.5, len(boxes))
        tids = np.zeros(max_gt, np.float32)
        tids[:len(boxes)] = np.arange(tid_base, tid_base + len(boxes))
        tid_base += len(boxes)
        for b in (boxes, moved):
            f = make_frame(rng, b, npoints, None)
            gt = np.zeros((max_gt, 7), np.float32)
            gt[:len(b)] = b
            if img_hw is not None:
                f['img'] = (rng.rand(*img_hw, 3).astype(np.float32)
                            - 0.5) * 0.5
            rows.append(dict(f, gt_boxes3d=gt, gt_tids=tids))
    out = {k: np.stack([r[src] for r in rows]) for k, src in (
        ('pts_input', 'pts'), ('pts_xy', 'pts_xy'),
        ('gt_boxes3d', 'gt_boxes3d'), ('gt_tids', 'gt_tids'))}
    if img_hw is not None:
        out['img'] = np.stack([r['img'] for r in rows])
    return out
