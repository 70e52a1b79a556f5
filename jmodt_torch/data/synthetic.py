"""Synthetic KITTI-shaped frames for the port.

The port's own copy of `make_scene` / `make_eval_frame` from
`jmodt_tpu/data/synthetic.py`: the same numpy calls in the same order, so a
seed gives the same arrays in both packages (test-pinned).  Car-shaped
point clusters on a ground plane, a pinhole projection for `pts_xy`, and a
random image.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from jmodt_torch.config import Config

# KITTI image size after padding
IMG_H, IMG_W = 384, 1280
# a KITTI-like P2 focal/center
_FU, _FV, _CU, _CV = 720.0, 720.0, 620.0, 190.0


def _rotate_y(pts: np.ndarray, ry: float) -> np.ndarray:
    c, s = np.cos(ry), np.sin(ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return pts @ rot.T


def _car_surface_points(box: np.ndarray, n: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """Points on the visible faces of a box [x, y, z, h, w, l, ry]
    (y = bottom center, KITTI rect convention)."""
    x, y, z, h, w, l, ry = box
    face = rng.randint(0, 3, n)
    u = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    local = np.zeros((n, 3), np.float32)
    # side face (x = +-w/2), rear face (z = +-l/2), roof (y = -h)
    side = face == 0
    rear = face == 1
    roof = face == 2
    local[side] = np.stack([np.sign(u[side]) * w / 2, -(v[side] + 0.5) * h,
                            u[side] * l], axis=1)
    local[rear] = np.stack([u[rear] * w, -(v[rear] + 0.5) * h,
                            np.sign(v[rear]) * l / 2], axis=1)
    local[roof] = np.stack([u[roof] * w, -h * np.ones(roof.sum(), np.float32),
                            v[roof] * l], axis=1)
    return _rotate_y(local, ry) + np.array([x, y, z], np.float32)


def make_scene(rng: np.random.RandomState, cfg: Config,
               npoints: Optional[int] = None, max_gt: int = 8,
               num_cars: Optional[int] = None,
               img_hw=(IMG_H, IMG_W)) -> Dict[str, np.ndarray]:
    """One frame: points (N, 3), img (H, W, 3), pts_xy (N, 2 in [-1, 1]),
    gt_boxes3d (max_gt, 7) zero-padded, gt_valid (max_gt,)."""
    n = npoints or cfg.RPN.NUM_POINTS
    ncars = num_cars if num_cars is not None else rng.randint(2, 6)
    mean = np.asarray(cfg.mean_size)

    boxes = np.zeros((ncars, 7), np.float32)
    boxes[:, 0] = rng.uniform(-15.0, 15.0, ncars)   # x
    boxes[:, 1] = rng.uniform(1.4, 1.8, ncars)      # y (bottom)
    boxes[:, 2] = rng.uniform(8.0, 60.0, ncars)     # z
    boxes[:, 3:6] = mean * rng.uniform(0.9, 1.1, (ncars, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, ncars)

    per_car = max(32, int(n * 0.35) // max(ncars, 1))
    chunks = [_car_surface_points(boxes[k], per_car, rng)
              for k in range(ncars)]
    n_bg = n - per_car * ncars
    ground = np.stack([rng.uniform(-30.0, 30.0, n_bg),
                       rng.uniform(1.55, 1.75, n_bg),
                       rng.uniform(2.0, 70.0, n_bg)], axis=1).astype(np.float32)
    clutter_sel = rng.rand(n_bg) < 0.3
    ground[clutter_sel, 1] = rng.uniform(-1.5, 1.5, clutter_sel.sum())
    pts = np.concatenate(chunks + [ground], axis=0)[:n].astype(np.float32)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)

    # pinhole projection -> normalized [-1, 1] image coords
    z = np.clip(pts[:, 2], 1.0, None)
    u = _FU * pts[:, 0] / z + _CU
    v = _FV * pts[:, 1] / z + _CV
    h, w = img_hw
    xy = np.stack([np.clip(u / w, 0, 1) * 2 - 1,
                   np.clip(v / h, 0, 1) * 2 - 1], axis=1).astype(np.float32)

    img = (rng.rand(h, w, 3).astype(np.float32) - 0.5) * 0.5

    gt_boxes = np.zeros((max_gt, 7), np.float32)
    gt_valid = np.zeros(max_gt, bool)
    keep = min(ncars, max_gt)
    gt_boxes[:keep] = boxes[:keep]
    gt_valid[:keep] = True
    return dict(pts=pts, img=img, pts_xy=xy, gt_boxes3d=gt_boxes,
                gt_valid=gt_valid)


def make_eval_frame(seed: int, cfg: Config, npoints: Optional[int] = None,
                    img_hw=(IMG_H, IMG_W),
                    raw_u8: bool = False) -> Dict[str, np.ndarray]:
    """One inference input (batch size 1).  With raw_u8 the image is raw
    uint8 (normalized inside the detection step)."""
    rng = np.random.RandomState(seed)
    scene = make_scene(rng, cfg, npoints, img_hw=img_hw)
    img = scene['img']
    if raw_u8:
        img = (np.clip(img + 0.5, 0, 1) * 255).astype(np.uint8)
    return dict(pts_input=scene['pts'][None],
                img=img[None],
                pts_xy=scene['pts_xy'][None],
                gt_boxes3d=scene['gt_boxes3d'][None],
                gt_valid=scene['gt_valid'][None])
