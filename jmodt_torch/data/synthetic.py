"""Synthetic KITTI-shaped frames for the port.

The port's own copy of `make_scene`, `make_eval_frame`, `rpn_labels` and
`make_pair_batch` from `jmodt_tpu/data/synthetic.py`: the same numpy calls
in the same order, so a seed gives the same arrays in both packages
(test-pinned).  `write_synthetic_kitti_tree` writes such frames as a raw
KITTI tracking tree.  Car-shaped point clusters on a ground plane, a pinhole
projection for `pts_xy`, a random image, per-point RPN labels, and (prev,
next) frame pairs with persistent track ids and small motion for training.
`boundary_cloud` makes ball-query inputs crowded on the r^2 boundary.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from jmodt_torch.config import Config
from jmodt_torch.utils.png import write_png

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


def _in_box_mask(pts: np.ndarray, box: np.ndarray, extra: float = 0.0
                 ) -> np.ndarray:
    x, y, z, h, w, l, ry = box
    local = _rotate_y(pts - np.array([x, y, z], np.float32), -ry)
    return ((np.abs(local[:, 0]) <= w / 2 + extra)
            & (np.abs(local[:, 2]) <= l / 2 + extra)
            & (local[:, 1] <= extra) & (local[:, 1] >= -h - extra))


def rpn_labels(pts: np.ndarray, gt_boxes: np.ndarray, gt_valid: np.ndarray):
    """Per-point RPN labels: cls 1 inside a gt box, -1 in its 0.2 m
    enlarged fringe, 0 elsewhere; the reg target of a foreground point is
    the offset to the box centre (y moved up by h / 2), its size and ry."""
    n = pts.shape[0]
    cls_label = np.zeros(n, np.int32)
    reg_label = np.zeros((n, 7), np.float32)
    for k in range(gt_boxes.shape[0]):
        if not gt_valid[k]:
            continue
        box = gt_boxes[k]
        fg = _in_box_mask(pts, box)
        enlarged = _in_box_mask(pts, box, extra=0.2)
        cls_label[np.logical_xor(fg, enlarged)] = -1
        cls_label[fg] = 1
        center = box[0:3].copy()
        center[1] -= box[3] / 2
        reg_label[fg, 0:3] = center - pts[fg]
        reg_label[fg, 3:6] = box[3:6]
        reg_label[fg, 6] = box[6]
    return cls_label, reg_label


def make_scene(rng: np.random.RandomState, cfg: Config,
               npoints: Optional[int] = None, max_gt: int = 8,
               num_cars: Optional[int] = None,
               base_boxes: Optional[np.ndarray] = None,
               img_hw=(IMG_H, IMG_W),
               bg_x=(-30.0, 30.0), bg_z=(2.0, 70.0)) -> Dict[str, np.ndarray]:
    """One frame: points (N, 3), img (H, W, 3), pts_xy (N, 2 in [-1, 1]),
    gt_boxes3d (max_gt, 7) zero-padded, gt_valid (max_gt,).  With
    `base_boxes` the cars are those boxes.  bg_x / bg_z bound the ground
    clutter."""
    n = npoints or cfg.RPN.NUM_POINTS
    ncars = num_cars if num_cars is not None else rng.randint(2, 6)
    mean = np.asarray(cfg.mean_size)

    if base_boxes is None:
        boxes = np.zeros((ncars, 7), np.float32)
        boxes[:, 0] = rng.uniform(-15.0, 15.0, ncars)   # x
        boxes[:, 1] = rng.uniform(1.4, 1.8, ncars)      # y (bottom)
        boxes[:, 2] = rng.uniform(8.0, 60.0, ncars)     # z
        boxes[:, 3:6] = mean * rng.uniform(0.9, 1.1, (ncars, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, ncars)
    else:
        boxes = base_boxes.copy()
        ncars = boxes.shape[0]

    per_car = max(32, int(n * 0.35) // max(ncars, 1))
    chunks = [_car_surface_points(boxes[k], per_car, rng)
              for k in range(ncars)]
    n_bg = n - per_car * ncars
    ground = np.stack([rng.uniform(*bg_x, n_bg),
                       rng.uniform(1.55, 1.75, n_bg),
                       rng.uniform(*bg_z, n_bg)], axis=1).astype(np.float32)
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


def make_pair_batch(seed: int, cfg: Config, num_pairs: int = 1,
                    npoints: Optional[int] = None, max_gt: int = 8,
                    img_hw=(IMG_H, IMG_W)) -> Dict[str, np.ndarray]:
    """A training batch of (prev, next) frame pairs interleaved as rows
    (2i, 2i + 1): pts_input, img, pts_xy, gt_boxes3d, gt_tids,
    rpn_cls_label and rpn_reg_label."""
    rng = np.random.RandomState(seed)
    frames = []
    tid_base = 1
    for _ in range(num_pairs):
        prev = make_scene(rng, cfg, npoints, max_gt, img_hw=img_hw)
        ncars = int(prev['gt_valid'].sum())
        # next frame: the same cars, small constant-velocity motion
        moved = prev['gt_boxes3d'][:ncars].copy()
        moved[:, 0] += rng.uniform(-0.5, 0.5, ncars)
        moved[:, 2] += rng.uniform(-1.5, 0.5, ncars)
        nxt = make_scene(rng, cfg, npoints, max_gt, base_boxes=moved,
                         img_hw=img_hw)
        tids = np.zeros(max_gt, np.float32)
        tids[:ncars] = np.arange(tid_base, tid_base + ncars)
        tid_base += ncars
        for fr in (prev, nxt):
            fr['gt_tids'] = tids
            frames.append(fr)

    batch: Dict[str, np.ndarray] = {}
    for key, name in (('pts_input', 'pts'), ('img', 'img'),
                      ('pts_xy', 'pts_xy'), ('gt_boxes3d', 'gt_boxes3d'),
                      ('gt_tids', 'gt_tids')):
        batch[key] = np.stack([f[name] for f in frames])
    labels = [rpn_labels(f['pts'], f['gt_boxes3d'], f['gt_valid'])
              for f in frames]
    batch['rpn_cls_label'] = np.stack([lab[0] for lab in labels])
    batch['rpn_reg_label'] = np.stack([lab[1] for lab in labels])
    return batch


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


def boundary_cloud(rng: np.random.RandomState, b: int, m: int, per: int,
                   r: float):
    """Clouds crowded on the r^2 boundary: per centre (KITTI-scale
    coordinates, where d2's cancellation leaves few bits) `per` points at
    distance r along random directions, rounded to float32, a quarter of
    them repeated; the points of all centres interleaved, so that every
    ball's hits spread over the cloud.  Returns (xyz (b, m * per, 3),
    new_xyz (b, m, 3)) float32."""
    q = np.stack([rng.uniform(-30, 30, (b, m)), rng.uniform(-1, 3, (b, m)),
                  rng.uniform(0, 70, (b, m))], -1)
    u = rng.randn(b, m, per, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    p = (q[:, :, None] + r * u).astype(np.float32)
    p[:, :, per * 3 // 4:] = p[:, :, :per // 4]
    xyz = np.ascontiguousarray(p.transpose(0, 2, 1, 3).reshape(b, -1, 3))
    return xyz, q.astype(np.float32)


def write_synthetic_kitti_tree(root: str, cfg: Config,
                               seq_ids: Sequence[str] = ('0000', '0001'),
                               n_frames: int = 16, img_hw=(64, 128),
                               npoints: Optional[int] = None,
                               seed: int = 0) -> None:
    """Write a raw KITTI tracking tree, <root>/training/{calib, image_02,
    velodyne, label_02}, whose frames are `make_scene`s of cars on
    constant-velocity trajectories (the writer of
    `jmodt_tpu/data/synthetic.py::write_synthetic_kitti_tree`, with PNGs
    from `utils/png.py`).  The calibration is a pinhole with focal 2 h and
    the velodyne axes (x forward, y left, z up); the cars stay within 5.5-18
    m, so their projected heights pass the AP difficulty gates (40 px easy,
    25 px moderate and hard) and the dataset's filter keeps every point."""
    h, w = img_hw
    fu = fv = 2.0 * h
    cu, cv = w / 2.0, 0.45 * h
    p = f'{fu} 0 {cu} 0 0 {fv} {cv} 0 0 0 1 0\n'
    calib_txt = (''.join(f'P{i}: ' + p for i in range(4))
                 + 'R0_rect: 1 0 0 0 1 0 0 0 1\n'
                 'Tr_velo_to_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0\n')
    train = os.path.join(root, 'training')
    rng = np.random.RandomState(seed)
    n = npoints or cfg.RPN.NUM_POINTS
    for seq in seq_ids:
        for sub in ('image_02', 'velodyne'):
            os.makedirs(os.path.join(train, sub, seq), exist_ok=True)
        for sub in ('calib', 'label_02'):
            os.makedirs(os.path.join(train, sub), exist_ok=True)
        with open(os.path.join(train, 'calib', f'{seq}.txt'), 'w') as f:
            f.write(calib_txt)

        ncars = rng.randint(2, 5)
        boxes = np.zeros((ncars, 7), np.float32)
        boxes[:, 0] = rng.uniform(-2.0, 2.0, ncars)
        boxes[:, 1] = rng.uniform(1.5, 1.7, ncars)
        boxes[:, 2] = rng.uniform(6, 14, ncars)
        boxes[:, 3:6] = (np.asarray(cfg.mean_size)
                         * rng.uniform(0.95, 1.05, (ncars, 3)))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, ncars)
        vel = np.stack([rng.uniform(-0.04, 0.04, ncars),     # dx a frame
                        rng.uniform(-0.12, 0.12, ncars)], 1)  # dz a frame

        label_rows = []
        for fr in range(n_frames):
            cur = boxes.copy()
            cur[:, 0] = np.clip(cur[:, 0] + vel[:, 0] * fr, -2.5, 2.5)
            cur[:, 2] = np.clip(cur[:, 2] + vel[:, 1] * fr, 5.5, 18.0)
            scene = make_scene(rng, cfg, npoints=n, base_boxes=cur,
                               img_hw=img_hw, bg_x=(-7.0, 7.0),
                               bg_z=(3.0, 20.0))
            pts_rect = scene['pts']
            # rect -> velodyne: v = (z, -x, -y); intensity random
            pts_v = np.stack([pts_rect[:, 2], -pts_rect[:, 0],
                              -pts_rect[:, 1],
                              rng.rand(len(pts_rect)).astype(np.float32)],
                             axis=1).astype(np.float32)
            pts_v.tofile(os.path.join(train, 'velodyne', seq,
                                      f'{fr:06d}.bin'))
            img = ((scene['img'] + 0.5) * 255).clip(0, 255).astype(np.uint8)
            write_png(os.path.join(train, 'image_02', seq, f'{fr:06d}.png'),
                      img)
            for k in range(ncars):
                x, y, z, bh, bw, bl, ry = cur[k]
                # the 2D box from the 8 projected corners
                cx = np.array([bl / 2, bl / 2, -bl / 2, -bl / 2] * 2)
                cz = np.array([bw / 2, -bw / 2, -bw / 2, bw / 2] * 2)
                cy = np.array([0.0] * 4 + [-bh] * 4)
                c, s = np.cos(ry), np.sin(ry)
                wx = x + cx * c + cz * s
                wz = np.clip(z - cx * s + cz * c, 1.0, None)
                us = np.clip(fu * wx / wz + cu, 0, w - 1)
                vs = np.clip(fv * (y + cy) / wz + cv, 0, h - 1)
                alpha = float(-np.arctan2(x, z) + ry)
                label_rows.append(
                    f'{fr} {k + 1} Car 0 0 {alpha:.2f} '
                    f'{us.min():.2f} {vs.min():.2f} {us.max():.2f} '
                    f'{vs.max():.2f} {bh:.2f} {bw:.2f} {bl:.2f} '
                    f'{x:.2f} {y:.2f} {z:.2f} {ry:.2f}\n')
        with open(os.path.join(train, 'label_02', f'{seq}.txt'), 'w') as f:
            f.writelines(label_rows)
