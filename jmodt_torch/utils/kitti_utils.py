"""Geometry helpers under the reference's naming (counterpart of
`jmodt_tpu/utils/kitti_utils.py`, port of reference
jmodt/utils/kitti_utils.py).

The tensor versions live in `jmodt_torch/ops/geometry.py` and the numpy
point helpers in `jmodt_torch/data/kitti_dataset.py`; this module
re-exports them and adds the host-side helpers the reference keeps in
numpy / scipy / shapely: `in_hull` (a point-in-box test, kitti_utils.py:
165-179) and `get_iou3d` (3D IoU from corners, kitti_utils.py:182-222),
both without those libraries.
"""

from __future__ import annotations

import numpy as np
import torch

from jmodt_torch.data.kitti_dataset import (in_box3d_mask,  # noqa: F401
                                            rotate_pc_along_y)
from jmodt_torch.ops.geometry import (boxes3d_to_bev,  # noqa: F401
                                      boxes3d_to_corners3d, enlarge_box3d,
                                      rotate_points_along_y)
from jmodt_torch.ops.rotated_iou import boxes_overlap_bev


def in_hull(p: np.ndarray, hull_corners: np.ndarray) -> np.ndarray:
    """Points inside the hull of a 3D box's 8 corners.

    The reference triangulates the corners (scipy's Delaunay); a box's
    hull is the parallelepiped on the edges from corner 0, so the test is
    exact in that frame.

    :param p: (N, 3); hull_corners: (8, 3) in the corner order of
        `boxes3d_to_corners3d`
    :return: (N,) bool
    """
    c = np.asarray(hull_corners, np.float64)
    # edges from corner 0: to corner 1 (length), 3 (width) and 4 (height)
    axes = np.stack([c[1] - c[0], c[3] - c[0], c[4] - c[0]])
    rel = np.asarray(p, np.float64) - c[0]
    t = rel @ axes.T / np.maximum(np.sum(axes * axes, axis=1), 1e-12)
    return np.all((t >= -1e-9) & (t <= 1 + 1e-9), axis=1)


def _bev_boxes(corners: np.ndarray) -> np.ndarray:
    """(N, 8, 3) corners -> (N, 5) BEV boxes [x1, y1, x2, y2, angle] from
    the bottom face (corners 0, 1, 3 give the centre, extents and angle)."""
    c = np.asarray(corners, np.float64)
    center = c[:, :4, [0, 2]].mean(axis=1)
    le = c[:, 1, [0, 2]] - c[:, 0, [0, 2]]
    we = c[:, 3, [0, 2]] - c[:, 0, [0, 2]]
    length = np.linalg.norm(le, axis=1)
    width = np.linalg.norm(we, axis=1)
    # the BEV boxes rotate clockwise-positive about their centre
    ang = -np.arctan2(le[:, 1], le[:, 0])
    return np.stack([center[:, 0] - length / 2, center[:, 1] - width / 2,
                     center[:, 0] + length / 2, center[:, 1] + width / 2,
                     ang], axis=1).astype(np.float32)


def get_iou3d(corners3d_a: np.ndarray, corners3d_b: np.ndarray
              ) -> np.ndarray:
    """3D IoU of every pair of boxes given by their corners (the reference
    intersects shapely polygons; here the rotated BEV overlap of
    `ops/rotated_iou.py` on the CPU, times the height overlap).

    :param corners3d_a: (N, 8, 3); corners3d_b: (M, 8, 3)
    :return: (N, M)
    """
    a, b = _bev_boxes(corners3d_a), _bev_boxes(corners3d_b)
    inter_bev = boxes_overlap_bev(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy()
    ca, cb = np.asarray(corners3d_a), np.asarray(corners3d_b)
    a_top, a_bot = ca[:, 4, 1], ca[:, 0, 1]   # y points down
    b_top, b_bot = cb[:, 4, 1], cb[:, 0, 1]
    h_overlap = np.clip(np.minimum(a_bot[:, None], b_bot[None, :])
                        - np.maximum(a_top[:, None], b_top[None, :]),
                        0.0, None)
    inter = inter_bev * h_overlap
    vol_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
             * (a_bot - a_top))[:, None]
    vol_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
             * (b_bot - b_top))[None, :]
    return inter / np.maximum(vol_a + vol_b - inter, 1e-9)
