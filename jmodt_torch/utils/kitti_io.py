"""KITTI output writers (detection txt + feature npy, tracking rows); the
counterpart of `jmodt_tpu/utils/kitti_io.py`, with the same text format
byte for byte on the same numbers.

Port of the writer helpers in reference tools/eval.py:245-289 and
:408-417.
"""

from __future__ import annotations

import os

import numpy as np

from jmodt_torch.utils.calibration import Calibration


def _corners3d(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 8, 3) rect-frame corners (numpy mirror of
    jmodt_torch.ops.geometry.boxes3d_to_corners3d)."""
    n = boxes3d.shape[0]
    h, w, l = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_c = np.stack([l / 2, l / 2, -l / 2, -l / 2] * 2, axis=1)
    z_c = np.stack([w / 2, -w / 2, -w / 2, w / 2] * 2, axis=1)
    y_c = np.concatenate([np.zeros((n, 4)),
                          -np.tile(h[:, None], (1, 4))], axis=1)
    ry = boxes3d[:, 6]
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    # R = [[c, 0, s], [0, 1, 0], [-s, 0, c]]; y unchanged
    x_r = c * x_c + s * z_c
    z_r = -s * x_c + c * z_c
    corners = np.stack([x_r, y_c, z_r], axis=2)
    return corners + boxes3d[:, None, 0:3]


def save_kitti_detection_format(sample_id: int, calib: Calibration,
                                bbox3d: np.ndarray, kitti_output_dir: str,
                                scores: np.ndarray, img_shape,
                                feat: np.ndarray = None,
                                feat_output_dir: str = None,
                                cls_name: str = 'Car') -> int:
    """Write one sample's detections as KITTI txt (+ 512-d feature npy)
    (reference save_kitti_detection_format, tools/eval.py:245-274).
    Returns the number of rows written."""
    corners3d = _corners3d(bbox3d)
    img_boxes, _ = calib.corners3d_to_img_boxes(corners3d)
    img_boxes[:, 0] = np.clip(img_boxes[:, 0], 0, img_shape[1] - 1)
    img_boxes[:, 1] = np.clip(img_boxes[:, 1], 0, img_shape[0] - 1)
    img_boxes[:, 2] = np.clip(img_boxes[:, 2], 0, img_shape[1] - 1)
    img_boxes[:, 3] = np.clip(img_boxes[:, 3], 0, img_shape[0] - 1)
    box_w = img_boxes[:, 2] - img_boxes[:, 0]
    box_h = img_boxes[:, 3] - img_boxes[:, 1]
    valid = (box_w < img_shape[1] * 0.8) & (box_h < img_shape[0] * 0.8)

    out_file = os.path.join(kitti_output_dir, '%06d.txt' % sample_id)
    n = 0
    with open(out_file, 'w') as f:
        for k in range(bbox3d.shape[0]):
            if not valid[k]:
                continue
            x, z, ry = bbox3d[k, 0], bbox3d[k, 2], bbox3d[k, 6]
            beta = np.arctan2(z, x)
            alpha = -np.sign(beta) * np.pi / 2 + beta + ry
            print('%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
                  '%.4f %.4f %.4f %.4f' % (
                      cls_name, alpha, img_boxes[k, 0], img_boxes[k, 1],
                      img_boxes[k, 2], img_boxes[k, 3], bbox3d[k, 3],
                      bbox3d[k, 4], bbox3d[k, 5], bbox3d[k, 0],
                      bbox3d[k, 1], bbox3d[k, 2], bbox3d[k, 6], scores[k]),
                  file=f)
            n += 1
    if feat is not None and feat_output_dir is not None:
        np.save(os.path.join(feat_output_dir, '%06d.npy' % sample_id),
                np.asarray(feat)[valid].astype(np.float32))
    return n


def save_kitti_tracking_format(results, frame_id: int, out_file) -> None:
    """Append confirmed tracks as KITTI tracking rows (reference
    save_kitti_tracking_format, tools/eval.py:408-417).  `results` are
    (tid, info: Object3d, score) tuples from Tracker.update."""
    for tid, info, score in results:
        out_file.write(
            '%d %d %s %d %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f '
            '%.2f %.2f %.2f %.2f\n' % (
                frame_id, tid, info.cls_type, int(info.truncation),
                int(info.occlusion), info.alpha,
                info.box2d[0], info.box2d[1], info.box2d[2], info.box2d[3],
                info.h, info.w, info.l, info.pos[0], info.pos[1],
                info.pos[2], info.ry, info.score))
