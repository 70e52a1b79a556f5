"""KITTI calibration (counterpart of `jmodt_tpu/utils/calibration.py`,
port of reference jmodt/utils/calibration.py).

Host-side numpy with the JAX package's dtypes, so a projected point and the
image-border and range filters that read it are bit-equal between the two.
"""

from __future__ import annotations

import numpy as np


def get_calib_from_file(calib_file: str) -> dict:
    """Parse P2/P3/R0/Tr_velo2cam from a KITTI calib txt
    (reference calibration.py:4-20)."""
    with open(calib_file) as f:
        lines = f.readlines()
    obj = lines[2].strip().split(' ')[1:]
    p2 = np.array(obj, dtype=np.float32)
    obj = lines[3].strip().split(' ')[1:]
    p3 = np.array(obj, dtype=np.float32)
    obj = lines[4].strip().split(' ')[1:]
    r0 = np.array(obj, dtype=np.float32)
    obj = lines[5].strip().split(' ')[1:]
    tr = np.array(obj, dtype=np.float32)
    return {'P2': p2.reshape(3, 4), 'P3': p3.reshape(3, 4),
            'R0': r0.reshape(3, 3), 'Tr_velo2cam': tr.reshape(3, 4)}


class Calibration:
    """Reference Calibration (calibration.py:23-139)."""

    def __init__(self, calib_file):
        calib = (get_calib_from_file(calib_file)
                 if isinstance(calib_file, str) else calib_file)
        self.P2 = calib['P2']
        self.R0 = calib['R0']
        self.V2C = calib['Tr_velo2cam']
        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def cart_to_hom(pts: np.ndarray) -> np.ndarray:
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def lidar_to_rect(self, pts_lidar: np.ndarray) -> np.ndarray:
        """(N, 3) velodyne -> rect camera (calibration.py:50-58)."""
        pts_hom = self.cart_to_hom(pts_lidar)
        return pts_hom @ (self.V2C.T @ self.R0.T)

    def rect_to_img(self, pts_rect: np.ndarray):
        """(N, 3) rect -> ((N, 2) image uv, (N,) rect depth)
        (calibration.py:60-69)."""
        pts_hom = self.cart_to_hom(pts_rect)
        pts_2d = pts_hom @ self.P2.T
        pts_img = (pts_2d[:, 0:2].T / pts_hom[:, 2]).T
        depth = pts_2d[:, 2] - self.P2.T[3, 2]
        return pts_img, depth

    def lidar_to_img(self, pts_lidar: np.ndarray):
        pts_rect = self.lidar_to_rect(pts_lidar)
        return self.rect_to_img(pts_rect)

    def img_to_rect(self, u: np.ndarray, v: np.ndarray,
                    depth_rect: np.ndarray) -> np.ndarray:
        """Image uv + depth -> rect (calibration.py:80-90)."""
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.concatenate((x.reshape(-1, 1), y.reshape(-1, 1),
                               depth_rect.reshape(-1, 1)), axis=1)

    def corners3d_to_img_boxes(self, corners3d: np.ndarray):
        """(N, 8, 3) rect corners -> ((N, 4) 2D boxes, (N, 8, 2) corner uv)
        (calibration.py:105-123)."""
        n = corners3d.shape[0]
        hom = np.concatenate((corners3d, np.ones((n, 8, 1))), axis=2)
        img_pts = hom @ self.P2.T
        x = img_pts[:, :, 0] / img_pts[:, :, 2]
        y = img_pts[:, :, 1] / img_pts[:, :, 2]
        boxes = np.stack([x.min(axis=1), y.min(axis=1),
                          x.max(axis=1), y.max(axis=1)], axis=1)
        corners = np.concatenate(
            (x.reshape(-1, 8, 1), y.reshape(-1, 8, 1)), axis=2)
        return boxes, corners
