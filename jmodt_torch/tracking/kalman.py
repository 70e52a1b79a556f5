"""Constant-velocity Kalman filter for 3D box tracks.

Port of reference jmodt/tracking/kalman.py:5-104 in plain numpy
(the reference wraps `filterpy.kalman.KalmanFilter`, which is ~20 lines of
linear algebra; the port does not depend on filterpy).  State is
[x, y, z, h, w, l, ry, vx, vy, vz]; the measurement is the 7-dim box.
Includes the orientation-wrap and acute-angle corrections
(kalman.py:48-84), which keep ry continuous across the +-pi seam.

The counterpart of `jmodt_tpu/tracking/kalman.py`.  The filter runs on
the host: 10x10 matrices a track are far below a kernel launch's cost,
and the tracker's device work (the affinity matrices) is batched
separately (tracker.py).
"""

from __future__ import annotations

import numpy as np

_DIM_X, _DIM_Z = 10, 7

_F = np.eye(_DIM_X)
_F[0, 7] = _F[1, 8] = _F[2, 9] = 1.0
_H = np.eye(_DIM_Z, _DIM_X)


def _wrap(theta: float) -> float:
    """Wrap into [-pi, pi) the way the reference does (kalman.py:49-52)."""
    if theta >= np.pi:
        theta -= 2 * np.pi
    if theta < -np.pi:
        theta += 2 * np.pi
    return theta


class Kalman:
    """One track's motion model (reference Kalman, kalman.py:5-104)."""

    def __init__(self, bbox_3d: np.ndarray):
        self.x = np.zeros(_DIM_X)
        self.x[:7] = np.asarray(bbox_3d, np.float64).reshape(7)
        # covariance init (kalman.py:38-41): P = 10*I, velocities x1000
        self.P = np.eye(_DIM_X) * 10.0
        self.P[7:, 7:] *= 1000.0
        self.Q = np.eye(_DIM_X)
        self.Q[7:, 7:] *= 0.01
        self.R = np.eye(_DIM_Z)

    def predict(self, t: int = 1) -> np.ndarray:
        """Advance t steps; returns the predicted 7-dim box (kalman.py:85-95)."""
        for _ in range(int(t)):
            self.x = _F @ self.x
            self.P = _F @ self.P @ _F.T + self.Q
        self.x[6] = _wrap(self.x[6])
        return self.x[:7].copy()

    def update(self, bbox_3d: np.ndarray) -> None:
        """Measurement update with orientation correction (kalman.py:43-83)."""
        z = np.asarray(bbox_3d, np.float64).reshape(7).copy()
        self.x[6] = _wrap(self.x[6])
        z[6] = _wrap(z[6])

        # if the two angles differ by a non-acute angle, flip the track's
        # heading by pi (kalman.py:63-69)
        if np.pi / 2.0 < abs(z[6] - self.x[6]) < np.pi * 3 / 2.0:
            self.x[6] = _wrap(self.x[6] + np.pi)
        # convert a >270-degree gap into the equivalent <90 one (kalman.py:72-76)
        if abs(z[6] - self.x[6]) >= np.pi * 3 / 2.0:
            self.x[6] += 2 * np.pi if z[6] > 0 else -2 * np.pi

        y = z - _H @ self.x
        S = _H @ self.P @ _H.T + self.R
        K = self.P @ _H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(_DIM_X) - K @ _H) @ self.P
        self.x[6] = _wrap(self.x[6])

    def get_box(self) -> np.ndarray:
        return self.x[:7].copy()

    def get_predicted_box(self) -> np.ndarray:
        return (_F @ self.x)[:7]


class KalmanPSR:
    """Position/size/rotation variant with full 3-axis rotation state
    [px, py, pz, sx, sy, sz, rx, ry, rz, vx, vy, vz] (port of the
    reference's unused KalmanPSR, kalman.py:107-203)."""

    _DX, _DZ = 12, 9

    def __init__(self, psr: np.ndarray):
        self.F = np.eye(self._DX)
        self.F[0, 9] = self.F[1, 10] = self.F[2, 11] = 1.0
        self.H = np.eye(self._DZ, self._DX)
        self.x = np.zeros(self._DX)
        self.x[:9] = np.asarray(psr, np.float64).reshape(9)
        self.P = np.eye(self._DX) * 10.0
        self.P[9:, 9:] *= 1000.0
        self.Q = np.eye(self._DX)
        self.Q[9:, 9:] *= 0.01
        self.R = np.eye(self._DZ)

    @staticmethod
    def _rotation_correction(rot: np.ndarray) -> np.ndarray:
        for i in range(3):
            if rot[i] >= np.pi:
                rot[i] -= 2 * np.pi
            elif rot[i] < -np.pi:
                rot[i] += 2 * np.pi
        return rot

    def _rotation_acute_correction(self, psr: np.ndarray) -> None:
        for i in (6, 7, 8):
            if np.pi / 2.0 < abs(psr[i] - self.x[i]) < np.pi * 3 / 2.0:
                self.x[i] = _wrap(self.x[i] + np.pi)
            if abs(psr[i] - self.x[i]) >= np.pi * 3 / 2.0:
                self.x[i] += 2 * np.pi if psr[i] > 0 else -2 * np.pi

    def predict(self, t: int = 1) -> np.ndarray:
        for _ in range(int(t)):
            self.x = self.F @ self.x
            self.P = self.F @ self.P @ self.F.T + self.Q
        self.x[6:9] = self._rotation_correction(self.x[6:9])
        return self.x[:9].copy()

    def update(self, psr: np.ndarray) -> None:
        z = np.asarray(psr, np.float64).reshape(9).copy()
        z[6:9] = self._rotation_correction(z[6:9])
        self._rotation_acute_correction(z)
        y = z - self.H @ self.x
        s = self.H @ self.P @ self.H.T + self.R
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        self.P = (np.eye(self._DX) - k @ self.H) @ self.P
        self.x[6:9] = self._rotation_correction(self.x[6:9])

    def get_box(self) -> np.ndarray:
        return self.x[:9].copy()

    def get_predicted_box(self) -> np.ndarray:
        return (self.F @ self.x)[:9]
