"""KITTI label-line record (counterpart of `jmodt_tpu/utils/object3d.py`,
port of reference jmodt/utils/object3d.py).

Note the reference's converted tracking labels smuggle the global track id
through the 16th (score) field (reference object3d.py:18 read at
kitti_dataset.py:279); `score` carries that dual meaning here too.
"""

from __future__ import annotations

import numpy as np


class Object3d:
    def __init__(self, line: str):
        label = line.strip().split(' ')
        self.cls_type = label[0]
        self.truncation = float(label[1])
        self.occlusion = float(label[2])
        self.alpha = float(label[3])
        self.box2d = np.array((float(label[4]), float(label[5]),
                               float(label[6]), float(label[7])),
                              dtype=np.float32)
        self.h = float(label[8])
        self.w = float(label[9])
        self.l = float(label[10])
        self.pos = np.array((float(label[11]), float(label[12]),
                             float(label[13])), dtype=np.float32)
        self.dis_to_cam = float(np.linalg.norm(self.pos))
        self.ry = float(label[14])
        self.score = float(label[15]) if len(label) == 16 else -1.0

    @property
    def box3d(self) -> np.ndarray:
        """[x, y, z, h, w, l, ry] in rect camera coords."""
        return np.array([*self.pos, self.h, self.w, self.l, self.ry],
                        dtype=np.float32)

    def to_kitti_format(self) -> str:
        return ('%s %d %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f '
                '%.2f %.2f %.2f') % (
            self.cls_type, int(self.truncation), int(self.occlusion),
            self.alpha, self.box2d[0], self.box2d[1], self.box2d[2],
            self.box2d[3], self.h, self.w, self.l,
            self.pos[0], self.pos[1], self.pos[2], self.ry)


def get_objects_from_label(label_file: str):
    """Reference kitti_utils.get_objects_from_label."""
    with open(label_file, 'r') as f:
        lines = f.readlines()
    return [Object3d(line) for line in lines if line.strip()]
