"""Per-track state (port of reference jmodt/tracking/track.py)."""

from __future__ import annotations

import numpy as np

from jmodt_torch.tracking.kalman import Kalman


class Track:
    """id, score, 512-d appearance feature, miss/hit counts, Kalman motion
    (reference track.py:4-53)."""
    new_id = 1

    def __init__(self, bbox: np.ndarray, score: float, info,
                 feature: np.ndarray):
        self.id = Track.new_id
        Track.new_id += 1
        self.motion_model = Kalman(bbox)
        self.score = score
        self.info = info
        self.feature = np.asarray(feature)
        self.misses = 0
        self.hits = 0

    def predict(self, t: int = 1):
        """Advance the motion model; t counts skipped frames
        (reference track.py:17-21 — predict() also increments misses)."""
        self.misses += t
        return self.motion_model.predict(t), self.score, self.feature

    def update_with_feature(self, box, feature, score, info):
        """Matched-detection update (reference track.py:41-46)."""
        self.misses = 0
        self.hits += 1
        self.motion_model.update(box)
        self.info = info
        self.feature = np.asarray(feature)
        self.score = score

    def get_data(self):
        return self.id, self.info, self.score
