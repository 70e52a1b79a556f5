"""Joint detection + tracking, one step per frame (counterpart of
`jmodt_tpu/pipeline.py`): the detection step, the top-K detections by
score, and the device tracker's step, packed into one (T, 10) tensor of
rows [tid, x, y, z, h, w, l, ry, score, emit].

The heads are `nn.Module`s that hold their weights; the JAX package passes
its weights as runtime arguments instead, for its TPU runtime's program
cache, which is no part of the semantics.
"""

from __future__ import annotations

from collections import deque

import torch
from torch import nn

from jmodt_torch.config import Config
from jmodt_torch.device import resolve_device
from jmodt_torch.models.inference import make_detection_step
from jmodt_torch.models.point_rcnn import PointRCNN
from jmodt_torch.tracking.device_tracker import (init_state,
                                                 make_device_tracker_step)


def make_joint_step(cfg: Config, model: PointRCNN, link_head: nn.Module,
                    track_k: int = 16, det_score_thresh: float = 0.85,
                    device=None, **tracker_kw):
    """`joint(state, frame_id, pts, img, xy) -> (state, packed (T, 10))` on
    `device` (default: the CUDA card; raises without one), to which the
    model and heads are moved.  `tracker_kw` goes to
    `make_device_tracker_step`."""
    dev = resolve_device(device)
    det_step = make_detection_step(cfg, model, device=dev)
    trk_step = make_device_tracker_step(link_head, device=dev, **tracker_kw)

    @torch.no_grad()
    def joint(state, frame_id, pts, img, xy):
        det = det_step(pts, img, xy)
        scores = torch.where(det['keep'][0], det['scores'][0], -1.0)
        # top-K with the lower index first among equal scores (masked rows
        # are all -1): a stable descending sort
        top = torch.sort(scores, descending=True, stable=True).indices
        top = top[:track_k]
        det_scores = scores[top]
        state, out = trk_step(state, frame_id, det['boxes'][0][top],
                              det_scores, det['feats'][0][top],
                              det_scores > det_score_thresh)
        packed = torch.cat([out['tid'].float()[:, None], out['box'],
                            out['score'][:, None],
                            out['emit'].float()[:, None]], dim=1)
        return state, packed

    return joint


class JointPipeline:
    """Streams frames through the joint step and reads each frame's rows
    back `fetch_lag` frames later."""

    def __init__(self, cfg: Config, model: PointRCNN, link_head: nn.Module,
                 feat_dim: int, max_tracks: int = 64, track_k: int = 16,
                 fetch_lag: int = 4, det_score_thresh: float = 0.85,
                 device=None, **tracker_kw):
        self.device = resolve_device(device)
        self.joint = make_joint_step(cfg, model, link_head, track_k=track_k,
                                     det_score_thresh=det_score_thresh,
                                     device=self.device, **tracker_kw)
        self.max_tracks = max_tracks
        self.feat_dim = feat_dim
        self.fetch_lag = fetch_lag
        self.reset()

    def reset(self):
        self.state = init_state(self.max_tracks, self.feat_dim, self.device)
        self._pending = deque()

    def push(self, frame_id: int, pts, img, xy):
        """Submit one frame; returns the (frame_id, rows) of the frame
        `fetch_lag` steps back, or None while the pipeline fills.  A row is
        (tid, box (7,), score)."""
        self.state, packed = self.joint(self.state, frame_id, pts, img, xy)
        self._pending.append((frame_id, packed))
        if len(self._pending) > self.fetch_lag:
            return self._materialize(*self._pending.popleft())
        return None

    def flush(self):
        """The results of the frames still pending."""
        out = [self._materialize(fid, p) for fid, p in self._pending]
        self._pending.clear()
        return out

    @staticmethod
    def _materialize(frame_id, packed):
        arr = packed.cpu().numpy()
        rows = arr[arr[:, 9] > 0.5]
        return frame_id, [(int(r[0]), r[1:8], float(r[8])) for r in rows]
