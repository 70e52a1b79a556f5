"""Online per-sequence multi-object tracker with its tracks on the host
(counterpart of `jmodt_tpu/tracking/tracker.py`, port of reference
jmodt/tracking/tracker.py).

The split is the JAX package's:

  * device (`make_affinity_fn`, on the tracker's device, the CUDA card by
    default): |pred - det| correlation, link head + bidirectional softmax,
    rotated IoU3D, normalized centre distance and the start / end scores,
    everything matrix-shaped;
  * host: Kalman predict / update, the discrete assignment solver and the
    track lifecycle (`tracking/{kalman,track,data_association}.py`).

The JAX package pads the track and detection counts to shape buckets so
its jitted affinity compiles once a bucket; the port runs its tensor ops at
the frame's own counts, so its masks are all true and nothing is padded.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch
from torch import nn

from jmodt_torch.device import resolve_device
from jmodt_torch.models.rcnn import masked_bidirectional_softmax
from jmodt_torch.ops.geometry import boxes_center_dist_affinity
from jmodt_torch.ops.rotated_iou import boxes_iou3d
from jmodt_torch.tracking.data_association import hungarian_match, mip_solve
from jmodt_torch.tracking.track import Track


def make_affinity_fn(link_head: nn.Module, se_head: nn.Module,
                     w_app: float, w_iou: float, w_dis: float,
                     device=None) -> Callable:
    """The per-frame device program on `device` (default: the CUDA card;
    raises without one), to which the heads are moved.  `link_head` /
    `se_head` map (..., C) correlation features to (..., 1) raw scores.

    affinity(pred_feats (P, C), det_feats (D, C), pred_boxes (P, 7),
    det_boxes (D, 7)) -> host numpy (combined (P, D), start (D,), end (P,))
    in one device-to-host copy."""
    dev = resolve_device(device)
    link_head.to(dev).eval()
    se_head.to(dev).eval()

    @torch.no_grad()
    def affinity(pred_feats, det_feats, pred_boxes, det_boxes):
        pf, df, pb, db = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                          for x in (pred_feats, det_feats, pred_boxes,
                                    det_boxes))
        p, d = pf.shape[0], df.shape[0]
        cor = (pf[:, None, :] - df[None, :, :]).abs()
        link_raw = link_head(cor)[..., 0]
        link = masked_bidirectional_softmax(
            link_raw, torch.ones(p, dtype=torch.bool, device=dev),
            torch.ones(d, dtype=torch.bool, device=dev))
        iou = boxes_iou3d(pb, db)
        dis = boxes_center_dist_affinity(pb, db)
        combined = link * w_app + iou * w_iou + dis * w_dis
        start = torch.sigmoid(se_head(cor.mean(0))[..., 0])      # (D,)
        end = torch.sigmoid(se_head(cor.mean(1))[..., 0])        # (P,)
        out = torch.cat([combined.reshape(-1), start, end]).cpu().numpy()
        return (out[:p * d].reshape(p, d), out[p * d:p * d + d],
                out[p * d + d:])

    return affinity


class Tracker:
    """Reference Tracker (tracker.py:8-143).  `link_head` / `se_head` take
    (..., C) features and return (..., 1) raw scores; they run on `device`
    (default: the CUDA card; raises without one)."""

    def __init__(self, link_head: nn.Module, se_head: nn.Module,
                 t_miss: int = 2, t_hit: int = 0, w_cls: float = 100.0,
                 w_app: float = 2.0, w_iou: float = 10.0, w_dis: float = 10.0,
                 w_se: float = 1.0, hungarian: bool = False,
                 score_thresh: float = 0.0, match_thresh: float = 0.0,
                 device=None):
        self.t_miss = t_miss
        self.t_hit = t_hit
        self.w_cls = w_cls
        self.w_se = w_se
        self.hungarian = hungarian
        self.score_thresh = score_thresh
        self.match_thresh = match_thresh
        self._affinity = make_affinity_fn(link_head, se_head, w_app, w_iou,
                                          w_dis, device)
        self.tracks: List[Track] = []
        self.frame_count = 0
        self.last_frame_idx = 0

    def reset(self):
        self.tracks = []
        self.frame_count = 0
        self.last_frame_idx = 0
        Track.new_id = 1

    def track_management(self):
        """Emit confirmed live tracks and prune dead ones (tracker.py:35-46)."""
        results = []
        for idx in reversed(range(len(self.tracks))):
            trk = self.tracks[idx]
            if trk.hits >= self.t_hit or self.frame_count <= self.t_hit:
                if trk.misses == 0:
                    results.append(trk.get_data())
            if trk.misses >= self.t_miss:
                self.tracks.pop(idx)
        return results

    def update(self, frame_id: int, boxes_3d: np.ndarray,
               det_scores: np.ndarray, det_features: np.ndarray,
               frame_detections: Sequence) -> List:
        """One frame (reference tracker.py:48-143).  boxes_3d (D, 7),
        det_scores (D,), det_features (D, C); frame_detections is the
        per-detection payload carried into the output rows."""
        num_det = len(det_scores)
        num_pred = len(self.tracks)
        if num_det == 0:
            return []

        passed = frame_id - self.last_frame_idx
        self.frame_count += passed
        self.last_frame_idx = frame_id

        if num_pred == 0:
            for d in range(num_det):
                self.tracks.append(Track(
                    bbox=boxes_3d[d], score=det_scores[d],
                    feature=det_features[d], info=frame_detections[d]))
            return self.track_management()

        pred_boxes, pred_scores, pred_feats = [], [], []
        for trk in self.tracks:
            box, score, feat = trk.predict(passed)
            pred_boxes.append(box)
            pred_scores.append(score)
            pred_feats.append(np.asarray(feat))
        pred_boxes = np.stack(pred_boxes).astype(np.float32)
        pred_scores = np.asarray(pred_scores, np.float32)
        pred_feats = np.stack(pred_feats).astype(np.float32)
        det_features = np.asarray(det_features, np.float32)
        boxes_3d = np.asarray(boxes_3d, np.float32)

        link_matrix, start, end = self._affinity(pred_feats, det_features,
                                                 pred_boxes, boxes_3d)

        if self.hungarian:
            matched, unmatched, tentative = hungarian_match(
                link_matrix, det_scores,
                score_threshold=self.score_thresh,
                match_threshold=self.match_thresh)
        else:
            cls_scores = self.w_cls * (
                np.concatenate([pred_scores, det_scores]) - 1.0)
            start_scores = np.concatenate([np.zeros(num_pred),
                                           self.w_se * start])
            end_scores = np.concatenate([self.w_se * end,
                                         np.zeros(num_det)])
            matched, unmatched, tentative = mip_solve(
                cls_scores, link_matrix, start_scores, end_scores)

        for t, d in matched:
            self.tracks[t].update_with_feature(
                boxes_3d[d], det_features[d], det_scores[d],
                info=frame_detections[d])
        for i in unmatched:
            self.tracks.append(Track(
                bbox=boxes_3d[i], feature=det_features[i],
                score=det_scores[i], info=frame_detections[i]))
        for i in tentative:
            trk = Track(bbox=boxes_3d[i], feature=det_features[i],
                        score=det_scores[i], info=frame_detections[i])
            trk.misses += 1
            self.tracks.append(trk)
        return self.track_management()
