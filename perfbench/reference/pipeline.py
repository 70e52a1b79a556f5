"""Joint detection + tracking, one step per frame (counterpart of
`jmodt_tpu/pipeline.py`): the detection step, the top-K detections by
score, and the device tracker's step, packed into one (T, 10) tensor of
rows [tid, x, y, z, h, w, l, ry, score, emit].

`make_joint_step` steps one stream; `make_batched_joint_step` steps S
streams in lockstep.

The heads are `nn.Module`s that hold their weights; the JAX package passes
its weights as runtime arguments instead, for its TPU runtime's program
cache, which is no part of the semantics.
"""

from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.config import Config
from perfbench.reference.device import resolve_device
from perfbench.reference.models.inference import make_detection_step
from perfbench.reference.models.point_rcnn import PointRCNN
from perfbench.reference.tracking.device_tracker import (
    make_batched_tracker_step, make_device_tracker_step)


def _top_k(det, track_k: int, det_score_thresh: float):
    """The tracker's inputs from a detection step's output, per frame of
    the batch: the `track_k` best kept detections, (boxes (B, K, 7),
    scores (B, K), feats (B, K, C), mask (B, K))."""
    scores = torch.where(det['keep'], det['scores'], -1.0)       # (B, M)
    # top-K with the lower index first among equal scores (masked rows
    # are all -1): a stable descending sort
    top = torch.sort(scores, dim=-1, descending=True,
                     stable=True).indices[:, :track_k]
    det_scores = torch.gather(scores, 1, top)
    boxes, feats = (torch.gather(det[k], 1, top[..., None].expand(
        -1, -1, det[k].shape[-1])) for k in ('boxes', 'feats'))
    return boxes, det_scores, feats, det_scores > det_score_thresh


def _pack(out) -> torch.Tensor:
    """Rows [tid, x, y, z, h, w, l, ry, score, emit] of a tracker output."""
    return torch.cat([out['tid'].float()[..., None], out['box'],
                      out['score'][..., None],
                      out['emit'].float()[..., None]], dim=-1)



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
        boxes, scores, feats, mask = _top_k(det, track_k, det_score_thresh)
        state, out = trk_step(state, frame_id, boxes[0], scores[0],
                              feats[0], mask[0])
        return state, _pack(out)

    return joint


def make_batched_joint_step(cfg: Config, model: PointRCNN,
                            link_head: nn.Module, track_k: int = 16,
                            det_score_thresh: float = 0.85, device=None,
                            **tracker_kw):
    """S independent streams advance in lockstep: one batched detection
    step over the S frames and one tracker step over the S states (offline
    evaluation over many sequences, several cameras served by one step).

    joint(states, frame_ids (S,), pts (S, N, 3), imgs (S, H, W, 3),
          xys (S, N, 2)) -> (states, packed (S, T, 10))

    on `device` (default: the CUDA card; raises without one).  Build
    `states` with `init_batched_state(S, max_tracks, feat_dim)`; packed
    rows are [tid, x, y, z, h, w, l, ry, score, emit] per stream.
    `tracker_kw` goes to `make_batched_tracker_step`.
    """
    dev = resolve_device(device)
    det_step = make_detection_step(cfg, model, device=dev)
    trk_step = make_batched_tracker_step(link_head, device=dev, **tracker_kw)

    @torch.no_grad()
    def joint(states, frame_ids, pts, imgs, xys):
        det = det_step(pts, imgs, xys)
        states, out = trk_step(states, frame_ids,
                               *_top_k(det, track_k, det_score_thresh))
        return states, _pack(out)

    return joint


