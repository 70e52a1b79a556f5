"""The detection step and the recall counters (counterparts of
`jmodt_tpu/models/inference.py::make_detection_step` and `make_recall_fn`):
the PointRCNN eval forward, RCNN box decode, sigmoid scoring, score
threshold and rotated NMS, with fixed-shape outputs, and the bbox recall of
its decoded boxes and RoIs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench.reference.config import Config
from perfbench.reference.device import resolve_device, upload
from perfbench.reference.models.bbox_codec import decode_bbox_target
from perfbench.reference.models.point_rcnn import PointRCNN
from perfbench.reference.ops.geometry import boxes3d_to_bev
from perfbench.reference.ops.nms import nms_bev_batched

# ImageNet stats, applied in the step when it receives a raw uint8 image
_IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def detections(cfg: Config, mode: str, out: Dict[str, torch.Tensor],
               b: int) -> Dict[str, torch.Tensor]:
    """The detection step's outputs from a PointRCNN forward's `out` of a
    batch of `b` frames: the RCNN box decode, sigmoid scores, the score
    threshold and the rotated NMS of all frames in one call."""
    m = cfg.mode_cfg(mode).RPN_POST_NMS_TOP_N
    mc = cfg.mode_cfg(mode)
    dev = out['rois'].device
    anchor = torch.tensor(cfg.mean_size, device=dev)
    rois = out['rois']                                  # (B, M, 7)
    rcnn_cls = out['rcnn_cls'].reshape(b, m)
    rcnn_reg = out['rcnn_reg'].reshape(b, m, -1)
    rcnn_feat = out['rcnn_feat'].reshape(b, m, -1)
    if cfg.USE_IOU_BRANCH:
        iou_branch = out['rcnn_iou_branch'].reshape(b, m)
        rcnn_cls = torch.clamp(iou_branch, min=1e-4) * rcnn_cls

    pred_boxes = decode_bbox_target(
        rois.reshape(-1, 7), rcnn_reg.reshape(b * m, -1),
        anchor_size=anchor,
        loc_scope=cfg.RCNN.LOC_SCOPE,
        loc_bin_size=cfg.RCNN.LOC_BIN_SIZE,
        num_head_bin=cfg.RCNN.NUM_HEAD_BIN,
        get_xz_fine=True, get_y_by_bin=cfg.RCNN.LOC_Y_BY_BIN,
        loc_y_scope=cfg.RCNN.LOC_Y_SCOPE,
        loc_y_bin_size=cfg.RCNN.LOC_Y_BIN_SIZE,
        get_ry_fine=True, avg_by_bin=mc.BBOX_AVG_BY_BIN,
        ry_with_bin=mc.RY_WITH_BIN).reshape(b, m, 7)

    norm_scores = torch.sigmoid(rcnn_cls)
    inds = (norm_scores > cfg.RCNN.SCORE_THRESH) & out['roi_mask']
    keep_idx, keep = nms_bev_batched(
        boxes3d_to_bev(pred_boxes), rcnn_cls, cfg.RCNN.NMS_THRESH,
        max_keep=m, valid=inds, rotated=True)
    k = keep_idx.long()
    boxes, feats = (torch.gather(x, 1, k[..., None].expand(
        -1, -1, x.shape[-1])) for x in (pred_boxes, rcnn_feat))
    scores = torch.gather(norm_scores, 1, k)
    packed = torch.cat([boxes, scores[..., None],
                        keep.to(boxes.dtype)[..., None], feats], dim=-1)
    return {'boxes': boxes, 'scores': scores, 'feats': feats,
            'keep': keep, 'rois': rois, 'roi_mask': out['roi_mask'],
            'pred_boxes_all': pred_boxes,
            'seg_result': out['seg_result'], 'packed': packed}


def make_detection_step(cfg: Config, model: PointRCNN, device=None):
    """Returns `step(pts, img, xy) -> dict` on `device` (default: the CUDA
    card; raises without one), which the model is moved to.  Inputs are
    numpy arrays or tensors: pts (B, N, 3), img (B, H, W, 3) float32
    (already normalized) or raw uint8, xy (B, N, 2).  Outputs: boxes
    (B, M, 7), scores (B, M), feats (B, M, 512), keep (B, M) bool (the
    survivors of score threshold + rotated NMS, descending score), rois,
    roi_mask, pred_boxes_all, seg_result and `packed`
    [boxes | score | keep | feats]."""
    dev = resolve_device(device)
    model.to(dev).eval()
    mean = torch.tensor(_IMG_MEAN, device=dev)
    std = torch.tensor(_IMG_STD, device=dev)

    @torch.no_grad()
    def step(pts, img, xy) -> Dict[str, torch.Tensor]:
        pts = upload(pts, dev)
        xy = upload(xy, dev)
        if img is not None:
            img = upload(img, dev)
            if img.dtype == torch.uint8:
                img = (img.float() / 255.0 - mean) / std
        out = model(pts, img, xy)
        return detections(cfg, model.mode, out, pts.shape[0])

    return step


