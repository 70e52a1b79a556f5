"""The detection step and the recall counters (counterparts of
`jmodt_tpu/models/inference.py::make_detection_step` and `make_recall_fn`):
the PointRCNN eval forward, RCNN box decode, sigmoid scoring, score
threshold and rotated NMS, with fixed-shape outputs, and the bbox recall of
its decoded boxes and RoIs.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from jmodt_torch.config import Config
from jmodt_torch.device import resolve_device, upload
from jmodt_torch.models.bbox_codec import decode_bbox_target
from jmodt_torch.models.point_rcnn import PointRCNN
from jmodt_torch.ops.geometry import boxes3d_to_bev
from jmodt_torch.ops.nms import nms_bev_batched
from jmodt_torch.ops.rotated_iou import boxes_iou3d
from jmodt_torch.utils.graphs import Section
from jmodt_torch.utils.trace import span

# ImageNet stats, applied in the step when it receives a raw uint8 image
_IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)
# what `_decode` reads of the eval forward's outputs
_DECODE_IN = ('rois', 'rcnn_cls', 'rcnn_reg', 'rcnn_feat', 'rcnn_iou_branch',
              'roi_mask', 'seg_result')


def make_detection_step(cfg: Config, model: PointRCNN, device=None):
    """Returns `step(pts, img, xy) -> dict` on `device` (default: the CUDA
    card; raises without one), which the model is moved to.  Inputs are
    numpy arrays or tensors: pts (B, N, 3), img (B, H, W, 3) float32
    (already normalized) or raw uint8, xy (B, N, 2).  Outputs: boxes
    (B, M, 7), scores (B, M), feats (B, M, 512), keep (B, M) bool (the
    survivors of score threshold + rotated NMS, descending score), rois,
    roi_mask, pred_boxes_all, seg_result and `packed`
    [boxes | score | keep | feats].  On the card the backbone, the rest of
    the eval forward and the decode replay as CUDA graphs
    (`utils/graphs.py`) from a signature's second call on."""
    dev = resolve_device(device)
    model.to(dev).eval()
    m = cfg.mode_cfg(model.mode).RPN_POST_NMS_TOP_N
    mc = cfg.mode_cfg(model.mode)
    mean = torch.tensor(_IMG_MEAN, device=dev)
    std = torch.tensor(_IMG_STD, device=dev)
    anchor = torch.tensor(cfg.mean_size, device=dev)
    decode = Section('decode', functools.partial(_decode, cfg, mc, m,
                                                 anchor))

    @torch.no_grad()
    def step(pts, img, xy) -> Dict[str, torch.Tensor]:
        with span('jmodt.upload'):
            pts = upload(pts, dev)
            xy = upload(xy, dev)
            if img is not None:
                img = upload(img, dev)
                if img.dtype == torch.uint8:
                    img = (img.float() / 255.0 - mean) / std
        with span('jmodt.detection'):
            out = model(pts, img, xy)
            with span('jmodt.detection.decode'):
                return decode(pts.shape[0], {k: out[k] for k in _DECODE_IN
                                             if k in out})

    return step


def _decode(cfg: Config, mc, m: int, anchor: torch.Tensor, b: int,
            out) -> Dict[str, torch.Tensor]:
    """The detection step's outputs from the eval forward's `out`: RCNN box
    decode, sigmoid scoring, score threshold and the final rotated NMS of
    the batch's b frames of m RoIs.  The step runs it as a CUDA graph
    section (`utils/graphs.py`)."""
    rois = out['rois']                                      # (B, M, 7)
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


RECALL_THRESH = (0.1, 0.3, 0.5, 0.7, 0.9)


def make_recall_fn(device=None):
    """Recall bookkeeping on `device` (default: the CUDA card; raises
    without one), reference tools/eval.py:129-168: counts of gt boxes
    recalled at IoU3D thresholds `RECALL_THRESH` by the refined boxes and
    by the raw RoIs.

    Returns `accumulate(acc, det_out, gt_boxes) -> acc`, which adds one
    frame of the detection step's outputs (batch row 0) against gt_boxes
    (G, 7), zero rows being padding, to an (11,) int32 tensor on the
    device, [recalled(5), roi_recalled(5), n_gt], with no host read."""
    dev = resolve_device(device)
    thresh = torch.tensor(RECALL_THRESH, dtype=torch.float32, device=dev)

    def counts(boxes, mask, gt_boxes, gt_mask):
        iou = boxes_iou3d(boxes, gt_boxes)
        iou = torch.where(mask[:, None] & gt_mask[None, :], iou,
                          torch.zeros_like(iou))
        gt_max = iou.amax(0)
        return ((gt_max[None, :] > thresh[:, None])
                & gt_mask[None, :]).sum(1)

    @torch.no_grad()
    def accumulate(acc, det_out, gt_boxes):
        gt_boxes = torch.as_tensor(gt_boxes, dtype=torch.float32,
                                   device=dev)
        gt_mask = gt_boxes.abs().sum(1) > 0
        # pred_boxes_all + roi_mask, not the NMS survivors: the reference
        # counts a gt as recalled if any decoded box covers it, before the
        # score threshold and NMS (tools/eval.py:149-155)
        roi_mask = det_out['roi_mask'][0]
        return acc + torch.cat([
            counts(det_out['pred_boxes_all'][0], roi_mask, gt_boxes,
                   gt_mask),
            counts(det_out['rois'][0], roi_mask, gt_boxes, gt_mask),
            gt_mask.sum()[None]]).to(torch.int32)

    return accumulate
