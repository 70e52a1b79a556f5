"""Proposal generation and eval RoI pooling (counterpart of the eval half of
`jmodt_tpu/models/proposal.py`).

Fixed-size buffers with validity masks instead of variable-length tensors;
invalid rows are zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jmodt_torch.config import Config
from jmodt_torch.models.bbox_codec import decode_bbox_target
from jmodt_torch.ops.geometry import boxes3d_to_bev, rotate_points_along_y
from jmodt_torch.ops.grouping import first_k_true
from jmodt_torch.ops.nms import nms_bev
from jmodt_torch.ops.roipool3d import roipool3d


def first_k_indices(mask: torch.Tensor, k: int):
    """First k true positions of a 1-D `mask`, in order; (idx (k,) int64,
    valid (k,) bool), idx 0 where invalid."""
    idx = first_k_true(mask, k)
    valid = idx < mask.shape[0]
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


class Proposals(NamedTuple):
    boxes: torch.Tensor    # (B, POST_N, 7), invalid rows zero
    scores: torch.Tensor   # (B, POST_N) raw rpn scores, invalid rows zero
    mask: torch.Tensor     # (B, POST_N) bool


def _nms_select(cand_boxes, cand_scores, valid, post, thresh, rotated):
    keep, kmask = nms_bev(boxes3d_to_bev(cand_boxes), cand_scores, thresh,
                          max_keep=post, valid=valid, rotated=rotated)
    keep = keep.long()
    boxes = torch.where(kmask[:, None], cand_boxes[keep],
                        torch.zeros_like(cand_boxes[keep]))
    scores = torch.where(kmask, cand_scores[keep],
                         torch.zeros_like(cand_scores[keep]))
    return boxes, scores, kmask


def _distance_zone_proposal(scores, proposals, pre_n, post_n, thresh,
                            rotated):
    """Two-zone distance-based proposal for one frame: scores (N,),
    proposals (N, 7) -> ((post_n, 7), (post_n,), (post_n,))."""
    order = torch.argsort(-scores, stable=True)
    s = scores[order]
    p = proposals[order]
    dist = p[:, 2]
    m1 = (dist > 0.0) & (dist <= 40.0)
    m2 = (dist > 40.0) & (dist <= 80.0)

    n = scores.shape[0]
    pre1 = min(int(pre_n * 0.7), n)
    pre2 = min(pre_n - int(pre_n * 0.7), n)
    post1 = int(post_n * 0.7)
    post2 = post_n - post1

    idx1, v1 = first_k_indices(m1, pre1)
    # zone 2, or, when it is empty, zone 1's ranks [pre1 : pre1 + pre2]
    if bool(m2.any()):
        idx2, v2 = first_k_indices(m2, pre2)
    else:
        k_f = min(pre1 + pre2, n)
        idx_f, v_f = first_k_indices(m1, k_f)
        idx2 = torch.zeros(pre2, dtype=idx_f.dtype, device=idx_f.device)
        v2 = torch.zeros(pre2, dtype=torch.bool, device=idx_f.device)
        idx2[:k_f - pre1] = idx_f[pre1:]
        v2[:k_f - pre1] = v_f[pre1:]

    outs = []
    neg_inf = torch.tensor(float('-inf'), dtype=s.dtype, device=s.device)
    for idx, v, post in ((idx1, v1, post1), (idx2, v2, post2)):
        outs.append(_nms_select(p[idx], torch.where(v, s[idx], neg_inf), v,
                                post, thresh, rotated))
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def _score_zone_proposal(scores, proposals, pre_n, post_n, thresh, rotated):
    """Plain score-ranked proposal for one frame."""
    order = torch.argsort(-scores, stable=True)
    idx = order[:min(pre_n, scores.shape[0])]
    return _nms_select(proposals[idx], scores[idx], None, post_n, thresh,
                       rotated)


def proposal_layer(cfg: Config, mode: str, rpn_scores: torch.Tensor,
                   rpn_reg: torch.Tensor, xyz: torch.Tensor) -> Proposals:
    """Decode per-point bin regressions into boxes and select RoIs.

    :param rpn_scores: (B, N) raw logits; :param rpn_reg: (B, N, C)
    :param xyz: (B, N, 3)
    """
    mc = cfg.mode_cfg(mode)
    b, n = rpn_scores.shape
    anchor = torch.tensor(cfg.mean_size, device=xyz.device)
    props = decode_bbox_target(
        xyz.reshape(-1, 3), rpn_reg.reshape(-1, rpn_reg.shape[-1]),
        anchor_size=anchor,
        loc_scope=cfg.RPN.LOC_SCOPE, loc_bin_size=cfg.RPN.LOC_BIN_SIZE,
        num_head_bin=cfg.RPN.NUM_HEAD_BIN, get_xz_fine=cfg.RPN.LOC_XZ_FINE,
        get_y_by_bin=False, get_ry_fine=False,
        avg_by_bin=mc.BBOX_AVG_BY_BIN, ry_with_bin=mc.RY_WITH_BIN)
    # y becomes the center of the bottom face
    props[:, 1] += props[:, 3] / 2
    props = props.reshape(b, n, 7)
    if mc.RPN_DISTANCE_BASED_PROPOSE:
        fn, rotated = _distance_zone_proposal, cfg.RPN.NMS_TYPE == 'rotate'
    else:
        fn, rotated = _score_zone_proposal, True
    frames = [fn(rpn_scores[i], props[i], mc.RPN_PRE_NMS_TOP_N,
                 mc.RPN_POST_NMS_TOP_N, mc.RPN_NMS_THRESH, rotated)
              for i in range(b)]
    boxes, scores, mask = (torch.stack(parts) for parts in zip(*frames))
    return Proposals(boxes, scores, mask)


def pool_rois_for_eval(cfg: Config, rpn_xyz, rpn_features, seg_mask,
                       pts_depth, roi_boxes3d):
    """Eval-time RoI pooling + canonical transform.

    :return: pts_input (B * M, NUM_POINTS, 3 + C) float32
    """
    rc = cfg.RCNN
    extra = [seg_mask[..., None]]
    if rc.USE_DEPTH:
        extra.append((pts_depth / 70.0 - 0.5)[..., None])
    pts_feature = torch.cat(extra + [rpn_features.float()], dim=2)
    pooled, _ = roipool3d(rpn_xyz, pts_feature, roi_boxes3d,
                          rc.POOL_EXTRA_WIDTH, sampled_pt_num=rc.NUM_POINTS)
    centered = pooled[..., 0:3] - roi_boxes3d[:, :, None, 0:3]
    centered = rotate_points_along_y(centered, roi_boxes3d[..., 6])
    pooled = torch.cat([centered, pooled[..., 3:]], dim=-1)
    return pooled.reshape(-1, rc.NUM_POINTS, pooled.shape[-1])
