"""Proposal generation, train-time RoI sampling and eval RoI pooling
(counterpart of `jmodt_tpu/models/proposal.py`).

Fixed-size buffers with validity masks instead of variable-length tensors;
invalid rows are zero.

RoI sampling draws its random numbers up front, as the tensors of a
`RoiDraws`: the JAX PRNG cannot be reproduced in PyTorch, so
`sample_roi_draws` makes them from a seeded CPU `torch.Generator` and moves
them to the device (the card and the CPU then sample the same RoIs), and a
caller may pass any draws instead, such as those the JAX key schedule gives
(tests/test_torch_train_proposal.py rebuilds it).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from jmodt_torch.config import Config
from jmodt_torch.device import upload
from jmodt_torch.models.bbox_codec import decode_bbox_target
from jmodt_torch.ops.geometry import boxes3d_to_bev, rotate_points_along_y
from jmodt_torch.ops.grouping import first_k_true
from jmodt_torch.ops.nms import nms_bev_batched
from jmodt_torch.ops.roipool3d import roipool3d
from jmodt_torch.ops.rotated_iou import boxes_iou3d


_ANCHORS: Dict[tuple, torch.Tensor] = {}


def anchor_tensor(mean_size, device) -> torch.Tensor:
    """`mean_size` as a float32 tensor on `device`, uploaded once a
    process: a CUDA graph that reads it (`utils/graphs.py`) reads it where
    its capture found it, and copies nothing from the host."""
    key = (tuple(float(v) for v in mean_size), torch.device(device))
    t = _ANCHORS.get(key)
    if t is None:
        t = _ANCHORS[key] = upload(key[0], device, torch.float32)
    return t


def first_k_indices(mask: torch.Tensor, k: int):
    """First k true positions along the last dim of `mask`, in order;
    (idx (..., k) int64, valid (..., k) bool), idx 0 where invalid."""
    idx = first_k_true(mask, k)
    valid = idx < mask.shape[-1]
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


class Proposals(NamedTuple):
    boxes: torch.Tensor    # (B, POST_N, 7), invalid rows zero
    scores: torch.Tensor   # (B, POST_N) raw rpn scores, invalid rows zero
    mask: torch.Tensor     # (B, POST_N) bool


def _nms_select(cand_boxes, cand_scores, valid, post, thresh, rotated):
    """NMS of B frames' candidates at once: cand_boxes (B, K, 7),
    cand_scores (B, K), valid (B, K) or None -> the kept ((B, post, 7),
    (B, post), (B, post) bool), invalid rows zero."""
    keep, kmask = nms_bev_batched(boxes3d_to_bev(cand_boxes), cand_scores,
                                  thresh, max_keep=post, valid=valid,
                                  rotated=rotated)
    keep = keep.long()
    boxes = torch.gather(cand_boxes, 1, keep[..., None].expand(-1, -1, 7))
    scores = torch.gather(cand_scores, 1, keep)
    return (torch.where(kmask[..., None], boxes, torch.zeros_like(boxes)),
            torch.where(kmask, scores, torch.zeros_like(scores)), kmask)


def _distance_zone_proposal(scores, proposals, pre_n, post_n, thresh,
                            rotated):
    """Two-zone distance-based proposal for B frames: scores (B, N),
    proposals (B, N, 7) -> ((B, post_n, 7), (B, post_n), (B, post_n)).
    Zone 2 is chosen per frame without a branch, as the JAX package's
    `has2` does."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    s = torch.gather(scores, 1, order)
    p = torch.gather(proposals, 1, order[..., None].expand(-1, -1, 7))
    dist = p[..., 2]
    m1 = (dist > 0.0) & (dist <= 40.0)
    m2 = (dist > 40.0) & (dist <= 80.0)

    n = scores.shape[1]
    pre1 = min(int(pre_n * 0.7), n)
    pre2 = min(pre_n - int(pre_n * 0.7), n)
    post1 = int(post_n * 0.7)
    post2 = post_n - post1

    idx1, v1 = first_k_indices(m1, pre1)
    # zone 2, or, where it is empty, zone 1's ranks [pre1 : pre1 + pre2]
    idx2a, v2a = first_k_indices(m2, pre2)
    k_f = min(pre1 + pre2, n)
    idx_f, v_f = first_k_indices(m1, k_f)
    idx2b = torch.zeros_like(idx2a)
    v2b = torch.zeros_like(v2a)
    idx2b[:, :k_f - pre1] = idx_f[:, pre1:]
    v2b[:, :k_f - pre1] = v_f[:, pre1:]
    has2 = m2.any(-1, keepdim=True)
    idx2 = torch.where(has2, idx2a, idx2b)
    v2 = torch.where(has2, v2a, v2b)

    outs = []
    for idx, v, post in ((idx1, v1, post1), (idx2, v2, post2)):
        cand_boxes = torch.gather(p, 1, idx[..., None].expand(-1, -1, 7))
        cand_scores = torch.where(v, torch.gather(s, 1, idx), float('-inf'))
        outs.append(_nms_select(cand_boxes, cand_scores, v, post, thresh,
                                rotated))
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def _score_zone_proposal(scores, proposals, pre_n, post_n, thresh, rotated):
    """Plain score-ranked proposal for B frames."""
    idx = torch.argsort(-scores, dim=-1, stable=True)[
        :, :min(pre_n, scores.shape[1])]
    return _nms_select(
        torch.gather(proposals, 1, idx[..., None].expand(-1, -1, 7)),
        torch.gather(scores, 1, idx), None, post_n, thresh, rotated)


def proposal_layer(cfg: Config, mode: str, rpn_scores: torch.Tensor,
                   rpn_reg: torch.Tensor, xyz: torch.Tensor) -> Proposals:
    """Decode per-point bin regressions into boxes and select RoIs.

    :param rpn_scores: (B, N) raw logits; :param rpn_reg: (B, N, C)
    :param xyz: (B, N, 3)
    """
    mc = cfg.mode_cfg(mode)
    b, n = rpn_scores.shape
    anchor = anchor_tensor(cfg.mean_size, xyz.device)
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
    return Proposals(*fn(rpn_scores, props, mc.RPN_PRE_NMS_TOP_N,
                         mc.RPN_POST_NMS_TOP_N, mc.RPN_NMS_THRESH, rotated))


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


# --------------------------------------------------------------------------
# Proposal target layer (train-time RoI sampling)
# --------------------------------------------------------------------------

class RoiTargets(NamedTuple):
    """Per-RoI training targets, flattened over (B * ROI_PER_IMAGE)."""
    pts_input: torch.Tensor       # (R, NUM_POINTS, 3 + C) canonical xyz, feats
    roi_boxes3d: torch.Tensor     # (R, 7)
    cls_label: torch.Tensor       # (R,) {1, 0, -1} int32
    mask_score: torch.Tensor      # (R,)
    reg_valid_mask: torch.Tensor  # (R,) {0, 1} int32
    gt_of_rois: torch.Tensor      # (R, 7) canonical gt
    gt_iou: torch.Tensor          # (R,)
    gt_tids: torch.Tensor         # (B, ROI_PER_IMAGE) reid labels (0 = bg)
    max_iou: torch.Tensor         # scalar


class RoiDraws(NamedTuple):
    """The random numbers of one batch's RoI sampling, B frames of M
    proposals, R = ROI_PER_IMAGE picks and T = ROI_FG_AUG_TIMES jitter
    trials.  `aug_pos`, `aug_hwl` and `aug_ang` are uniform in [-1, 1) for
    REG_AUG_METHOD 'multiple', in [-0.5, 0.5) for 'single'; for 'normal'
    `aug_pos` and `aug_hwl` are standard normal and `aug_ang` uniform in
    [-1, 1)."""
    rank_fg: torch.Tensor    # (B, M) uniform [0, 1): order of the fg picks
    rank_hard: torch.Tensor  # (B, M) the hard-background picks
    rank_easy: torch.Tensor  # (B, M) the easy-background picks
    rint1: torch.Tensor      # (B, R) int64 in [0, 2^30): fg replacement slots
    rint2: torch.Tensor      # (B, R) int64 in [0, 2^30): bg slots
    aug_keep: torch.Tensor   # (B, T, R) uniform [0, 1): < 0.2 keeps the RoI
    aug_row: torch.Tensor    # (B, T, R) int64 in [0, 5): range-table row
    aug_pos: torch.Tensor    # (B, T, R, 3) centre shift
    aug_hwl: torch.Tensor    # (B, T, R, 3) size scale
    aug_ang: torch.Tensor    # (B, T, R) heading rotation

    def to(self, device) -> 'RoiDraws':
        return RoiDraws(*(t.to(device) for t in self))


_AUG_RANGE_CONFIG = (
    # pos_range, hwl_range, angle_range
    (0.2, 0.1, math.pi / 12),
    (0.3, 0.15, math.pi / 12),
    (0.5, 0.15, math.pi / 9),
    (0.8, 0.15, math.pi / 6),
    (1.0, 0.15, math.pi / 3),
)


def sample_roi_draws(cfg: Config, b: int, m: int,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> RoiDraws:
    """The draws of one batch's RoI sampling (B frames of M proposals)
    from `generator` (a CPU one), moved to `device`."""
    rc = cfg.RCNN
    r, t = rc.ROI_PER_IMAGE, int(rc.ROI_FG_AUG_TIMES)
    g = generator

    def unif(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g)

    ranks = [unif(b, m) for _ in range(3)]
    rints = [ints(1 << 30, b, r) for _ in range(2)]
    keep, row = unif(b, t, r), ints(len(_AUG_RANGE_CONFIG), b, t, r)
    if rc.REG_AUG_METHOD == 'normal':
        pos = torch.randn((b, t, r, 3), generator=g)
        hwl = torch.randn((b, t, r, 3), generator=g)
        ang = unif(b, t, r, lo=-1.0)
    else:
        half = 0.5 if rc.REG_AUG_METHOD == 'single' else 1.0
        pos, hwl = (unif(b, t, r, 3, lo=-half, hi=half) for _ in range(2))
        ang = unif(b, t, r, lo=-half, hi=half)
    return RoiDraws(*ranks, *rints, keep, row, pos, hwl, ang).to(device)


def random_aug_box3d(box3d, row, pos, hwl, ang, method: str):
    """Jittered copies of boxes (..., 7): a centre shift, a size scale and a
    heading rotation from the draws (`row` (...), `pos` / `hwl` (..., 3),
    `ang` (...)), their magnitude fixed ('single'), from the 5-row range
    table ('multiple', the default) or gaussian ('normal')."""
    dev = box3d.device
    if method == 'single':
        pos_shift = pos
        hwl_scale = hwl * 0.3 + 1.0
        angle_rot = ang * (math.pi / 6)
    elif method == 'multiple':
        tbl = upload(_AUG_RANGE_CONFIG, dev, torch.float32)[row]
        pos_shift = pos * tbl[..., 0:1]
        hwl_scale = hwl * tbl[..., 1:2] + 1.0
        angle_rot = ang * tbl[..., 2]
    elif method == 'normal':
        pos_shift = pos * upload([0.3, 0.2, 0.3], dev)
        hwl_scale = 1.0 + (hwl * upload([0.25, 0.15, 0.5], dev)
                           / torch.clamp(box3d[..., 3:6], min=1e-3))
        angle_rot = ang * (math.pi / 12)
    else:
        raise NotImplementedError(f'REG_AUG_METHOD {method}')
    return torch.cat([box3d[..., 0:3] + pos_shift,
                      box3d[..., 3:6] * hwl_scale,
                      box3d[..., 6:7] + angle_rot[..., None]], dim=-1)


def _pair_iou(a, b):
    """3D IoU of each box of a (..., 7) with the same row of b."""
    return boxes_iou3d(a[..., None, :], b[..., None, :])[..., 0, 0]


def _aug_rois_by_noise(draws: RoiDraws, rois, gt_of, src_iou, max_trials,
                       cfg: Config):
    """RoI jitter, (B, R) at a time.  Per RoI up to `max_trials` trials,
    each keeping the original box with probability 0.2 or drawing a fresh
    jitter of it, stopping once IoU(candidate, gt) >= the foreground
    threshold.  The box becomes the last candidate tried; the IoU falls
    back to the pre-jitter one when no trial ran or the last candidate was
    the kept original.

    :param rois: (B, R, 7) chosen RoIs; :param gt_of: (B, R, 7) their gts
    :param src_iou: (B, R); :param max_trials: (B, R) int trial budget
    """
    rc = cfg.RCNN
    pos_thresh = min(rc.REG_FG_THRESH, rc.CLS_FG_THRESH)
    box, iou = rois, src_iou
    kept_orig = torch.ones_like(src_iou, dtype=torch.bool)
    done = torch.zeros_like(kept_orig)
    for t in range(int(rc.ROI_FG_AUG_TIMES)):
        keep_draw = draws.aug_keep[:, t] < 0.2
        cand = random_aug_box3d(rois, draws.aug_row[:, t],
                                draws.aug_pos[:, t], draws.aug_hwl[:, t],
                                draws.aug_ang[:, t], rc.REG_AUG_METHOD)
        cand = torch.where(keep_draw[..., None], rois, cand)
        cand_iou = _pair_iou(cand, gt_of)
        active = ~done & (t < max_trials)
        box = torch.where(active[..., None], cand, box)
        iou = torch.where(active, cand_iou, iou)
        kept_orig = torch.where(active, keep_draw, kept_orig)
        done = done | (active & (cand_iou >= pos_thresh))
    return box, torch.where((max_trials == 0) | kept_orig, src_iou, iou)


def _random_rank(u, mask, k):
    """The k entries of `mask` (..., M) with the smallest draws `u`, in
    that order, then the others by index (a stable sort: JAX's top_k of
    the negated draws orders ties the same way)."""
    keyed = torch.where(mask, u, torch.full_like(u, 2.0))
    return torch.sort(keyed, dim=-1, stable=True).indices[..., :k]


def _take(x, idx):
    """x (B, M, ...) gathered at idx (B, R) along dim 1."""
    idx = idx.long()
    view = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, view.expand(idx.shape + x.shape[2:]))


def _sample_rois(draws: RoiDraws, rois, gt_boxes, gt_tids, cfg: Config):
    """RoI sampling for B frames at once, ROI_PER_IMAGE picks a frame.

    The JAX package's picks, with its draws: foregrounds in the order of
    their draws, repeated through `rint1` when fewer than needed; the
    background slots split into hard (HARD_BG_RATIO) and easy ones, each
    picked through `rint2` modulo its population from the first R of its
    order, the index clamped into [0, R) as a JAX gather clamps it (this
    favours the R-th when the population is larger than R).

    :param rois: (B, M, 7); :param gt_boxes: (B, G, 7) zero-padded
    :param gt_tids: (B, G)
    :return: (rois (B, R, 7), gts (B, R, 7), IoUs (B, R), tids (B, R))
    """
    rc = cfg.RCNN
    n_roi = rc.ROI_PER_IMAGE
    fg_per_image = int(round(rc.FG_RATIO * n_roi))

    gt_valid = torch.sum(gt_boxes.abs(), dim=-1) > 0
    iou = boxes_iou3d(rois, gt_boxes)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    max_ov = torch.amax(iou, dim=-1)
    assign = torch.argmax(iou, dim=-1)

    fg_thresh = min(rc.REG_FG_THRESH, rc.CLS_FG_THRESH)
    fg_mask = max_ov >= fg_thresh
    easy_bg = max_ov < rc.CLS_BG_THRESH_LO
    hard_bg = (max_ov < rc.CLS_BG_THRESH) & (max_ov >= rc.CLS_BG_THRESH_LO)
    fgn, hbn, ebn = (m.sum(-1, keepdim=True) for m in (fg_mask, hard_bg,
                                                       easy_bg))
    bgn = hbn + ebn

    fg_rank = _random_rank(draws.rank_fg, fg_mask, n_roi)
    hard_rank = _random_rank(draws.rank_hard, hard_bg, n_roi)
    easy_rank = _random_rank(draws.rank_easy, easy_bg, n_roi)

    nf = torch.where(fgn > 0, torch.where(bgn > 0,
                                          torch.clamp(fgn, max=fg_per_image),
                                          torch.full_like(fgn, n_roi)),
                     torch.zeros_like(fgn))
    nb = n_roi - nf
    hard_n = torch.where(
        (hbn > 0) & (ebn > 0),
        (nb.float() * rc.HARD_BG_RATIO).to(nb.dtype),
        torch.where(hbn > 0, nb, torch.zeros_like(nb)))

    j = torch.arange(n_roi, device=rois.device)[None, :]
    last = n_roi - 1

    def pick(rank, slot):
        return torch.gather(rank, 1, torch.clamp(slot, max=last))

    fg_choice = pick(fg_rank, torch.where(
        j < fgn, j, draws.rint1 % torch.clamp(fgn, min=1)))
    hard_choice = pick(hard_rank, draws.rint2 % torch.clamp(hbn, min=1))
    easy_choice = pick(easy_rank, draws.rint2 % torch.clamp(ebn, min=1))
    bg_choice = torch.where(j - nf < hard_n, hard_choice, easy_choice)
    chosen = torch.where(j < nf, fg_choice, bg_choice)

    sel_rois = _take(rois, chosen)
    gt_idx = torch.gather(assign, 1, chosen)
    sel_gt = _take(gt_boxes, gt_idx)
    sel_iou = torch.gather(max_ov, 1, chosen)
    tids = torch.gather(gt_tids, 1, gt_idx)
    if rc.ROI_FG_AUG_TIMES > 0:
        # foreground rows get the whole trial budget, background rows one
        max_trials = torch.where(j < nf,
                                 torch.full_like(chosen, rc.ROI_FG_AUG_TIMES),
                                 torch.ones_like(chosen))
        sel_rois, sel_iou = _aug_rois_by_noise(draws, sel_rois, sel_gt,
                                               sel_iou, max_trials, cfg)
    return sel_rois, sel_gt, sel_iou, tids


def proposal_target_layer(cfg: Config, draws: RoiDraws, rpn_xyz,
                          rpn_features, seg_mask, pts_depth, roi_boxes3d,
                          gt_boxes3d, gt_tids) -> RoiTargets:
    """Train-time RoI sampling, pooling and canonical transform.  The
    pooled features keep their gradient back to `rpn_features` (a gather);
    the sampling itself has none.

    :param draws: the sampling's random numbers (`sample_roi_draws`)
    :param rpn_xyz: (B, N, 3); :param rpn_features: (B, N, C)
    :param seg_mask: (B, N); :param pts_depth: (B, N)
    :param roi_boxes3d: (B, M, 7); :param gt_boxes3d: (B, G, 7)
        zero-padded; :param gt_tids: (B, G)
    """
    rc = cfg.RCNN
    extra = [seg_mask[..., None]]
    if rc.USE_DEPTH:
        extra.append((pts_depth / 70.0 - 0.5)[..., None])
    pts_feature = torch.cat(extra + [rpn_features.float()], dim=2)

    rois, gt_of, roi_iou, tids = _sample_rois(draws, roi_boxes3d, gt_boxes3d,
                                              gt_tids, cfg)
    pooled, empty_flag = roipool3d(rpn_xyz, pts_feature, rois,
                                   rc.POOL_EXTRA_WIDTH,
                                   sampled_pt_num=rc.NUM_POINTS)
    mask_score = torch.sum(pooled[..., 3], dim=-1) / rc.NUM_POINTS

    # canonical transform: RoI centre to the origin, heading to 0
    roi_ry = torch.remainder(rois[..., 6], 2 * math.pi)
    roi_center = rois[..., 0:3]
    sampled_pts = rotate_points_along_y(
        pooled[..., 0:3] - roi_center[:, :, None, :], rois[..., 6])
    gt_ct = torch.cat([gt_of[..., 0:3] - roi_center, gt_of[..., 3:6],
                       gt_of[..., 6:7] - roi_ry[..., None]], dim=-1)
    gt_ct = rotate_points_along_y(gt_ct[:, :, None, :], roi_ry)[:, :, 0]

    valid = empty_flag == 0
    reg_valid_mask = ((roi_iou > rc.REG_FG_THRESH) & valid).to(torch.int32)
    cls_label = (roi_iou > rc.CLS_FG_THRESH).to(torch.int32)
    invalid = (roi_iou > rc.CLS_BG_THRESH) & (roi_iou < rc.CLS_FG_THRESH)
    cls_label = torch.where(~valid | invalid, torch.full_like(cls_label, -1),
                            cls_label)
    tids = torch.where(roi_iou < cfg.REID.FG_THRESH, torch.zeros_like(tids),
                       tids)

    n_pts = rc.NUM_POINTS
    sampled_feats = pooled[..., 3:]
    pts_input = torch.cat([
        sampled_pts.reshape(-1, n_pts, 3),
        sampled_feats.reshape(-1, n_pts, sampled_feats.shape[-1])], dim=2)
    return RoiTargets(
        pts_input=pts_input, roi_boxes3d=rois.reshape(-1, 7),
        cls_label=cls_label.reshape(-1), mask_score=mask_score.reshape(-1),
        reg_valid_mask=reg_valid_mask.reshape(-1),
        gt_of_rois=gt_ct.reshape(-1, 7), gt_iou=roi_iou.reshape(-1),
        gt_tids=tids, max_iou=torch.amax(roi_iou))
