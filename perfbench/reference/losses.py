"""Loss library (counterpart of `jmodt_tpu/losses.py`).

Every reduction is mask-weighted over fixed-shape tensors instead of boolean
indexing: the reference's `pred_reg[fg_mask]` becomes a weighted mean with
`fg_mask` weights, which is the same value for the mean-reduced losses used
here.  A NaN in a masked-out row still reaches the sum (NaN * 0 is NaN), as
in the JAX package; the train step zeroes non-finite rows first.

Every sum over the batch is `batch_sum`: when the batch is split over ranks
(`parallel.mesh`), numerators and denominators are summed over them, so a
mean is the global batch's and not a mean of per-rank means.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from perfbench.reference.parallel import mesh


def sigmoid_cross_entropy_with_logits(logits, labels):
    """max(x, 0) - x * z + log(1 + exp(-|x|))."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits, targets, weights, alpha=0.25, gamma=2.0):
    """Per-element focal CE scaled by `weights`; the caller sums."""
    ce = sigmoid_cross_entropy_with_logits(logits, targets)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    modulating = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    return modulating * alpha_w * ce * weights


def batch_sum(x):
    """torch.sum(x) over the whole batch: summed over the ranks when the
    batch is split, each rank's gradient its own rows' share."""
    return mesh.loss_sum(torch.sum(x))


def dice_loss(logits, target, ignore_target=-1):
    """1 - sum(min(p, t)) / max(1, sum(max(p, t))) over the entries whose
    target is not `ignore_target`."""
    x = torch.sigmoid(logits.reshape(-1))
    t = target.reshape(-1).to(x.dtype)
    mask = (t != ignore_target).to(x.dtype)
    num = batch_sum(torch.minimum(x, t) * mask)
    den = torch.clamp(batch_sum(torch.maximum(x, t) * mask), min=1.0)
    return 1.0 - num / den


def smooth_l1(pred, target):
    """Elementwise Huber with beta = 1."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def masked_mean(values, mask):
    """Mean over the mask-selected elements; 0 when the mask is empty."""
    mask = mask.to(values.dtype)
    return batch_sum(values * mask) / torch.clamp(batch_sum(mask), min=1.0)


def cross_entropy_int_labels(logits, labels, mask):
    """Mask-weighted mean cross entropy with integer labels, logits (N, K)."""
    logp = F.log_softmax(logits, dim=1)
    idx = labels.long().clamp(0, logits.shape[1] - 1)
    nll = -torch.gather(logp, 1, idx[:, None])[:, 0]
    return masked_mean(nll, mask)


class RegLossOut(NamedTuple):
    loc_loss: torch.Tensor
    angle_loss: torch.Tensor
    size_loss: torch.Tensor
    iou_loss: torch.Tensor


def _bin_select(pred, labels, bins):
    """sum(pred * one_hot(labels, bins), 1): the residual of each row's
    label bin (0 for a label outside [0, bins), as jax.nn.one_hot)."""
    one_hot = labels.long()[:, None] == torch.arange(bins,
                                                     device=labels.device)
    return torch.sum(pred * one_hot.to(pred.dtype), 1)


def get_reg_loss(cls_score, pred_reg, reg_label, fg_mask, loc_scope: float,
                 loc_bin_size: float, num_head_bin: int, anchor_size,
                 get_xz_fine: bool = True, get_y_by_bin: bool = False,
                 loc_y_scope: float = 0.5, loc_y_bin_size: float = 0.25,
                 get_ry_fine: bool = False, use_cls_score: bool = False,
                 iou_loss_type: str = 'raw') -> RegLossOut:
    """Bin-based regression loss with its soft-IoU term.

    :param cls_score: (N,) sigmoid scores (for use_cls_score)
    :param pred_reg: (N, C); :param reg_label: (N, 7) [dx, dy, dz, h, w, l,
        ry]; :param fg_mask: (N,) bool, the rows that contribute
    :param anchor_size: (3,) class mean size, or (N, 3) per-row RoI sizes
    """
    per_loc_bin_num = int(loc_scope / loc_bin_size) * 2
    loc_y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    dtype = pred_reg.dtype

    x_off, y_off, z_off = reg_label[:, 0], reg_label[:, 1], reg_label[:, 2]
    x_shift = torch.clamp(x_off + loc_scope, 0, loc_scope * 2 - 1e-3)
    z_shift = torch.clamp(z_off + loc_scope, 0, loc_scope * 2 - 1e-3)
    x_bin_label = torch.floor(x_shift / loc_bin_size).to(torch.int32)
    z_bin_label = torch.floor(z_shift / loc_bin_size).to(torch.int32)

    x_bin_l, x_bin_r = 0, per_loc_bin_num
    z_bin_l, z_bin_r = per_loc_bin_num, per_loc_bin_num * 2
    loc_loss = (cross_entropy_int_labels(pred_reg[:, x_bin_l:x_bin_r],
                                         x_bin_label, fg_mask)
                + cross_entropy_int_labels(pred_reg[:, z_bin_l:z_bin_r],
                                           z_bin_label, fg_mask))

    assert get_xz_fine, 'the reference always uses fine xz for RPN / RCNN'
    x_res_l, x_res_r = per_loc_bin_num * 2, per_loc_bin_num * 3
    z_res_l, z_res_r = per_loc_bin_num * 3, per_loc_bin_num * 4
    start_offset = z_res_r

    x_res_label = x_shift - (x_bin_label.to(dtype) * loc_bin_size
                             + loc_bin_size / 2)
    z_res_label = z_shift - (z_bin_label.to(dtype) * loc_bin_size
                             + loc_bin_size / 2)
    pred_x_res = _bin_select(pred_reg[:, x_res_l:x_res_r], x_bin_label,
                             per_loc_bin_num)
    pred_z_res = _bin_select(pred_reg[:, z_res_l:z_res_r], z_bin_label,
                             per_loc_bin_num)
    loc_loss = (loc_loss
                + masked_mean(smooth_l1(pred_x_res,
                                        x_res_label / loc_bin_size), fg_mask)
                + masked_mean(smooth_l1(pred_z_res,
                                        z_res_label / loc_bin_size), fg_mask))

    if get_y_by_bin:
        y_bin_l, y_bin_r = start_offset, start_offset + loc_y_bin_num
        y_res_l, y_res_r = y_bin_r, y_bin_r + loc_y_bin_num
        start_offset = y_res_r
        y_shift = torch.clamp(y_off + loc_y_scope, 0, loc_y_scope * 2 - 1e-3)
        y_bin_label = torch.floor(y_shift / loc_y_bin_size).to(torch.int32)
        y_res_label = y_shift - (y_bin_label.to(dtype) * loc_y_bin_size
                                 + loc_y_bin_size / 2)
        pred_y = _bin_select(pred_reg[:, y_res_l:y_res_r], y_bin_label,
                             loc_y_bin_num)
        loc_loss = loc_loss + (
            cross_entropy_int_labels(pred_reg[:, y_bin_l:y_bin_r],
                                     y_bin_label, fg_mask)
            + masked_mean(smooth_l1(pred_y, y_res_label / loc_y_bin_size),
                          fg_mask))
    else:
        pred_y = pred_reg[:, start_offset]
        loc_loss = loc_loss + masked_mean(smooth_l1(pred_y, y_off), fg_mask)
        start_offset += 1

    ry_bin_l, ry_bin_r = start_offset, start_offset + num_head_bin
    ry_res_l, ry_res_r = ry_bin_r, ry_bin_r + num_head_bin
    ry_label = reg_label[:, 6]
    if get_ry_fine:
        angle_per_class = (math.pi / 2) / num_head_bin
        ry_label_mod = torch.remainder(ry_label, 2 * math.pi)
        opposite = (ry_label_mod > math.pi * 0.5) & (ry_label_mod
                                                     < math.pi * 1.5)
        ry_label_mod = torch.where(
            opposite, torch.remainder(ry_label_mod + math.pi, 2 * math.pi),
            ry_label_mod)
        shift_angle = torch.remainder(ry_label_mod + math.pi * 0.5,
                                      2 * math.pi)
        shift_angle = torch.clamp(shift_angle - math.pi * 0.25, 1e-3,
                                  math.pi * 0.5 - 1e-3)
    else:
        angle_per_class = (2 * math.pi) / num_head_bin
        heading = torch.remainder(ry_label, 2 * math.pi)
        shift_angle = torch.remainder(heading + angle_per_class / 2,
                                      2 * math.pi)
    ry_bin_label = torch.floor(shift_angle / angle_per_class).to(torch.int32)
    ry_res_label = shift_angle - (ry_bin_label.to(dtype) * angle_per_class
                                  + angle_per_class / 2)
    ry_res_norm_label = ry_res_label / (angle_per_class / 2)
    pred_ry_res = _bin_select(pred_reg[:, ry_res_l:ry_res_r], ry_bin_label,
                              num_head_bin)
    angle_loss = (cross_entropy_int_labels(pred_reg[:, ry_bin_l:ry_bin_r],
                                           ry_bin_label, fg_mask)
                  + masked_mean(smooth_l1(pred_ry_res, ry_res_norm_label),
                                fg_mask))

    size_res_l, size_res_r = ry_res_r, ry_res_r + 3
    assert pred_reg.shape[1] == size_res_r, \
        f'{pred_reg.shape[1]} vs {size_res_r}'
    anchor = torch.as_tensor(anchor_size, dtype=dtype,
                             device=pred_reg.device).expand_as(
                                 reg_label[:, 3:6])
    size_norm_label = (reg_label[:, 3:6] - anchor) / anchor
    size_res_norm = pred_reg[:, size_res_l:size_res_r]
    size_loss = masked_mean(
        torch.mean(smooth_l1(size_res_norm, size_norm_label), dim=1), fg_mask)

    # soft-IoU loss
    pred_size = size_res_norm * anchor + anchor  # hwl
    tar_size = reg_label[:, 3:6]
    if iou_loss_type == 'raw':
        px = pred_x_res * loc_bin_size
        pz = pred_z_res * loc_bin_size
        tx, tz = x_res_label, z_res_label
    elif iou_loss_type == 'cls_mask_with_bin':
        bin_center = (torch.arange(per_loc_bin_num, dtype=dtype,
                                   device=pred_reg.device) * loc_bin_size
                      + loc_bin_size / 2 - loc_scope)
        pxb = torch.softmax(pred_reg[:, x_bin_l:x_bin_r], dim=1)
        pzb = torch.softmax(pred_reg[:, z_bin_l:z_bin_r], dim=1)
        px = torch.sum((bin_center[None, :] + pred_reg[:, x_res_l:x_res_r]
                        * loc_bin_size) * pxb, dim=1)
        pz = torch.sum((bin_center[None, :] + pred_reg[:, z_res_l:z_res_r]
                        * loc_bin_size) * pzb, dim=1)
        tx = bin_center[x_bin_label.long()] + x_res_label
        tz = bin_center[z_bin_label.long()] + z_res_label
    else:
        raise NotImplementedError(iou_loss_type)
    ty, py = y_off, pred_y

    def axis_insect(pc, ps, tc, ts):
        return torch.clamp(torch.minimum(pc + ps / 2, tc + ts / 2)
                           - torch.maximum(pc - ps / 2, tc - ts / 2),
                           min=1e-3)

    # x pairs with size l, y with h, z with w
    insect_area = (axis_insect(px, pred_size[:, 2], tx, tar_size[:, 2])
                   * axis_insect(py, pred_size[:, 0], ty, tar_size[:, 0])
                   * axis_insect(pz, pred_size[:, 1], tz, tar_size[:, 1]))
    pred_area = torch.clamp(pred_size[:, 0] * pred_size[:, 1]
                            * pred_size[:, 2], min=1e-3)
    tar_area = tar_size[:, 0] * tar_size[:, 1] * tar_size[:, 2]
    iou_tmp = insect_area / (pred_area + tar_area - insect_area)
    if use_cls_score:
        iou_tmp = cls_score * iou_tmp
    iou_tmp = torch.clamp(iou_tmp, min=1e-4)
    iou_loss = masked_mean(-torch.log(iou_tmp), fg_mask)
    return RegLossOut(loc_loss, angle_loss, size_loss, iou_loss)
