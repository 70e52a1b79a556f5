"""Bin-based 3D box decoding (counterpart of
`jmodt_tpu/models/bbox_codec.py::decode_bbox_target`).

Per-row regression layout:

  [x_bin (K) | z_bin (K) | x_res (K) | z_res (K) | y_offset (1) or y bins
   | ry_bin (H) | ry_res (H) | size_res (3)]

with K = 2 * loc_scope / loc_bin_size and H = num_head_bin.
"""

from __future__ import annotations

import math

import torch

from jmodt_torch.ops.geometry import rotate_points_along_y


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[:, None])[:, 0]


def decode_bbox_target(roi_box3d: torch.Tensor,
                       pred_reg: torch.Tensor,
                       anchor_size: torch.Tensor,
                       loc_scope: float,
                       loc_bin_size: float,
                       num_head_bin: int,
                       get_xz_fine: bool = True,
                       get_y_by_bin: bool = False,
                       loc_y_scope: float = 0.5,
                       loc_y_bin_size: float = 0.25,
                       get_ry_fine: bool = False,
                       avg_by_bin: bool = True,
                       ry_with_bin: bool = False) -> torch.Tensor:
    """Decode bin regressions into boxes.

    :param roi_box3d: (N, 3) anchor points or (N, 7) RoI boxes; a 7-dim RoI
        adds the canonical -> global un-rotation.
    :param pred_reg: (N, C) regression output
    :param anchor_size: (3,) mean (h, w, l)
    :return: (N, 7) [x, y, z, h, w, l, ry]
    """
    per_loc_bin_num = int(loc_scope / loc_bin_size) * 2
    loc_y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    dt = pred_reg.dtype
    x_bin_l, x_bin_r = 0, per_loc_bin_num
    z_bin_l, z_bin_r = per_loc_bin_num, per_loc_bin_num * 2
    start_offset = z_bin_r

    if not avg_by_bin:
        x_bin = torch.argmax(pred_reg[:, x_bin_l:x_bin_r], dim=1)
        z_bin = torch.argmax(pred_reg[:, z_bin_l:z_bin_r], dim=1)
        pos_x = x_bin.to(dt) * loc_bin_size + loc_bin_size / 2 - loc_scope
        pos_z = z_bin.to(dt) * loc_bin_size + loc_bin_size / 2 - loc_scope
        if get_xz_fine:
            x_res_l, x_res_r = per_loc_bin_num * 2, per_loc_bin_num * 3
            z_res_l, z_res_r = per_loc_bin_num * 3, per_loc_bin_num * 4
            start_offset = z_res_r
            pos_x = pos_x + _take(pred_reg[:, x_res_l:x_res_r],
                                  x_bin) * loc_bin_size
            pos_z = pos_z + _take(pred_reg[:, z_res_l:z_res_r],
                                  z_bin) * loc_bin_size
    else:
        assert get_xz_fine, 'avg_by_bin decode requires fine xz residuals'
        x_res_l, x_res_r = per_loc_bin_num * 2, per_loc_bin_num * 3
        z_res_l, z_res_r = per_loc_bin_num * 3, per_loc_bin_num * 4
        start_offset = z_res_r
        pred_x_bin = torch.softmax(pred_reg[:, x_bin_l:x_bin_r], dim=1)
        pred_z_bin = torch.softmax(pred_reg[:, z_bin_l:z_bin_r], dim=1)
        bin_center = (torch.arange(per_loc_bin_num, dtype=dt,
                                   device=pred_reg.device)
                      * loc_bin_size + loc_bin_size / 2 - loc_scope)
        pred_x_abs = bin_center[None, :] + \
            pred_reg[:, x_res_l:x_res_r] * loc_bin_size
        pred_z_abs = bin_center[None, :] + \
            pred_reg[:, z_res_l:z_res_r] * loc_bin_size
        pos_x = (pred_x_abs * pred_x_bin).sum(1)
        pos_z = (pred_z_abs * pred_z_bin).sum(1)

    if get_y_by_bin:
        y_bin_l, y_bin_r = start_offset, start_offset + loc_y_bin_num
        y_res_l, y_res_r = y_bin_r, y_bin_r + loc_y_bin_num
        start_offset = y_res_r
        y_bin = torch.argmax(pred_reg[:, y_bin_l:y_bin_r], dim=1)
        y_res = _take(pred_reg[:, y_res_l:y_res_r], y_bin) * loc_y_bin_size
        pos_y = (y_bin.to(dt) * loc_y_bin_size + loc_y_bin_size / 2
                 - loc_y_scope + y_res) + roi_box3d[:, 1]
    else:
        y_offset_l = start_offset
        start_offset = y_offset_l + 1
        pos_y = roi_box3d[:, 1] + pred_reg[:, y_offset_l]

    ry_bin_l, ry_bin_r = start_offset, start_offset + num_head_bin
    ry_res_l, ry_res_r = ry_bin_r, ry_bin_r + num_head_bin
    if not ry_with_bin:
        ry_bin = torch.argmax(pred_reg[:, ry_bin_l:ry_bin_r], dim=1)
        ry_res_norm = _take(pred_reg[:, ry_res_l:ry_res_r], ry_bin)
        if get_ry_fine:
            angle_per_class = (math.pi / 2) / num_head_bin
            ry_res = ry_res_norm * (angle_per_class / 2)
            ry = (ry_bin.to(dt) * angle_per_class
                  + angle_per_class / 2) + ry_res - math.pi / 4
        else:
            angle_per_class = (2 * math.pi) / num_head_bin
            ry_res = ry_res_norm * (angle_per_class / 2)
            ry = torch.remainder(ry_bin.to(dt) * angle_per_class + ry_res,
                                 2 * math.pi)
            ry = torch.where(ry > math.pi, ry - 2 * math.pi, ry)
    else:
        ry_bin_p = torch.softmax(pred_reg[:, ry_bin_l:ry_bin_r], dim=1)
        ry_res_norm = pred_reg[:, ry_res_l:ry_res_r]
        bin_ind = torch.arange(num_head_bin, dtype=dt, device=pred_reg.device)
        if get_ry_fine:
            angle_per_class = (math.pi / 2) / num_head_bin
            ry_all = (bin_ind[None, :] * angle_per_class
                      + angle_per_class / 2) \
                + ry_res_norm * (angle_per_class / 2) - math.pi / 4
            right = ry_all >= 0
        else:
            angle_per_class = (2 * math.pi) / num_head_bin
            ry_all = torch.remainder(
                bin_ind[None, :] * angle_per_class
                + ry_res_norm * (angle_per_class / 2), 2 * math.pi)
            right = ry_all <= math.pi
        zero = torch.zeros_like(ry_bin_p)
        p_r = torch.where(right, ry_bin_p, zero).sum(1) + 1e-7
        p_l = torch.where(~right, ry_bin_p, zero).sum(1) + 1e-7
        ry_r = torch.where(right, ry_all * ry_bin_p, zero).sum(1) / p_r
        ry_l = torch.where(~right, ry_all * ry_bin_p, zero).sum(1) / p_l
        ry = torch.where(p_r >= p_l, ry_r, ry_l)
        if not get_ry_fine:
            ry = torch.where(ry > math.pi, ry - 2 * math.pi, ry)

    size_res_l, size_res_r = ry_res_r, ry_res_r + 3
    assert size_res_r == pred_reg.shape[1], \
        f'regression channels {pred_reg.shape[1]} != expected {size_res_r}'
    hwl = pred_reg[:, size_res_l:size_res_r] * anchor_size[None, :] \
        + anchor_size[None, :]

    shifted = torch.cat([pos_x[:, None], pos_y[:, None], pos_z[:, None], hwl,
                         ry[:, None]], dim=1)
    if roi_box3d.shape[1] == 7:
        roi_ry = roi_box3d[:, 6]
        shifted = rotate_points_along_y(shifted, -roi_ry)
        shifted[:, 6] += roi_ry
    shifted[:, 0] += roi_box3d[:, 0]
    shifted[:, 2] += roi_box3d[:, 2]
    return shifted
