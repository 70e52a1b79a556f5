"""RoI-aware point pooling (counterpart of `jmodt_tpu/ops/roipool3d.py`).

Each RoI is enlarged by `pool_extra_width`; the first `sampled_pt_num`
points inside the rotated box (point order) are taken, fewer hits are
duplicate-padded modulo the hit count, and zero hits set the empty flag and
leave the features zero.
"""

from __future__ import annotations

import torch

from perfbench.reference.ops.geometry import enlarge_box3d, points_in_boxes3d
from perfbench.reference.ops.grouping import first_k_true


def roipool3d(pts: torch.Tensor, pts_feature: torch.Tensor,
              boxes3d: torch.Tensor, pool_extra_width: float,
              sampled_pt_num: int = 512):
    """Pool per-RoI point features.

    :param pts: (B, N, 3); :param pts_feature: (B, N, C)
    :param boxes3d: (B, M, 7) RoIs [x, y, z, h, w, l, ry]
    :return: (pooled (B, M, sampled_pt_num, 3 + C), empty_flag (B, M) int32)
    """
    b, n = pts.shape[0], pts.shape[1]
    m = boxes3d.shape[1]
    enlarged = enlarge_box3d(boxes3d, pool_extra_width)
    mask = torch.stack([points_in_boxes3d(pts[i], enlarged[i])
                        for i in range(b)])                    # (B, M, N)
    idx = first_k_true(mask, sampled_pt_num)                   # ascending
    cnt = mask.sum(2)                                          # (B, M)
    # duplicate-pad: slot k >= cnt reads slot k % cnt
    k = torch.arange(sampled_pt_num, device=pts.device)[None, None, :]
    safe_cnt = torch.clamp(cnt, min=1)[:, :, None]
    slot = torch.where(k < safe_cnt, k, k % safe_cnt)
    idx = torch.gather(idx, 2, slot)
    idx = torch.where(cnt[:, :, None] > 0, idx, torch.zeros_like(idx))

    feat = torch.cat([pts, pts_feature], dim=2)                # (B, N, 3 + C)
    c = feat.shape[-1]
    pooled = torch.gather(
        feat, 1, idx.reshape(b, m * sampled_pt_num, 1).expand(-1, -1, c)
    ).reshape(b, m, sampled_pt_num, c)
    empty = cnt == 0
    pooled = torch.where(empty[:, :, None, None],
                         torch.zeros_like(pooled), pooled)
    return pooled, empty.to(torch.int32)
