"""3D box geometry on tensors (counterpart of `jmodt_tpu/ops/geometry.py`).

KITTI rect-camera convention: boxes3d (N, 7) = [x, y, z, h, w, l, ry], where
(x, y, z) is the center of the box bottom face, y points down and ry rotates
around the (downward) y axis.  Everything stays float32.
"""

from __future__ import annotations

import torch


def rotate_points_along_y(pts: torch.Tensor, angle: torch.Tensor
                          ) -> torch.Tensor:
    """Rotate the x (0) and z (2) channels of `pts` (..., 3 + C) around y:
    x' = x cos - z sin, z' = x sin + z cos.  `angle` is a scalar or has the
    leading dims of `pts` without the point dim (e.g. (N,) for (N, P, 3))."""
    angle = torch.as_tensor(angle, dtype=pts.dtype, device=pts.device)
    c, s = torch.cos(angle), torch.sin(angle)
    for _ in range(pts.dim() - 1 - angle.dim()):
        c, s = c[..., None], s[..., None]
    x, z = pts[..., 0], pts[..., 2]
    out = pts.clone()
    out[..., 0] = x * c - z * s
    out[..., 2] = x * s + z * c
    return out


def boxes3d_to_corners3d(boxes3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) boxes -> (..., 8, 3) corners: the bottom face (y = y_c) first,
    then the top face (y = y_c - h), each going (+l/2, +w/2), (+l/2, -w/2),
    (-l/2, -w/2), (-l/2, +w/2) in local (x = length, z = width) coordinates
    before the ry rotation x' = c x + s z, z' = -s x + c z."""
    h, w, l = boxes3d[..., 3], boxes3d[..., 4], boxes3d[..., 5]
    zeros = torch.zeros_like(l)
    x_c = torch.stack([l / 2, l / 2, -l / 2, -l / 2,
                       l / 2, l / 2, -l / 2, -l / 2], dim=-1)
    y_c = torch.stack([zeros, zeros, zeros, zeros, -h, -h, -h, -h], dim=-1)
    z_c = torch.stack([w / 2, -w / 2, -w / 2, w / 2,
                       w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    c = torch.cos(boxes3d[..., 6])[..., None]
    s = torch.sin(boxes3d[..., 6])[..., None]
    x_r = c * x_c + s * z_c
    z_r = -s * x_c + c * z_c
    return torch.stack([x_r, y_c, z_r], dim=-1) + boxes3d[..., None, 0:3]


def boxes3d_to_bev(boxes3d: torch.Tensor) -> torch.Tensor:
    """Boxes to BEV [x1, y1, x2, y2, ry] in the x-z plane: the unrotated
    extent centered at (x, z); the rotated IoU re-applies ry."""
    cu, cv = boxes3d[..., 0], boxes3d[..., 2]
    half_l, half_w = boxes3d[..., 5] / 2, boxes3d[..., 4] / 2
    return torch.stack([cu - half_l, cv - half_w, cu + half_l, cv + half_w,
                        boxes3d[..., 6]], dim=-1)


def enlarge_box3d(boxes3d: torch.Tensor, extra_width: float) -> torch.Tensor:
    """Grow each box by `extra_width` per side: sizes + 2w, bottom y + w."""
    out = boxes3d.clone()
    out[..., 3:6] += extra_width * 2
    out[..., 1] += extra_width
    return out


def height_overlap(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                   ) -> torch.Tensor:
    """Pairwise vertical (y) overlap length, (..., M, 7) x (..., N, 7) ->
    (..., M, N); a box spans [y - h, y]."""
    a_min = (boxes_a[..., 1] - boxes_a[..., 3])[..., :, None]
    a_max = boxes_a[..., 1][..., :, None]
    b_min = (boxes_b[..., 1] - boxes_b[..., 3])[..., None, :]
    b_max = boxes_b[..., 1][..., None, :]
    return torch.clamp(torch.minimum(a_max, b_max)
                       - torch.maximum(a_min, b_min), min=0.0)


def boxes_center_dist_affinity(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                               ) -> torch.Tensor:
    """1 - |center_a - center_b| / (the largest corner-to-corner distance
    of the pair), (..., M, 7) x (..., N, 7) -> (..., M, N)."""
    ca = boxes3d_to_corners3d(boxes_a)                  # (..., M, 8, 3)
    cb = boxes3d_to_corners3d(boxes_b)                  # (..., N, 8, 3)
    center = torch.linalg.norm(boxes_a[..., :, None, :3]
                               - boxes_b[..., None, :, :3], dim=-1)
    corner = torch.linalg.norm(ca[..., :, None, :, None, :]
                               - cb[..., None, :, None, :, :], dim=-1)
    corner = corner.flatten(-2).amax(-1)
    return 1.0 - center / corner


def points_in_boxes3d(pts: torch.Tensor, boxes3d: torch.Tensor,
                      max_dis: float = 10.0) -> torch.Tensor:
    """Point-in-rotated-box test, (N, 3) points x (M, 7) boxes -> (M, N)
    bool, with the 10 m coarse rejection in x/z."""
    x, y, z = pts[:, 0][None, :], pts[:, 1][None, :], pts[:, 2][None, :]
    cx = boxes3d[:, 0][:, None]
    bottom_y = boxes3d[:, 1][:, None]
    cz = boxes3d[:, 2][:, None]
    h = boxes3d[:, 3][:, None]
    w = boxes3d[:, 4][:, None]
    l = boxes3d[:, 5][:, None]
    ry = boxes3d[:, 6][:, None]
    cy = bottom_y - h / 2.0
    coarse = ((x - cx).abs() <= max_dis) & ((y - cy).abs() <= h / 2.0) & \
             ((z - cz).abs() <= max_dis)
    cosa, sina = torch.cos(ry), torch.sin(ry)
    x_rot = (x - cx) * cosa - (z - cz) * sina
    z_rot = (x - cx) * sina + (z - cz) * cosa
    fine = (x_rot >= -l / 2.0) & (x_rot <= l / 2.0) & \
           (z_rot >= -w / 2.0) & (z_rot <= w / 2.0)
    return coarse & fine
