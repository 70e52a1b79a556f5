"""Rotated-rectangle intersection for BEV boxes, and the BEV and 3D IoUs
built on it (counterpart of `jmodt_tpu/ops/rotated_iou.py`).

Green's-theorem form: each box's edges are clipped against the other
rectangle with branchless Liang-Barsky and the segment shoelace terms are
summed; no candidate buffers and no sort.  Every function broadcasts over
leading dims, so one call computes a whole (t, N) block of IoUs.

BEV box format (..., 5): [x1, y1, x2, y2, angle], the axis-aligned extent
around the box center, rotated by `angle` about that center.
"""

from __future__ import annotations

import torch

from jmodt_torch.ops.geometry import boxes3d_to_bev, height_overlap

EPS = 1e-8
# closed/open convention for shared boundaries: A's edges clip against B
# grown by +tol, B's edges against A shrunk by -tol, so a segment on both
# boundaries counts once
_TOL = 1e-5


def _box_corners(box: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2) rotated corners (x1,y1), (x2,y1), (x2,y2),
    (x1,y2), each (dx, dy) -> (dx c + dy s, -dx s + dy c) about the center."""
    x1, y1, x2, y2, ang = box.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    xs = torch.stack([x1, x2, x2, x1], dim=-1)
    ys = torch.stack([y1, y1, y2, y2], dim=-1)
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    cx, cy = cx[..., None], cy[..., None]
    nx = (xs - cx) * c + (ys - cy) * s + cx
    ny = -(xs - cx) * s + (ys - cy) * c + cy
    return torch.stack([nx, ny], dim=-1)


def _axes_half(box: torch.Tensor):
    """Local u/v axes (..., 2, 2), half extents (..., 2), center (..., 2)."""
    c, s = torch.cos(box[..., 4]), torch.sin(box[..., 4])
    u = torch.stack([c, -s], dim=-1)
    v = torch.stack([s, c], dim=-1)
    half = torch.stack([(box[..., 2] - box[..., 0]) / 2,
                        (box[..., 3] - box[..., 1]) / 2], dim=-1)
    center = torch.stack([(box[..., 0] + box[..., 2]) / 2,
                          (box[..., 1] + box[..., 3]) / 2], dim=-1)
    return torch.stack([u, v], dim=-2), half, center


def _edge_clip_shoelace_about(corners, other, half, center):
    """Sum of shoelace terms of `corners`' (..., 4, 2) directed edges
    clipped to the rotated rect (axes `other` (..., 2, 2), `half` (..., 2),
    centered at `center` (..., 2), all in the corners' frame)."""
    p = corners
    q = torch.roll(corners, -1, dims=-2)
    rel_p = p - center[..., None, :]
    rel_q = q - center[..., None, :]
    o = other[..., None, :, :]                    # (..., 1, 2, 2)
    pu = rel_p[..., 0] * o[..., 0, 0] + rel_p[..., 1] * o[..., 0, 1]
    pv = rel_p[..., 0] * o[..., 1, 0] + rel_p[..., 1] * o[..., 1, 1]
    qu = rel_q[..., 0] * o[..., 0, 0] + rel_q[..., 1] * o[..., 0, 1]
    qv = rel_q[..., 0] * o[..., 1, 0] + rel_q[..., 1] * o[..., 1, 1]
    hu, hv = half[..., 0:1], half[..., 1:2]
    t0 = torch.zeros_like(pu)
    t1 = torch.ones_like(pu)
    for d0, d1 in ((pu - hu, qu - hu), (-pu - hu, -qu - hu),
                   (pv - hv, qv - hv), (-pv - hv, -qv - hv)):
        denom = d0 - d1
        safe = torch.where(denom.abs() > EPS, denom, torch.ones_like(denom))
        t = d0 / safe
        entering = (d0 > 0) & (d1 <= 0)
        leaving = (d0 <= 0) & (d1 > 0)
        outside = (d0 > 0) & (d1 > 0)
        t0 = torch.where(entering, torch.maximum(t0, t), t0)
        t1 = torch.where(leaving, torch.minimum(t1, t), t1)
        t1 = torch.where(outside, torch.full_like(t1, -1.0), t1)
    ok = t1 > t0
    a = p + t0[..., None] * (q - p)
    b = p + t1[..., None] * (q - p)
    shoe = a[..., 0] * b[..., 1] - b[..., 0] * a[..., 1]
    return torch.where(ok, shoe, torch.zeros_like(shoe)).sum(-1)


def box_overlap_bev(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of rotated BEV boxes, broadcast over leading dims:
    (..., 5) x (..., 5) -> (...)."""
    box_a, box_b = torch.broadcast_tensors(box_a, box_b)
    ca = _box_corners(box_a)
    cb = _box_corners(box_b)
    axes_b, half_b, center_b = _axes_half(box_b)
    axes_a, half_a, center_a = _axes_half(box_a)
    # one common origin (center_b) for every shoelace term keeps the f32
    # products small
    sum_a = _edge_clip_shoelace_about(ca - center_b[..., None, :], axes_b,
                                      half_b + _TOL,
                                      torch.zeros_like(center_b))
    sum_b = _edge_clip_shoelace_about(cb - center_b[..., None, :], axes_a,
                                      half_a - _TOL, center_a - center_b)
    area = (sum_a + sum_b).abs() / 2.0
    # cap at the smaller rect area (f32 roundoff on near-identical boxes)
    cap = torch.minimum((box_a[..., 2] - box_a[..., 0])
                        * (box_a[..., 3] - box_a[..., 1]),
                        (box_b[..., 2] - box_b[..., 0])
                        * (box_b[..., 3] - box_b[..., 1]))
    return torch.minimum(area, cap.abs())


def _area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                      ) -> torch.Tensor:
    """Pairwise rotated intersection areas, (..., M, 5) x (..., N, 5) ->
    (..., M, N)."""
    return box_overlap_bev(boxes_a[..., :, None, :], boxes_b[..., None, :, :])


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise rotated BEV IoU, (M, 5) x (N, 5) -> (M, N)."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    sa = _area(boxes_a)[:, None]
    sb = _area(boxes_b)[None, :]
    return overlap / torch.clamp(sa + sb - overlap, min=EPS)


def boxes_iou_normal(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                     ) -> torch.Tensor:
    """Pairwise axis-aligned BEV IoU ignoring the angle, (M, 5) x (N, 5)."""
    a, b = boxes_a[:, None, :], boxes_b[None, :, :]
    left = torch.maximum(a[..., 0], b[..., 0])
    right = torch.minimum(a[..., 2], b[..., 2])
    top = torch.maximum(a[..., 1], b[..., 1])
    bottom = torch.minimum(a[..., 3], b[..., 3])
    inter = (torch.clamp(right - left, min=0.0)
             * torch.clamp(bottom - top, min=0.0))
    sa = _area(boxes_a)[:, None]
    sb = _area(boxes_b)[None, :]
    return inter / torch.clamp(sa + sb - inter, min=EPS)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                ) -> torch.Tensor:
    """Pairwise 3D IoU: rotated BEV overlap x height overlap over the
    volume union, (..., M, 7) x (..., N, 7) [x, y, z, h, w, l, ry] ->
    (..., M, N)."""
    overlap = (boxes_overlap_bev(boxes3d_to_bev(boxes_a),
                                 boxes3d_to_bev(boxes_b))
               * height_overlap(boxes_a, boxes_b))
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    vol_a, vol_b = vol_a[..., :, None], vol_b[..., None, :]
    return overlap / torch.clamp(vol_a + vol_b - overlap, min=1e-7)
