"""Greedy BEV NMS with a fixed-size keep buffer (counterpart of
`jmodt_tpu/ops/nms.py::nms_bev`).

Block-speculative rounds: each round takes the top-`block` surviving
candidates, computes their IoU rows against all N boxes at once, resolves
suppression inside the block greedily, and retires all `block` candidates.
Greedy status depends only on strictly-higher-ranked kept boxes, so this is
exactly the one-at-a-time greedy result.  The JAX `while_loop` becomes a
Python loop with one host sync per round.
"""

from __future__ import annotations

import torch

from jmodt_torch.ops.rotated_iou import boxes_iou_bev, boxes_iou_normal


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
            max_keep: int, valid: torch.Tensor | None = None,
            rotated: bool = True, block: int = 8):
    """Greedy BEV NMS.

    :param boxes: (N, 5) [x1, y1, x2, y2, ry]
    :param scores: (N,) ranking key; equal scores rank the lower index first
    :param thresh: IoU > thresh suppresses
    :param max_keep: size of the keep buffer
    :param valid: optional (N,) bool mask of live candidates
    :param rotated: exact rotated IoU, else axis-aligned
    :return: (keep_idx (max_keep,) int32, keep_mask (max_keep,) bool),
        descending-score order; slots past the survivors are (0, False).
    """
    n = boxes.shape[0]
    dev = boxes.device
    alive = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
             else valid.clone())
    t = min(block, max_keep, n)
    iou = boxes_iou_bev if rotated else boxes_iou_normal
    keep_idx = torch.zeros(max_keep, dtype=torch.int32, device=dev)
    keep_mask = torch.zeros(max_keep, dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(float('-inf'), dtype=scores.dtype, device=dev)
    count = 0
    while count < max_keep and bool(alive.any()):
        masked = torch.where(alive, scores, neg_inf)
        # stable descending sort: equal scores keep the lower index first
        # (lax.top_k's order)
        vals, order = torch.sort(masked, descending=True, stable=True)
        cand = order[:t]
        ok = (vals[:t] > neg_inf).tolist()
        rows = iou(boxes[cand], boxes)                 # (t, N)
        over = (rows[:, cand] > thresh).tolist()      # (t, t)
        # intra-block greedy: kept iff not suppressed by an earlier kept
        # candidate of this block; capped at the remaining budget
        kept = []
        for i in range(t):
            k = ok[i] and not any(kept[j] and over[j][i] for j in range(i))
            kept.append(k and count + sum(kept) < max_keep)
        kept_t = torch.tensor(kept, dtype=torch.bool, device=dev)
        sup = (kept_t[:, None] & (rows > thresh)).any(0)
        alive &= ~sup
        alive[cand[torch.tensor(ok, dtype=torch.bool, device=dev)]] = False
        n_kept = sum(kept)
        keep_idx[count:count + n_kept] = cand[kept_t].to(torch.int32)
        keep_mask[count:count + n_kept] = True
        count += n_kept
    return keep_idx, keep_mask
