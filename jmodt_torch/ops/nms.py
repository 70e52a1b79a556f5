"""Greedy BEV NMS with a fixed-size keep buffer (counterpart of
`jmodt_tpu/ops/nms.py::nms_bev`, and of its `jax.vmap` over problems).

`nms_bev_batched` runs P independent problems in one call.  On CUDA
tensors it launches N1 (`csrc/nms.cu`): the boxes in each problem's score
order, a pair-suppression bitmask and one scan a problem over it, with no
read back to the host.  On CPU tensors it runs the plain version, the JAX
package's block-speculative rounds: each round takes the top-`block`
surviving candidates, computes their IoU rows against all N boxes at once,
resolves suppression inside the block greedily, and retires all `block`
candidates.  Greedy status depends only on strictly-higher-ranked kept
boxes, so both are exactly the one-at-a-time greedy result.  The plain
version's `while_loop` is a Python loop with host reads each round.

NMS yields indices only, so the inputs are detached.
"""

from __future__ import annotations

import torch

from jmodt_torch.ops import kernels
from jmodt_torch.ops.rotated_iou import boxes_iou_bev, boxes_iou_normal
from jmodt_torch.utils.trace import spanned

TILE = 64                  # N1: boxes a tile, bits a mask word
MAX_WORDS = 32 * 16        # N1's scan holds 16 mask words a lane


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
            max_keep: int, valid: torch.Tensor | None = None,
            rotated: bool = True):
    """Greedy BEV NMS of one problem: `nms_bev_batched` at P = 1.

    :param boxes: (N, 5) [x1, y1, x2, y2, ry]
    :param scores: (N,) ranking key; equal scores rank the lower index first
    :param thresh: IoU > thresh suppresses
    :param max_keep: size of the keep buffer
    :param valid: optional (N,) bool mask of live candidates
    :param rotated: exact rotated IoU, else axis-aligned
    :return: (keep_idx (max_keep,) int32, keep_mask (max_keep,) bool),
        descending-score order; slots past the survivors are (0, False).
    """
    keep_idx, keep_mask = nms_bev_batched(
        boxes[None], scores[None], thresh, max_keep,
        None if valid is None else valid[None], rotated)
    return keep_idx[0], keep_mask[0]


@spanned('jmodt.kernel.nms')
def nms_bev_batched(boxes: torch.Tensor, scores: torch.Tensor,
                    thresh: float, max_keep: int,
                    valid: torch.Tensor | None = None, rotated: bool = True):
    """Greedy BEV NMS of P independent problems.

    :param boxes: (P, N, 5) [x1, y1, x2, y2, ry]
    :param scores: (P, N), not NaN; :param valid: optional (P, N) bool
    :return: (keep_idx (P, max_keep) int32, keep_mask (P, max_keep) bool),
        each row as `nms_bev` gives it.
    """
    boxes, scores = boxes.detach(), scores.detach()
    valid = None if valid is None else valid.detach()
    if kernels.on_card(boxes):
        return _nms_kernel(boxes, scores, thresh, max_keep, valid, rotated)
    return nms_bev_batched_plain(boxes, scores, thresh, max_keep, valid,
                                 rotated)


def nms_bev_batched_plain(boxes, scores, thresh, max_keep, valid=None,
                          rotated=True):
    """N1's plain version: the blocked rounds, problem after problem."""
    rows = [_nms_rounds(boxes[i], scores[i], thresh, max_keep,
                        None if valid is None else valid[i], rotated)
            for i in range(boxes.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*rows))


def _nms_rounds(boxes, scores, thresh, max_keep, valid, rotated, block=8):
    """One problem's blocked rounds (the JAX `while_loop`), with host reads
    of the block's flags each round."""
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


def kernel_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) BEV boxes -> (..., 6) [x1, y1, x2, y2, cos ry, sin ry], N1's
    layout; the cosine and sine are PyTorch's, as the plain IoU takes them."""
    ang = boxes[..., 4]
    return torch.stack([boxes[..., 0], boxes[..., 1], boxes[..., 2],
                        boxes[..., 3], torch.cos(ang), torch.sin(ang)],
                       dim=-1).contiguous()


def _nms_kernel(boxes, scores, thresh, max_keep, valid, rotated):
    p, n = scores.shape
    boxes = boxes.contiguous()
    kernels.check_cuda('nms boxes', boxes, torch.float32, (p, n, 5))
    if -(-n // TILE) > MAX_WORDS:
        raise ValueError(f'nms: {n} candidates exceed N1\'s '
                         f'{MAX_WORDS * TILE}')
    dev = boxes.device
    key = scores if valid is None else torch.where(valid, scores,
                                                   float('-inf'))
    vals, order = torch.sort(key.float(), dim=-1, descending=True,
                             stable=True)
    sorted_boxes = kernel_boxes(torch.gather(
        boxes, 1, order[..., None].expand(-1, -1, 5)))
    mask = torch.empty((p, n, -(-n // TILE)), dtype=torch.int64, device=dev)
    keep_idx = torch.empty((p, max_keep), dtype=torch.int32, device=dev)
    keep_mask = torch.empty((p, max_keep), dtype=torch.bool, device=dev)
    vals, order = vals.contiguous(), order.contiguous()
    kernels.launch('nms', sorted_boxes.data_ptr(), vals.data_ptr(),
                   order.data_ptr(), p, n, max_keep, thresh, int(rotated),
                   mask.data_ptr(), keep_idx.data_ptr(), keep_mask.data_ptr(),
                   device=dev)
    return keep_idx, keep_mask


def pair_iou(a: torch.Tensor, b: torch.Tensor, rotated: bool = True
             ) -> torch.Tensor:
    """IoU(a[k], b[k]) of (M, 5) boxes as N1's mask grid computes it (its
    debug entry), for holding it to the plain IoU on the card."""
    kernels.check_cuda('pair_iou a', a, torch.float32, (None, 5))
    kernels.check_cuda('pair_iou b', b, torch.float32, (a.shape[0], 5))
    out = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    ka, kb = kernel_boxes(a), kernel_boxes(b)
    kernels.launch('nms_iou', ka.data_ptr(), kb.data_ptr(),
                   a.shape[0], int(rotated), out.data_ptr(), device=a.device)
    return out
