"""Loss composition, the optimizer, and the train and val steps
(counterpart of `jmodt_tpu/train/train_step.py`).

The optimizer is the JAX package's optax chain written out
(`make_optimizer`): on the trainable parameters only, a global-norm clip
g * min(1, c / |g|) (as `optax.clip_by_global_norm` computes it, so not
`clip_grad_norm_`, which divides by |g| + 1e-6), then AdamW (b1 0.9, b2
0.999, eps 1e-8, decoupled weight decay), at the per-epoch cosine
staircase read at the step count before its increment.  Frozen parameters
get no update and no decay (the JAX package zeroes the updates that
`optax.masked` would pass through, CLAUDE.md).  Under TRAIN.FINETUNE only
the link / se heads train; the RCNN trunk still gets its gradient through
their backprop, which `grad_norm` counts as the JAX package's does, but
stays out of the optimizer.

Randomness: step `s` draws its RoI sampling from a CPU generator and its
dropout masks from one on the device, both seeded by (seed, s), so a
resumed run draws what an unbroken one would, and the card and the CPU
sample the same RoIs.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from jmodt_torch.config import Config
from jmodt_torch.device import resolve_device
from jmodt_torch.losses import (get_reg_loss, masked_mean,
                                sigmoid_cross_entropy_with_logits,
                                sigmoid_focal_loss)
from jmodt_torch.models.proposal import sample_roi_draws

# the keys of a train batch the step reads (make_pair_batch's)
BATCH_KEYS = ('pts_input', 'img', 'pts_xy', 'gt_boxes3d', 'gt_tids',
              'rpn_cls_label', 'rpn_reg_label')


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _sanitize(x):
    """Zero out NaN / Inf and return (clean, finite mask)."""
    finite = torch.isfinite(x)
    return torch.where(finite, x, torch.zeros_like(x)), finite


def rpn_loss_fn(cfg: Config, rpn_cls, rpn_reg, rpn_cls_label, rpn_reg_label
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RPN loss.

    :param rpn_cls: (B, N, 1) logits; :param rpn_reg: (B, N, C)
    :param rpn_cls_label: (B, N) int {-1, 0, 1}
    :param rpn_reg_label: (B, N, 7)
    """
    cls_flat, cls_finite = _sanitize(rpn_cls[..., 0].reshape(-1))
    reg_flat, reg_finite = _sanitize(rpn_reg.reshape(-1, rpn_reg.shape[-1]))
    reg_finite = torch.all(reg_finite, dim=-1)
    label_flat = rpn_cls_label.reshape(-1)
    reg_label_flat = rpn_reg_label.reshape(-1, 7)

    pos = ((label_flat > 0) & cls_finite).float()
    neg = ((label_flat == 0) & cls_finite).float()
    if cfg.RPN.LOSS_CLS == 'SigmoidFocalLoss':
        cls_weights = (pos + neg) / torch.clamp(torch.sum(pos), min=1.0)
        loss_cls = torch.sum(sigmoid_focal_loss(
            cls_flat, pos, cls_weights, alpha=cfg.RPN.FOCAL_ALPHA[0],
            gamma=cfg.RPN.FOCAL_GAMMA))
    elif cfg.RPN.LOSS_CLS == 'BinaryCrossEntropy':
        w = torch.where(label_flat > 0, cfg.RPN.FG_WEIGHT, 1.0)
        ce = sigmoid_cross_entropy_with_logits(cls_flat, pos) * w
        loss_cls = masked_mean(ce, (label_flat >= 0) & cls_finite)
    else:
        raise NotImplementedError(cfg.RPN.LOSS_CLS)

    fg_mask = (label_flat > 0) & reg_finite
    reg = get_reg_loss(
        cls_score=torch.sigmoid(cls_flat), pred_reg=reg_flat,
        reg_label=reg_label_flat, fg_mask=fg_mask,
        loc_scope=cfg.RPN.LOC_SCOPE, loc_bin_size=cfg.RPN.LOC_BIN_SIZE,
        num_head_bin=cfg.RPN.NUM_HEAD_BIN, anchor_size=cfg.mean_size,
        get_xz_fine=cfg.RPN.LOC_XZ_FINE, use_cls_score=True,
        iou_loss_type=cfg.TRAIN.IOU_LOSS_TYPE)
    has_fg = (torch.sum(fg_mask) > 0).float()
    # size x3 and IoU x CE_WEIGHT, as the reference weighs them
    loss_reg = (reg.loc_loss + reg.angle_loss + 3.0 * reg.size_loss
                + cfg.TRAIN.CE_WEIGHT * reg.iou_loss) * has_fg
    loss = (loss_cls * cfg.RPN.LOSS_WEIGHT[0]
            + loss_reg * cfg.RPN.LOSS_WEIGHT[1])
    return loss, {'rpn_loss': loss, 'rpn_loss_cls': loss_cls,
                  'rpn_loss_reg': loss_reg, 'rpn_fg_sum': torch.sum(fg_mask)}


def rcnn_loss_fn(cfg: Config, output: Mapping[str, Any]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RCNN and ReID loss of a TRAIN forward's output (with 'targets')."""
    tb: Dict[str, torch.Tensor] = {}
    loss = torch.zeros((), device=output['rcnn_cls'].device)
    if not cfg.TRAIN.FINETUNE:
        targets = output['targets']
        cls_flat, cls_finite = _sanitize(output['rcnn_cls'].reshape(-1))
        reg, reg_finite = _sanitize(output['rcnn_reg'])
        reg_finite = torch.all(reg_finite, dim=-1)
        cls_label = targets.cls_label.float()
        if cfg.RCNN.LOSS_CLS == 'BinaryCrossEntropy':
            ce = sigmoid_cross_entropy_with_logits(
                cls_flat, torch.clamp(cls_label, 0.0, 1.0))
            loss_cls = masked_mean(ce, (cls_label >= 0) & cls_finite)
        elif cfg.RCNN.LOSS_CLS == 'SigmoidFocalLoss':
            pos = ((cls_label > 0) & cls_finite).float()
            neg = ((cls_label == 0) & cls_finite).float()
            w = (pos + neg) / torch.clamp(torch.sum(pos), min=1.0)
            loss_cls = torch.sum(sigmoid_focal_loss(
                cls_flat, pos, w, alpha=cfg.RCNN.FOCAL_ALPHA[0],
                gamma=cfg.RCNN.FOCAL_GAMMA))
        else:
            raise NotImplementedError(cfg.RCNN.LOSS_CLS)

        fg_mask = (targets.reg_valid_mask > 0) & reg_finite & cls_finite
        # SIZE_RES_ON_ROI: size residuals on each RoI's own hwl
        anchor = (targets.roi_boxes3d[:, 3:6] if cfg.RCNN.SIZE_RES_ON_ROI
                  else cfg.mean_size)
        reg_out = get_reg_loss(
            cls_score=torch.sigmoid(cls_flat), pred_reg=reg,
            reg_label=targets.gt_of_rois, fg_mask=fg_mask,
            loc_scope=cfg.RCNN.LOC_SCOPE, loc_bin_size=cfg.RCNN.LOC_BIN_SIZE,
            num_head_bin=cfg.RCNN.NUM_HEAD_BIN, anchor_size=anchor,
            get_xz_fine=True, get_y_by_bin=cfg.RCNN.LOC_Y_BY_BIN,
            loc_y_scope=cfg.RCNN.LOC_Y_SCOPE,
            loc_y_bin_size=cfg.RCNN.LOC_Y_BIN_SIZE, get_ry_fine=True,
            use_cls_score=True, iou_loss_type=cfg.TRAIN.IOU_LOSS_TYPE)
        has_fg = (torch.sum(fg_mask) > 0).float()
        loss_reg = (reg_out.loc_loss + reg_out.angle_loss
                    + 3.0 * reg_out.size_loss
                    + cfg.TRAIN.CE_WEIGHT * reg_out.iou_loss) * has_fg
        loss = loss_cls + loss_reg
        tb.update(rcnn_loss_cls=loss_cls, rcnn_loss_reg=loss_reg,
                  rcnn_reg_fg=torch.sum(fg_mask))

    if cfg.REID.ENABLED and 'reid_link' in output:
        # L1 on the bidirectional-softmaxed link scores and on the sigmoid
        # start / end scores, each a mean over its valid entries
        link_l1 = (output['reid_link'] - output['reid_gt_link']).abs()
        loss_link = masked_mean(link_l1, output['reid_link_mask'])
        start_l1 = (torch.sigmoid(output['reid_start'])
                    - output['reid_gt_start']).abs()
        end_l1 = (torch.sigmoid(output['reid_end'])
                  - output['reid_gt_end']).abs()
        loss_start = masked_mean(start_l1, output['reid_start_mask'])
        loss_end = masked_mean(end_l1, output['reid_end_mask'])
        loss = loss + (loss_link * cfg.TRAIN.LINK_TRAIN_WEIGHT
                       + (loss_start + loss_end) * cfg.TRAIN.SE_TRAIN_WEIGHT)
        tb.update(rcnn_loss_link=loss_link, rcnn_loss_start=loss_start,
                  rcnn_loss_end=loss_end,
                  rcnn_link_pos=torch.sum(output['reid_gt_link'] > 0),
                  rcnn_link_neg=torch.sum((output['reid_gt_link'] == 0)
                                          & output['reid_link_mask']))
    tb['rcnn_loss'] = loss
    return loss, tb


def compute_losses(cfg: Config, output: Mapping[str, Any],
                   batch: Mapping[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total training loss and its terms."""
    tb: Dict[str, torch.Tensor] = {}
    loss = torch.zeros((), device=output['rpn_cls'].device)
    if cfg.RPN.ENABLED and not cfg.RPN.FIXED:
        rpn_loss, rpn_tb = rpn_loss_fn(cfg, output['rpn_cls'],
                                       output['rpn_reg'],
                                       batch['rpn_cls_label'],
                                       batch['rpn_reg_label'])
        loss = loss + rpn_loss * cfg.TRAIN.RPN_TRAIN_WEIGHT
        tb.update(rpn_tb)
    if cfg.RCNN.ENABLED:
        rcnn_loss, rcnn_tb = rcnn_loss_fn(cfg, output)
        loss = loss + rcnn_loss * cfg.TRAIN.RCNN_TRAIN_WEIGHT
        tb.update(rcnn_tb)
        if 'targets' in output:
            tb['max_iou'] = output['targets'].max_iou
    tb['loss'] = loss
    return loss, tb


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def trainable_mask(cfg: Config, model: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: trains}.  Finetune trains only the link / se heads;
    RPN.FIXED also freezes the RPN."""
    out = {}
    for name, _ in model.named_parameters():
        if cfg.TRAIN.FINETUNE:
            train = 'link_layer' in name or 'se_layer' in name
        elif cfg.RPN.FIXED:
            train = not name.startswith('rpn.')
        else:
            train = True
        out[name] = train
    return out


def learning_rate(cfg: Config, step: int, steps_per_epoch: int) -> float:
    """The cosine schedule stepped once an epoch: its value at `step`."""
    t = cfg.TRAIN
    epoch = min(step // max(steps_per_epoch, 1), t.TMAX)
    return t.ETA_MIN + (t.LR - t.ETA_MIN) * 0.5 * (
        1 + math.cos(math.pi * epoch / t.TMAX))


class Optimizer:
    """The JAX package's optax chain on a model's trainable parameters:
    clip by global norm, then AdamW, at `learning_rate`.  `step()` reads
    each trainable parameter's `.grad` (None counts as 0) and leaves every
    other parameter as it is.  `count` is the number of steps taken."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 steps_per_epoch: int):
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        mask = trainable_mask(cfg, model)
        self.names = [n for n, _ in model.named_parameters() if mask[n]]
        named = dict(model.named_parameters())
        self.params = [named[n] for n in self.names]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def lr(self) -> float:
        return learning_rate(self.cfg, self.count, self.steps_per_epoch)

    @torch.no_grad()
    def step(self) -> None:
        t = self.cfg.TRAIN
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if grads:
            # on the device, no host read: min(1, c / |g|) is exactly 1
            # below the clip, and inf (so 1) at |g| = 0
            scale = torch.clamp(t.GRAD_NORM_CLIP / global_norm(grads),
                                max=1.0)
            grads = torch._foreach_mul(grads, scale)
            torch._foreach_mul_(self.mu, self.B1)
            torch._foreach_add_(self.mu, grads, alpha=1 - self.B1)
            torch._foreach_mul_(self.nu, self.B2)
            torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads),
                                alpha=1 - self.B2)
            k = self.count + 1
            mu_hat = torch._foreach_div(self.mu, 1 - self.B1 ** k)
            den = torch._foreach_div(self.nu, 1 - self.B2 ** k)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.EPS)
            upd = torch._foreach_div(mu_hat, den)
            torch._foreach_add_(upd, self.params, alpha=t.WEIGHT_DECAY)
            torch._foreach_add_(self.params, upd, alpha=-self.lr())
        self.count += 1

    def state_dict(self) -> dict:
        return {'count': self.count, 'steps_per_epoch': self.steps_per_epoch,
                'names': list(self.names),
                'mu': {n: m.detach().cpu() for n, m in zip(self.names,
                                                           self.mu)},
                'nu': {n: v.detach().cpu() for n, v in zip(self.names,
                                                           self.nu)}}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        if list(state['names']) != self.names:
            raise ValueError('optimizer state is for other trainable '
                             'parameters')
        for dst, key in ((self.mu, 'mu'), (self.nu, 'nu')):
            for t, n in zip(dst, self.names):
                t.copy_(state[key][n])
        self.count = int(state['count'])


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over `tensors`, float32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_optimizer(cfg: Config, model: torch.nn.Module,
                   steps_per_epoch: int) -> Optimizer:
    return Optimizer(cfg, model, steps_per_epoch)


# --------------------------------------------------------------------------
# train / val step
# --------------------------------------------------------------------------

def step_seed(seed: int, step: int) -> int:
    """The generators' seed for step `step` of a run seeded `seed`."""
    return (seed * 1_000_003 + step) % (1 << 63)


def to_device(batch: Mapping[str, Any], device, non_blocking: bool = False
              ) -> Dict[str, torch.Tensor]:
    """The step's keys of a numpy (or tensor) batch as tensors on
    `device`; with `non_blocking` a CPU array is copied from pinned
    memory without waiting."""
    out = {}
    for k in BATCH_KEYS:
        if k not in batch:
            continue
        t = torch.as_tensor(batch[k])
        if non_blocking and device.type == 'cuda' and t.device.type == 'cpu':
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=non_blocking)
    return out


def _forward(cfg, model, batch, seed, dev):
    """The TRAIN forward of `batch` with the draws of `seed`."""
    b = batch['pts_input'].shape[0]
    draws = sample_roi_draws(cfg, b, cfg.TRAIN.RPN_POST_NMS_TOP_N,
                             torch.Generator().manual_seed(seed), dev)
    dropout = torch.Generator(device=dev).manual_seed(seed)
    return model(batch['pts_input'], batch.get('img'), batch.get('pts_xy'),
                 gt_boxes3d=batch['gt_boxes3d'], gt_tids=batch.get('gt_tids'),
                 draws=draws, generator=dropout)


def make_train_step(cfg: Config, model: torch.nn.Module,
                    optimizer: Optimizer, seed: int = 0,
                    device=None) -> Callable:
    """step(batch) -> {loss term: scalar tensor}: one optimizer step of
    the PointRCNN(mode='TRAIN') `model` over a batch of frame pairs (numpy
    or tensors), on `device` (default: the CUDA card; raises without
    one).  Adds 'grad_norm', the global norm of every parameter's
    gradient."""
    dev = resolve_device(device)

    def train_step(batch):
        model.train()
        batch = to_device(batch, dev)
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            output = _forward(cfg, model, batch,
                              step_seed(seed, optimizer.count), dev)
            loss, tb = compute_losses(cfg, output, batch)
            loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        tb['grad_norm'] = (global_norm(grads) if grads
                           else torch.zeros((), device=dev))
        optimizer.step()
        return tb

    return train_step


def make_val_step(cfg: Config, model: torch.nn.Module, seed: int = 0,
                  device=None) -> Callable:
    """step(batch) -> (loss, {loss term: scalar tensor}): the losses of
    the TRAIN forward with the model in eval mode, without gradients."""
    dev = resolve_device(device)

    @torch.no_grad()
    def val_step(batch):
        model.eval()
        batch = to_device(batch, dev)
        output = _forward(cfg, model, batch, step_seed(seed, 0), dev)
        return compute_losses(cfg, output, batch)

    return val_step


def scalars(tb: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The 0-d entries of a step's result as floats, in one host read."""
    keys = [k for k, v in tb.items() if v.dim() == 0]
    vals = torch.stack([tb[k].float() for k in keys]) if keys else None
    return dict(zip(keys, [] if vals is None else vals.cpu().tolist()))
