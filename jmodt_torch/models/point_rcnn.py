"""PointRCNN composite (counterpart of `jmodt_tpu/models/point_rcnn.py`):
RPN -> proposals -> RoI pooling (eval) or RoI sampling (train) -> RCNN.

Mode 'EVAL' / 'TEST' is the eval forward, under `torch.no_grad()`.  Mode
'TRAIN' is the train forward: proposals from the cfg.TRAIN settings, then
`proposal_target_layer` samples ROI_PER_IMAGE RoIs a frame and their
targets, and the RCNN runs its ReID branches over the frame pairs.  Each
`jax.lax.stop_gradient` of the JAX forward is a `detach` at the same place
(`jmodt_tpu/models/point_rcnn.py:62-63, 66-67, 73, 83, 89`).  Which of
BatchNorm's statistics and which SA route a module takes follows its
`training` flag, as `train` does in the JAX modules; a val step runs the
train forward with the model in eval mode, as the JAX package's does.

Under cfg.RPN.FIXED (the link / se finetune) the RPN runs in eval mode
under `torch.no_grad()`, and `PointRCNN.train()` leaves it in eval mode.
This is exact: the JAX forward detaches every RPN output the loss sees and
the loss has no RPN term, so its RPN parameters get a gradient of exactly
0.  It also routes differently.  The JAX package differentiates the whole
apply and marks the RPN `under_grad`, so its fused SA levels 1-3 take their
tensor-op twin (Pallas defines no JVP there); here the RPN is not under
autograd, so `sa_route` takes its eval routes and K4 runs at those levels.
PyTorch has no such limit: the two routes compute the same function.
The image pyramid follows the JAX route, though: a training step passes
`train_step` down to the backbone, which then makes the full-resolution
map even under LI_FUSION.FUSED_PYRAMID, as the JAX package's
differentiated apply does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from jmodt_torch.config import Config
from jmodt_torch.device import resolve_device
from jmodt_torch.models.layers import BatchNorm
from jmodt_torch.models.image_backbone import NonOverlapDeconv
from jmodt_torch.models.proposal import (RoiDraws, pool_rois_for_eval,
                                         proposal_layer,
                                         proposal_target_layer,
                                         sample_roi_draws)
from jmodt_torch.models.rcnn import RCNN
from jmodt_torch.models.rpn import RPN


class PointRCNN(nn.Module):
    """forward(pts_input (B, N, 3 + C), img (B, H, W, 3) | None, pts_xy
    (B, N, 2) | None) -> dict with the RPN outputs, proposals ('rois',
    'roi_scores_raw', 'roi_mask', 'seg_result') and the RCNN outputs.

    Mode 'TRAIN' also takes gt_boxes3d (B, G, 7), gt_tids (B, G) | None,
    the RoI sampling's `draws` (a `RoiDraws`; drawn from torch's default
    generator when None) and a dropout `generator` on the input's device,
    and adds 'targets' (a `RoiTargets`) and the ReID outputs."""

    def __init__(self, cfg: Config, mode: str = 'EVAL', use_xyz: bool = True,
                 device=None):
        super().__init__()
        assert cfg.RPN.ENABLED and cfg.RCNN.ENABLED, \
            'composite model expects both stages enabled'
        self.cfg = cfg
        self.mode = mode
        self.rpn = RPN(cfg, use_xyz=use_xyz, device=device)
        self.rcnn = RCNN(cfg, use_xyz=use_xyz, device=device)
        self.eval()      # the eval forward: its SA levels take the eval paths

    def train(self, mode: bool = True):
        """Set training mode; a frozen RPN (cfg.RPN.FIXED) stays in eval
        mode: running statistics, no dropout, its eval SA routes."""
        super().train(mode)
        if self.cfg.RPN.FIXED:
            self.rpn.train(False)
        return self

    def forward(self, pts_input, img=None, pts_xy=None, gt_boxes3d=None,
                gt_tids=None, draws: Optional[RoiDraws] = None,
                generator: Optional[torch.Generator] = None):
        if self.mode == 'TRAIN':
            return self._train_forward(pts_input, img, pts_xy, gt_boxes3d,
                                       gt_tids, draws, generator)
        with torch.no_grad():
            return self._eval_forward(pts_input, img, pts_xy)

    def _proposals(self, out, rpn_scores_raw, rpn_reg):
        cfg = self.cfg
        backbone_xyz = out['backbone_xyz']
        seg_mask = (torch.sigmoid(rpn_scores_raw)
                    > cfg.RPN.SCORE_THRESH).float()
        props = proposal_layer(cfg, self.mode, rpn_scores_raw, rpn_reg,
                               backbone_xyz)
        out.update(rois=props.boxes, roi_scores_raw=props.scores,
                   roi_mask=props.mask, seg_result=seg_mask)
        return seg_mask, torch.linalg.norm(backbone_xyz, dim=2), props.boxes

    def _eval_forward(self, pts_input, img, pts_xy):
        out = dict(self.rpn(pts_input, img, pts_xy))
        seg_mask, pts_depth, rois = self._proposals(
            out, out['rpn_cls'][:, :, 0], out['rpn_reg'])
        pts_input_rcnn = pool_rois_for_eval(
            self.cfg, out['backbone_xyz'], out['backbone_features'], seg_mask,
            pts_depth, rois)
        out.update(self.rcnn(pts_input_rcnn))
        return out

    def _train_forward(self, pts_input, img, pts_xy, gt_boxes3d, gt_tids,
                       draws, generator):
        cfg = self.cfg
        fixed = cfg.RPN.FIXED
        assert gt_boxes3d is not None, 'mode TRAIN needs gt_boxes3d'
        with torch.set_grad_enabled(torch.is_grad_enabled() and not fixed):
            out = dict(self.rpn(pts_input, img, pts_xy, generator,
                                train_step=self.training))
        out['backbone_xyz'] = out['backbone_xyz'].detach()       # :73, :83
        features = out['backbone_features']
        if fixed:
            features = features.detach()                         # :62-63
        with torch.no_grad():                                    # :66-67
            seg_mask, pts_depth, rois = self._proposals(
                out, out['rpn_cls'][:, :, 0].detach(),
                out['rpn_reg'].detach())
        if draws is None:
            draws = sample_roi_draws(cfg, rois.shape[0], rois.shape[1],
                                     device=rois.device)
        if gt_tids is None:
            gt_tids = torch.zeros(gt_boxes3d.shape[:2],
                                  device=gt_boxes3d.device)
        targets = proposal_target_layer(
            cfg, draws, out['backbone_xyz'], features, seg_mask, pts_depth,
            rois, gt_boxes3d, gt_tids)
        pts_input_rcnn = (targets.pts_input.detach() if fixed      # :89
                          else targets.pts_input)
        out.update(self.rcnn(pts_input_rcnn, gt_tids=targets.gt_tids,
                             generator=generator))
        out['targets'] = targets
        return out


def init_weights(model: nn.Module, seed: int) -> None:
    """Fill every parameter and buffer from a seeded CPU generator, so the
    same seed gives the same weights on any device: Kaiming-normal weights,
    zero biases, identity BatchNorm statistics, the focal-loss prior on the
    RPN classifier bias and std-0.001 regression outputs."""
    g = torch.Generator().manual_seed(seed)

    def fill(t: torch.Tensor, values: torch.Tensor) -> None:
        with torch.no_grad():
            t.copy_(values)

    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            for t, v in ((module.weight, 1.0), (module.bias, 0.0),
                         (module.running_mean, 0.0),
                         (module.running_var, 1.0)):
                fill(t, torch.full(t.shape, v))
        elif isinstance(module, (nn.Linear, nn.Conv2d, NonOverlapDeconv)):
            w = module.weight
            fan_in = (w.shape[0] if isinstance(module, NonOverlapDeconv)
                      else w.shape[1]) * math.prod(w.shape[2:])
            std = (0.001 if name.endswith('reg_head.Dense_0')
                   else math.sqrt(2.0 / fan_in))
            fill(w, torch.randn(w.shape, generator=g) * std)
            if module.bias is not None:
                bias = 0.0
                if name == 'rpn.cls_head.Dense_0':
                    bias = -math.log((1 - 0.01) / 0.01)
                fill(module.bias, torch.full(module.bias.shape, bias))


def build_detector(cfg: Config, mode: str = 'EVAL', device=None,
                   seed: int = 0) -> PointRCNN:
    """A PointRCNN in `mode` on `device` (default: the CUDA card; raises
    without one) with random weights from `seed`, in eval mode."""
    dev = resolve_device(device)
    model = PointRCNN(cfg, mode=mode, device='meta').to_empty(device=dev)
    init_weights(model, seed)
    return model.eval()
