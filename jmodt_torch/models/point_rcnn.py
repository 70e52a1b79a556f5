"""PointRCNN composite, eval forward (counterpart of
`jmodt_tpu/models/point_rcnn.py`): RPN -> proposals -> RoI pooling -> RCNN.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from jmodt_torch.config import Config
from jmodt_torch.device import resolve_device
from jmodt_torch.models.layers import BatchNorm
from jmodt_torch.models.image_backbone import NonOverlapDeconv
from jmodt_torch.models.proposal import pool_rois_for_eval, proposal_layer
from jmodt_torch.models.rcnn import RCNN
from jmodt_torch.models.rpn import RPN


class PointRCNN(nn.Module):
    """forward(pts_input (B, N, 3 + C), img (B, H, W, 3) | None, pts_xy
    (B, N, 2) | None) -> dict with the RPN outputs, proposals ('rois',
    'roi_scores_raw', 'roi_mask', 'seg_result') and the RCNN outputs."""

    def __init__(self, cfg: Config, mode: str = 'EVAL', use_xyz: bool = True,
                 device=None):
        super().__init__()
        assert cfg.RPN.ENABLED and cfg.RCNN.ENABLED, \
            'composite model expects both stages enabled'
        if mode == 'TRAIN':
            raise NotImplementedError('the port runs the eval forward only')
        self.cfg = cfg
        self.mode = mode
        self.rpn = RPN(cfg, use_xyz=use_xyz, device=device)
        self.rcnn = RCNN(cfg, use_xyz=use_xyz, device=device)
        self.eval()      # the eval forward: its SA levels take the eval paths

    @torch.no_grad()
    def forward(self, pts_input, img=None, pts_xy=None):
        cfg = self.cfg
        out = dict(self.rpn(pts_input, img, pts_xy))
        backbone_xyz = out['backbone_xyz']
        rpn_scores_raw = out['rpn_cls'][:, :, 0]
        seg_mask = (torch.sigmoid(rpn_scores_raw)
                    > cfg.RPN.SCORE_THRESH).float()
        pts_depth = torch.linalg.norm(backbone_xyz, dim=2)
        props = proposal_layer(cfg, self.mode, rpn_scores_raw,
                               out['rpn_reg'], backbone_xyz)
        out.update(rois=props.boxes, roi_scores_raw=props.scores,
                   roi_mask=props.mask, seg_result=seg_mask)
        pts_input_rcnn = pool_rois_for_eval(
            cfg, backbone_xyz, out['backbone_features'], seg_mask, pts_depth,
            props.boxes)
        out.update(self.rcnn(pts_input_rcnn))
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
    """A PointRCNN on `device` (default: the CUDA card; raises without one)
    with random weights from `seed`, in eval mode."""
    dev = resolve_device(device)
    model = PointRCNN(cfg, mode=mode, device='meta').to_empty(device=dev)
    init_weights(model, seed)
    return model.eval()
