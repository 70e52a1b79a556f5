"""Region proposal network (counterpart of `jmodt_tpu/models/rpn.py`):
the fused backbone plus per-point classification and bin-based regression
heads over the (B, N, C) feature-last backbone output.
"""

from __future__ import annotations

from torch import nn

from jmodt_torch.config import Config
from jmodt_torch.models.backbone import PointNet2MSG, backbone_out_channels
from jmodt_torch.models.layers import HeadMLP, compute_dtype
from jmodt_torch.utils.trace import span


def rpn_reg_channels(cfg: Config) -> int:
    """Regression width: xz bins + residuals, heading bins + residuals,
    3 sizes, 1 y offset."""
    per_loc_bin = int(cfg.RPN.LOC_SCOPE / cfg.RPN.LOC_BIN_SIZE) * 2
    base = per_loc_bin * 4 if cfg.RPN.LOC_XZ_FINE else per_loc_bin * 2
    return base + cfg.RPN.NUM_HEAD_BIN * 2 + 3 + 1


class RPN(nn.Module):
    """forward(pts_input (B, N, 3 + C), img (B, H, W, 3) | None, pts_xy
    (B, N, 2) | None) -> dict with rpn_cls (B, N, 1), rpn_reg (B, N, C),
    backbone_xyz (B, N, 3), backbone_features (B, N, 128).  In training
    mode its heads drop out with cfg.RPN.DP_RATIO, drawn from forward's
    `generator`."""

    def __init__(self, cfg: Config, use_xyz: bool = True, device=None):
        super().__init__()
        input_channels = int(cfg.RPN.USE_INTENSITY) + 3 * int(cfg.RPN.USE_RGB)
        self.backbone = PointNet2MSG(cfg, input_channels, use_xyz,
                                     device=device)
        c = backbone_out_channels(cfg)
        dtype = compute_dtype(cfg)
        kw = dict(use_bn=cfg.RPN.USE_BN, dp_ratio=cfg.RPN.DP_RATIO,
                  dtype=dtype, device=device)
        self.cls_head = HeadMLP(c, cfg.RPN.CLS_FC, 1, **kw)
        self.reg_head = HeadMLP(c, cfg.RPN.REG_FC, rpn_reg_channels(cfg), **kw)

    def forward(self, pts_input, img=None, pts_xy=None, generator=None,
                train_step: bool = False):
        xyz, feats = self.backbone(pts_input, img, pts_xy, train_step)
        return self.heads(xyz, feats, generator)

    def heads(self, xyz, feats, generator=None):
        """The classification and regression heads over the backbone's
        output, and that output."""
        with span('jmodt.detection.rpn_heads'):
            return {'rpn_cls': self.cls_head(feats, generator),
                    'rpn_reg': self.reg_head(feats, generator),
                    'backbone_xyz': xyz, 'backbone_features': feats}
