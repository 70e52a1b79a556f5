"""RCNN refinement head, eval branch (counterpart of
`jmodt_tpu/models/rcnn.py`).  The link / start-end correlation heads are
built so that their weights load; the detection step does not run them.
The tracker runs standalone `CorrelationHead`s and normalizes their link
scores with `masked_bidirectional_softmax`.
"""

from __future__ import annotations

import torch
from torch import nn

from jmodt_torch.config import Config
from jmodt_torch.models.backbone import backbone_out_channels
from jmodt_torch.models.layers import HeadMLP, PointwiseMLP, compute_dtype
from jmodt_torch.models.pointnet2 import SAModuleMSG


def rcnn_reg_channels(cfg: Config) -> int:
    per_loc_bin = int(cfg.RCNN.LOC_SCOPE / cfg.RCNN.LOC_BIN_SIZE) * 2
    loc_y_bin = int(cfg.RCNN.LOC_Y_SCOPE / cfg.RCNN.LOC_Y_BIN_SIZE) * 2
    ch = per_loc_bin * 4 + cfg.RCNN.NUM_HEAD_BIN * 2 + 3
    return ch + (loc_y_bin * 2 if cfg.RCNN.LOC_Y_BY_BIN else 1)


class CorrelationHead(nn.Module):
    """The link / start-end hidden -> 1 stack."""

    def __init__(self, cin: int, hidden, use_bn: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.mlp = HeadMLP(cin, hidden, 1, use_bn=use_bn, dtype=dtype,
                           device=device)

    def forward(self, x):
        return self.mlp(x)


def masked_bidirectional_softmax(scores: torch.Tensor,
                                 row_valid: torch.Tensor,
                                 col_valid: torch.Tensor) -> torch.Tensor:
    """(softmax over valid columns + softmax over valid rows) / 2 on the
    valid sub-matrix of `scores` (..., P, D), zero elsewhere; leading dims
    are a batch.  Invalid entries are filled with -1e9, not -inf, so an
    all-invalid row stays finite."""
    ok = row_valid[..., :, None] & col_valid[..., None, :]
    masked = torch.where(ok, scores, torch.full_like(scores, -1e9))
    out = (torch.softmax(masked, dim=-1) + torch.softmax(masked, dim=-2)) / 2
    return torch.where(ok, out, torch.zeros_like(out))


class RCNN(nn.Module):
    """forward(pts_input (R, NUM_POINTS, 5 + 128)), channels [canonical xyz,
    seg mask, depth, rpn features] -> rcnn_cls (R, 1), rcnn_reg (R, C),
    rcnn_feat (R, 512) [, rcnn_iou_branch (R, 1)]."""

    def __init__(self, cfg: Config, use_xyz: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        rc = cfg.RCNN
        dtype = compute_dtype(cfg)
        self.in_channels = 3 + int(rc.USE_INTENSITY) + int(rc.USE_MASK) \
            + int(rc.USE_DEPTH)
        if rc.USE_RPN_FEATURES:
            self.xyz_up = PointwiseMLP(self.in_channels, rc.XYZ_UP_LAYER,
                                       use_bn=rc.USE_BN, dtype=dtype,
                                       device=device)
            self.merge_down = PointwiseMLP(
                rc.XYZ_UP_LAYER[-1] + backbone_out_channels(cfg),
                (rc.XYZ_UP_LAYER[-1],), use_bn=rc.USE_BN, dtype=dtype,
                device=device)
            cin = rc.XYZ_UP_LAYER[-1]
        else:
            cin = backbone_out_channels(cfg) + self.in_channels - 3
        sa = rc.SA_CONFIG
        for k in range(len(sa.NPOINTS)):
            self.add_module(f'sa_{k}', SAModuleMSG(
                sa.NPOINTS[k] if sa.NPOINTS[k] != -1 else None,
                (sa.RADIUS[k],), (sa.NSAMPLE[k],), (sa.MLPS[k],), cin=cin,
                use_xyz=use_xyz, use_bn=rc.USE_BN, dtype=dtype,
                device=device))
            cin = sa.MLPS[k][-1]
        self.cls_head = HeadMLP(cin, rc.CLS_FC, 1, use_bn=rc.USE_BN,
                                dtype=dtype, device=device)
        self.reg_head = HeadMLP(cin, rc.REG_FC, rcnn_reg_channels(cfg),
                                use_bn=rc.USE_BN, dtype=dtype, device=device)
        if cfg.USE_IOU_BRANCH:
            self.iou_branch = HeadMLP(cin, rc.REG_FC, 1, use_bn=rc.USE_BN,
                                      dtype=dtype, device=device)
        self.link_layer = CorrelationHead(cin, cfg.REID.LINK_FC,
                                          use_bn=cfg.REID.USE_BN, dtype=dtype,
                                          device=device)
        self.se_layer = CorrelationHead(cin, cfg.REID.SE_FC,
                                        use_bn=cfg.REID.USE_BN, dtype=dtype,
                                        device=device)

    def forward(self, pts_input):
        rc = self.cfg.RCNN
        xyz = pts_input[..., 0:3].contiguous()
        if rc.USE_RPN_FEATURES:
            xyz_feature = self.xyz_up(pts_input[..., :self.in_channels])
            rpn_feature = pts_input[..., self.in_channels:]
            merged = torch.cat([xyz_feature,
                                rpn_feature.to(xyz_feature.dtype)], dim=-1)
            feats = self.merge_down(merged)
        else:
            feats = pts_input[..., 3:]
        l_xyz, l_feats = xyz, feats
        for k in range(len(rc.SA_CONFIG.NPOINTS)):
            l_xyz, l_feats, _ = getattr(self, f'sa_{k}')(l_xyz, l_feats,
                                                         rc.FUSED_SA)
        # (R, 512): GroupAll leaves one group; float32 from here on
        feat_vec = l_feats[:, 0, :].float()
        out = {'rcnn_cls': self.cls_head(feat_vec),
               'rcnn_reg': self.reg_head(feat_vec),
               'rcnn_feat': feat_vec}
        if self.cfg.USE_IOU_BRANCH:
            out['rcnn_iou_branch'] = self.iou_branch(feat_vec)
        return out
