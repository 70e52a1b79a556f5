"""PointNet++-MSG backbone with LI-Fusion (counterpart of
`jmodt_tpu/models/backbone.py`): 4 SA levels, each fused with image
features, 4 FP levels, and a final full-resolution image fusion.
"""

from __future__ import annotations

import torch
from torch import nn

from jmodt_torch.config import Config
from jmodt_torch.models.image_backbone import (BasicBlock, ImagePyramidFusion,
                                               feature_gather)
from jmodt_torch.models.layers import (PointwiseLayer, compute_dtype, dense)
from jmodt_torch.models.pointnet2 import FPModule, SAModuleMSG


def backbone_out_channels(cfg: Config) -> int:
    return (cfg.LI_FUSION.IMG_FEATURES_CHANNEL if cfg.LI_FUSION.ENABLED
            else cfg.RPN.FP_MLPS[0][-1])


class IALayer(nn.Module):
    """Image-attention gate: att = sigmoid(fc3(tanh(fc1(img) +
    fc2(point)))); the image feature, lifted to point width (Dense + BN +
    ReLU), scaled by att.  img_feas (B, N, IC), point_feas (B, N, PC)."""

    def __init__(self, img_channels: int, point_channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        rc = point_channels // 4
        self.Dense_0 = nn.Linear(img_channels, rc, device=device)
        self.Dense_1 = nn.Linear(point_channels, rc, device=device)
        self.Dense_2 = nn.Linear(rc, 1, device=device)
        self.PointwiseLayer_0 = PointwiseLayer(
            img_channels, point_channels, use_bn=True, dtype=dtype,
            device=device)

    def forward(self, img_feas, point_feas):
        dt = self.dtype
        ri = dense(self.Dense_0, img_feas, dt)
        rp = dense(self.Dense_1, point_feas, dt)
        att = torch.sigmoid(dense(self.Dense_2, torch.tanh(ri + rp), dt))
        return self.PointwiseLayer_0(img_feas) * att


class AttentionFusion(nn.Module):
    """concat(point, gated image) -> Dense + BN + ReLU."""

    def __init__(self, img_channels: int, point_channels: int,
                 out_channels: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.IALayer_0 = IALayer(img_channels, point_channels, dtype=dtype,
                                 device=device)
        self.PointwiseLayer_0 = PointwiseLayer(
            2 * point_channels, out_channels, use_bn=True, dtype=dtype,
            device=device)

    def forward(self, point_features, img_features):
        gated = self.IALayer_0(img_features, point_features)
        fused = torch.cat([point_features.to(gated.dtype), gated], dim=-1)
        return self.PointwiseLayer_0(fused)


class PointNet2MSG(nn.Module):
    """forward(pc (B, N, 3 + C), image (B, H, W, 3) | None, xy (B, N, 2) |
    None, train_step=False) -> (xyz (B, N, 3), features (B, N, out)).

    With LI_FUSION.FUSED_PYRAMID the image pyramid is sampled at the points
    by the fused gather (`ImagePyramidFusion`), on the JAX package's gate
    (`jmodt_tpu/models/backbone.py:167-176`): in eval mode, where autograd
    does not record the pyramid (`pointnet2.sa_route`'s notion), and not
    inside a training step (`train_step`, which `PointRCNN`'s train forward
    passes as the JAX package passes `under_grad=train`: under RPN.FIXED the
    port runs the RPN in eval mode under no_grad, where the JAX package
    differentiates it and takes the materialized map)."""

    def __init__(self, cfg: Config, input_channels: int = 0,
                 use_xyz: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        self.use_xyz = use_xyz
        sa_cfg = cfg.RPN.SA_CONFIG
        li = cfg.LI_FUSION
        dtype = compute_dtype(cfg)
        skip = [input_channels]
        for k in range(len(sa_cfg.NPOINTS)):
            self.add_module(f'sa_{k}', SAModuleMSG(
                sa_cfg.NPOINTS[k], sa_cfg.RADIUS[k], sa_cfg.NSAMPLE[k],
                sa_cfg.MLPS[k], cin=skip[-1], use_xyz=use_xyz,
                use_bn=cfg.RPN.USE_BN, dtype=dtype, device=device))
            skip.append(sum(m[-1] for m in sa_cfg.MLPS[k]))
        if li.ENABLED:
            for k in range(len(sa_cfg.NPOINTS)):
                self.add_module(f'img_block_{k}', BasicBlock(
                    li.IMG_CHANNELS[k], li.IMG_CHANNELS[k + 1], dtype=dtype,
                    device=device))
                self.add_module(f'fusion_{k}', AttentionFusion(
                    li.IMG_CHANNELS[k + 1], li.POINT_CHANNELS[k],
                    li.POINT_CHANNELS[k], dtype=dtype, device=device))
        fp = cfg.RPN.FP_MLPS
        for k in range(len(fp)):
            pre = fp[k + 1][-1] if k + 1 < len(fp) else skip[-1]
            self.add_module(f'fp_{k}', FPModule(
                pre + skip[k], fp[k], use_bn=cfg.RPN.USE_BN, dtype=dtype,
                device=device))
        if li.ENABLED:
            self.img_pyramid = ImagePyramidFusion(
                li.IMG_CHANNELS[1:], li.DeConv_Reduce, li.DeConv_Kernels,
                li.IMG_FEATURES_CHANNEL // 4, dtype=dtype, device=device)
            self.final_fusion = AttentionFusion(
                li.IMG_FEATURES_CHANNEL // 4, li.IMG_FEATURES_CHANNEL,
                li.IMG_FEATURES_CHANNEL, dtype=dtype, device=device)

    def forward(self, pc, image=None, xy=None, train_step: bool = False):
        cfg = self.cfg
        n_sa = len(cfg.RPN.SA_CONFIG.NPOINTS)
        use_fusion = cfg.LI_FUSION.ENABLED and image is not None
        xyz = pc[..., 0:3].contiguous()
        features = pc[..., 3:] if pc.shape[-1] > 3 else None
        l_xyz, l_features, l_xy = [xyz], [features], [xy]
        img_levels = []
        img = image
        for k in range(n_sa):
            # fused and whole-level eval paths where the cloud is small
            # (levels 1-3 at the default widths)
            small = self.use_xyz and l_xyz[k].shape[1] <= 8192
            li_xyz, li_feat, li_idx = getattr(self, f'sa_{k}')(
                l_xyz[k], l_features[k], cfg.RPN.FUSED_SA and small,
                cfg.RPN.MEGA_SA and small)
            if use_fusion:
                li_xy = torch.gather(l_xy[k], 1, li_idx.long()[:, :, None]
                                     .expand(-1, -1, 2))
                img = getattr(self, f'img_block_{k}')(img)
                img_pts = feature_gather(img, li_xy)
                li_feat = getattr(self, f'fusion_{k}')(li_feat, img_pts)
                l_xy.append(li_xy)
                img_levels.append(img)
            l_xyz.append(li_xyz)
            l_features.append(li_feat)

        n_fp = len(cfg.RPN.FP_MLPS)
        for i in range(-1, -(n_fp + 1), -1):
            l_features[i - 1] = getattr(self, f'fp_{n_fp + i}')(
                l_xyz[i - 1], l_xyz[i], l_features[i - 1], l_features[i])

        if use_fusion:
            pyramid = self.img_pyramid
            under_grad = torch.is_grad_enabled() and (
                xy.requires_grad or any(t.requires_grad for t in img_levels)
                or any(p.requires_grad for p in pyramid.parameters()))
            if (cfg.LI_FUSION.FUSED_PYRAMID and not pyramid.training
                    and not under_grad and not train_step):
                img_pts = pyramid(img_levels, xy)
            else:
                img_pts = feature_gather(pyramid(img_levels), xy)
            l_features[0] = self.final_fusion(l_features[0], img_pts)
        return l_xyz[0], l_features[0]
