"""RCNN refinement head with the re-identification (link / start-end)
branches (counterpart of `jmodt_tpu/models/rcnn.py`).

The eval forward (the detection step) runs the point encoder and the
cls / reg heads; the tracker runs standalone `CorrelationHead`s and
normalizes their link scores with `masked_bidirectional_softmax`.  Given
the RoIs' track ids (training), forward also runs the link / start-end
branches over (prev, next) frame pairs, over fixed-size buffers of unique
track ids with validity masks instead of the reference's dynamic
`torch.unique` tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from jmodt_torch.config import Config
from jmodt_torch.models.backbone import backbone_out_channels
from jmodt_torch.models.layers import HeadMLP, PointwiseMLP, compute_dtype
from jmodt_torch.models.pointnet2 import SAModuleMSG
from jmodt_torch.models.proposal import first_k_indices


def rcnn_reg_channels(cfg: Config) -> int:
    per_loc_bin = int(cfg.RCNN.LOC_SCOPE / cfg.RCNN.LOC_BIN_SIZE) * 2
    loc_y_bin = int(cfg.RCNN.LOC_Y_SCOPE / cfg.RCNN.LOC_Y_BIN_SIZE) * 2
    ch = per_loc_bin * 4 + cfg.RCNN.NUM_HEAD_BIN * 2 + 3
    return ch + (loc_y_bin * 2 if cfg.RCNN.LOC_Y_BY_BIN else 1)


class CorrelationHead(nn.Module):
    """The link / start-end hidden -> 1 stack, dropout `dp_ratio` after its
    first layer in training mode."""

    def __init__(self, cin: int, hidden, use_bn: bool = False,
                 dp_ratio: float = 0.0, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.mlp = HeadMLP(cin, hidden, 1, use_bn=use_bn, dp_ratio=dp_ratio,
                           dtype=dtype, device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.mlp(x, generator)


def unique_tid_mean_features(tids: torch.Tensor, feats: torch.Tensor):
    """The mean feature of each unique positive track id, at a fixed size.

    :param tids: (R,) track ids, 0 or negative = background
    :param feats: (R, C)
    :return: (utids (R,), uvalid (R,) bool, ufeats (R, C)): at most R
        unique ids, ascending and compacted to the front, invalid slots 0
    """
    sorted_t = torch.sort(tids).values
    prev = torch.cat([torch.full((1,), float('-inf'), dtype=tids.dtype,
                                 device=tids.device), sorted_t[:-1]])
    is_new = (sorted_t != prev) & (sorted_t > 0)
    pos, valid = first_k_indices(is_new, tids.shape[0])
    utids = torch.where(valid, sorted_t[pos], torch.zeros_like(sorted_t))
    match = ((utids[:, None] == tids[None, :]) & (tids[None, :] > 0)
             & valid[:, None])
    w = match.to(feats.dtype)
    w = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
    return utids, valid, w @ feats


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
    rcnn_feat (R, 512) [, rcnn_iou_branch (R, 1)]; given `gt_tids` (B,
    ROI_PER_IMAGE), also the ReID link / start / end scores, labels and
    masks ('reid_*', `_reid`).  In training mode the heads drop out with
    RCNN.DP_RATIO, drawn from forward's `generator`."""

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
        kw = dict(use_bn=rc.USE_BN, dp_ratio=rc.DP_RATIO, dtype=dtype,
                  device=device)
        self.cls_head = HeadMLP(cin, rc.CLS_FC, 1, **kw)
        self.reg_head = HeadMLP(cin, rc.REG_FC, rcnn_reg_channels(cfg), **kw)
        if cfg.USE_IOU_BRANCH:
            self.iou_branch = HeadMLP(cin, rc.REG_FC, 1, **kw)
        # the JAX package gives the correlation heads RCNN.DP_RATIO too
        kw['use_bn'] = cfg.REID.USE_BN
        self.link_layer = CorrelationHead(cin, cfg.REID.LINK_FC, **kw)
        self.se_layer = CorrelationHead(cin, cfg.REID.SE_FC, **kw)

    def forward(self, pts_input, gt_tids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
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
        g = generator
        out = {'rcnn_cls': self.cls_head(feat_vec, g),
               'rcnn_reg': self.reg_head(feat_vec, g),
               'rcnn_feat': feat_vec}
        if self.cfg.USE_IOU_BRANCH:
            out['rcnn_iou_branch'] = self.iou_branch(feat_vec, g)
        if gt_tids is not None and self.cfg.REID.ENABLED:
            out.update(self._reid(feat_vec, gt_tids, g))
        return out

    def _reid(self, feat_vec, gt_tids, generator=None):
        """The link / start-end branches over (prev, next) frame pairs,
        interleaved as even / odd rows of `gt_tids` (B, ROI_PER_IMAGE);
        returns 'reid_{link, gt_link, link_mask, start, gt_start,
        start_mask, end, gt_end, end_mask}', stacked over the B / 2 pairs
        and each padded to ROI_PER_IMAGE unique ids."""
        num_frames, n_roi = gt_tids.shape
        assert num_frames % 2 == 0, 'pair training needs an even frame count'
        feats = feat_vec.reshape(num_frames, n_roi, -1)
        link_head, se_head = self.link_layer, self.se_layer
        pairs = []
        for i in range(0, num_frames, 2):
            put, pvalid, pfeat = unique_tid_mean_features(gt_tids[i],
                                                          feats[i])
            nut, nvalid, nfeat = unique_tid_mean_features(gt_tids[i + 1],
                                                          feats[i + 1])
            pair_ok = pvalid.any() & nvalid.any()
            pvalid, nvalid = pvalid & pair_ok, nvalid & pair_ok
            entry_ok = pvalid[:, None] & nvalid[None, :]

            cor = (pfeat[:, None, :] - nfeat[None, :, :]).abs()  # (U, U, C)
            link = masked_bidirectional_softmax(
                link_head(cor, generator)[..., 0], pvalid, nvalid)
            gt_link = ((put[:, None] == nut[None, :]) & entry_ok).to(
                cor.dtype)
            zero = torch.zeros_like(put)
            gt_start = torch.where(nvalid, 1.0 - gt_link.sum(0), zero)
            gt_end = torch.where(pvalid, 1.0 - gt_link.sum(1), zero)
            pw, nw = pvalid.to(cor.dtype), nvalid.to(cor.dtype)
            start_feat = ((cor * pw[:, None, None]).sum(0)
                          / torch.clamp(pw.sum(), min=1.0))      # (U, C)
            end_feat = ((cor * nw[None, :, None]).sum(1)
                        / torch.clamp(nw.sum(), min=1.0))
            pairs.append(dict(
                link=link, gt_link=gt_link, link_mask=entry_ok,
                start=se_head(start_feat, generator)[..., 0],
                gt_start=gt_start, start_mask=nvalid,
                end=se_head(end_feat, generator)[..., 0], gt_end=gt_end,
                end_mask=pvalid))
        return {f'reid_{k}': torch.stack([p[k] for p in pairs])
                for k in pairs[0]}
