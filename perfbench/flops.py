"""Analytic FLOP counts of the eval-mode detection and tracking forward,
derived term by term from the configuration's shapes: the numerator of
`mfu`.  A frozen copy of the count the port kept in `utils/flops.py`, so
the share of the peak reads the same work whatever implements it.

Conventions: 1 MAC = 2 FLOPs; BN / ReLU / bias and other elementwise work
is left out (under 1% here); gathers and scatters count 0.  Per component:

  * image CNN      - 4 BasicBlocks (conv3x3 s1 + conv3x3 s2), NHWC
  * deconv pyramid - 4 ConvTranspose(k=s) + the 1x1 merge conv
  * RPN SA stack   - grouped MSG MLPs at npoint x nsample positions,
                     + ball-query distance matrices + FPS distance scans
  * per-level LI-fusion (IALayer + AttentionFusion 1x1 convs)
  * RPN FP stack   - 3-NN search + interpolation + MLPs at fine points
  * RPN heads      - cls / reg pointwise convs at every point
  * RCNN           - xyz-up / merge MLPs, 3 SA levels at RoI x npoint x
                     nsample positions, cls / reg heads, + roipool3d
                     point-in-box tests
  * tracker step   - link head on (T, D) pairs + affinity matrices
                     (only when the tracker arguments are passed)
"""

from __future__ import annotations

from typing import Dict, Optional


def _mlp_macs(positions: int, in_ch: int, widths) -> int:
    macs, c = 0, in_ch
    for w in widths:
        macs += positions * c * w
        c = w
    return macs


def detection_flops(cfg, image_hw=(384, 1280), npoints: int = 16384,
                    rois: Optional[int] = None, roi_points: int = 512,
                    track_k: int = 0, max_tracks: int = 0,
                    feat_dim: int = 512) -> Dict[str, float]:
    """Per-frame (batch 1) eval forward FLOPs by component.

    :param rois: post-NMS proposal count (defaults to cfg.EVAL.RPN_POST_NMS_TOP_N)
    :param track_k/max_tracks: nonzero adds the on-device tracker step
    :return: dict of component -> FLOPs, plus 'total'
    """
    h, w = image_hw
    li = cfg.LI_FUSION
    sa = cfg.RPN.SA_CONFIG
    if rois is None:
        rois = cfg.EVAL.RPN_POST_NMS_TOP_N

    terms: Dict[str, float] = {}

    # ---- image CNN: BasicBlock k maps (H_k, W_k, C_k) -> (H_k/2, .., C_k+1)
    if li.ENABLED:
        macs = 0
        hh, ww = h, w
        chans = li.IMG_CHANNELS  # (3, 64, 128, 256, 512)
        for k in range(len(chans) - 1):
            cin, cout = chans[k], chans[k + 1]
            macs += hh * ww * 9 * cin * cout          # conv3x3 stride 1
            hh, ww = hh // 2, ww // 2
            macs += hh * ww * 9 * cout * cout         # conv3x3 stride 2
        terms['image_cnn'] = 2.0 * macs

        # ---- deconv pyramid: ConvTranspose(k=s) has exactly one kernel tap
        # per output position -> H_out*W_out*C_in*C_out MACs; then 1x1 merge
        macs = 0
        full = h * w  # kernels==strides==2^(k+1) restore full resolution
        for k in range(len(chans) - 1):
            macs += full * chans[k + 1] * li.DeConv_Reduce[k]
        cat = sum(li.DeConv_Reduce)
        macs += full * cat * (li.IMG_FEATURES_CHANNEL // 4)
        terms['deconv_pyramid'] = 2.0 * macs

    # ---- RPN SA stack (grouped MSG MLPs + neighbor search)
    sa_macs, search_macs, fusion_macs = 0, 0, 0
    n_prev = npoints
    c_in = 0   # raw clouds carry no extra features
    for k in range(len(sa.NPOINTS)):
        m = sa.NPOINTS[k]
        c_out = 0
        for s in range(len(sa.RADIUS[k])):
            nsample = sa.NSAMPLE[k][s]
            widths = sa.MLPS[k][s]
            sa_macs += _mlp_macs(m * nsample, c_in + 3, widths)
            c_out += widths[-1]
            # ball query: (m, n_prev) pairwise distances (3 MACs each)
            search_macs += m * n_prev * 3
        # FPS: m sequential steps, each updating n_prev min-distances
        search_macs += m * n_prev * 3
        if li.ENABLED:
            pc, ic = li.POINT_CHANNELS[k], li.IMG_CHANNELS[k + 1]
            rc = pc // 4
            fusion_macs += m * (ic * rc + pc * rc + rc      # IALayer gates
                                + ic * pc                   # image lift
                                + 2 * pc * pc)              # concat conv
        c_in = c_out
        n_prev = m
    terms['rpn_sa_mlps'] = 2.0 * sa_macs
    terms['rpn_neighbor_search'] = 2.0 * search_macs
    if li.ENABLED:
        # final full-resolution fusion (128-d point features, 32-d image)
        pc, ic = li.IMG_FEATURES_CHANNEL, li.IMG_FEATURES_CHANNEL // 4
        rc = pc // 4
        fusion_macs += npoints * (ic * rc + pc * rc + rc + ic * pc
                                  + 2 * pc * pc)
        terms['li_fusion'] = 2.0 * fusion_macs

    # ---- FP stack: skip widths = SA outputs; iterate coarse -> fine
    sa_out = []
    c = 0
    for k in range(len(sa.NPOINTS)):
        c = sum(ws[-1] for ws in sa.MLPS[k])
        sa_out.append(c)
    counts = [npoints] + list(sa.NPOINTS)       # per-level point counts
    skips = [0] + sa_out                        # per-level feature widths
    fp_macs = 0
    for k in range(len(cfg.RPN.FP_MLPS)):
        n_fine, n_coarse = counts[k], counts[k + 1]
        c_coarse = (skips[k + 1] if k + 1 == len(cfg.RPN.FP_MLPS)
                    else cfg.RPN.FP_MLPS[k + 1][-1])
        fp_macs += _mlp_macs(n_fine, c_coarse + skips[k],
                             cfg.RPN.FP_MLPS[k])
        fp_macs += n_fine * n_coarse * 3        # 3-NN distance matrix
        fp_macs += n_fine * 3 * c_coarse        # weighted interpolation
    terms['rpn_fp'] = 2.0 * fp_macs

    # ---- RPN heads (pointwise convs at npoints)
    head_macs = _mlp_macs(npoints, cfg.RPN.FP_MLPS[0][-1],
                          list(cfg.RPN.CLS_FC) + [1])
    reg_out = 76  # 12x4 xz bins + 12x2 ry bins + 3 size + 1 y
    head_macs += _mlp_macs(npoints, cfg.RPN.FP_MLPS[0][-1],
                           list(cfg.RPN.REG_FC) + [reg_out])
    terms['rpn_heads'] = 2.0 * head_macs

    # ---- RCNN
    rc_cfg = cfg.RCNN
    rsa = rc_cfg.SA_CONFIG
    macs = 0
    # roipool3d: point-in-rotated-box tests for every (roi, point) pair
    macs += rois * npoints * 6
    # xyz-up (5 -> XYZ_UP_LAYER) + merge (2*C -> C) at roi_points each
    pts = rois * roi_points
    macs += _mlp_macs(pts, 5, rc_cfg.XYZ_UP_LAYER)
    cmerge = rc_cfg.XYZ_UP_LAYER[-1]
    macs += pts * (2 * cmerge) * cmerge
    # SA levels (single scale); NPOINTS -1 = group-all over remaining pts
    n_prev, c_in = roi_points, cmerge
    for k in range(len(rsa.NPOINTS)):
        m = rsa.NPOINTS[k] if rsa.NPOINTS[k] > 0 else 1
        nsample = rsa.NSAMPLE[k] if rsa.NPOINTS[k] > 0 else n_prev
        macs += _mlp_macs(rois * m * nsample, c_in + 3, rsa.MLPS[k])
        if rsa.NPOINTS[k] > 0:
            macs += rois * (m * n_prev * 3 + m * n_prev * 3)  # query + FPS
        c_in = rsa.MLPS[k][-1]
        n_prev = m
    # cls/reg heads on the 512-d ROI feature
    macs += _mlp_macs(rois, c_in, list(rc_cfg.CLS_FC) + [1])
    reg_out = 46  # canonical bins (9x2 ry + 2x(1.5/0.5)x2x2 xz + 3 + 1)
    macs += _mlp_macs(rois, c_in, list(rc_cfg.REG_FC) + [reg_out])
    terms['rcnn'] = 2.0 * macs

    # ---- tracker step
    if track_k and max_tracks:
        pairs = max_tracks * track_k
        macs = _mlp_macs(pairs, feat_dim, list(cfg.REID.LINK_FC) + [1])
        macs += max_tracks * track_k * 8        # IoU/dist affinities (coarse)
        macs += max_tracks * (16 * 16 * 16 * 3 + 8 * 8 * 16 * 3)  # Kalman
        terms['tracker'] = 2.0 * macs

    terms['total'] = float(sum(terms.values()))
    return terms
