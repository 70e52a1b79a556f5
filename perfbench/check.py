"""How `correct` is decided for the joint step: each captured frame of the
window against the plain reference (`perfbench/reference`), run once the
window has closed.

The detector's two networks are recomputed from the frame's own inputs
and the benchmark's weights, in float32 with TF32 off, and compared as a
relative error: the norm of the difference over the norm of the
reference around its mean.  Each later stage makes discrete choices
(sorts, NMS, top-K, the assignment) on values that the networks only
approximate, so the reference follows the program's own outputs of the
stage before and computes the stage again exactly:

* `rpn_err`: the RPN (image CNN, pyramid, LI-Fusion, SA and FP levels,
  heads) on the frame, against the program's `rpn_cls` and `rpn_reg`;
* `proposal_mismatch`: RoI slots whose box, score or mask differ from
  the reference proposal layer (decode, the two N1 zones) run on the
  program's RPN outputs;
* `rcnn_err`: the RCNN (RoI pooling, SA levels, heads) on the program's
  RoIs and backbone outputs, against `rcnn_cls`, `rcnn_reg`, `rcnn_feat`;
* `detection_mismatch`: slots of the detection step's output (decode,
  score threshold, the final N1) that differ from the reference's on the
  program's RCNN outputs;
* `track_mismatch`: entries of the top-K, the tracker's new state (N3,
  affinity, N2, update, births) and the packed rows that differ from the
  reference's tracker step on the program's detections and its state
  before the frame.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.program import Program, plain_changes

_IMG_MEAN = (0.485, 0.456, 0.406)
_IMG_STD = (0.229, 0.224, 0.225)
NAMES = ('rpn_err', 'rcnn_err', 'proposal_mismatch', 'detection_mismatch',
         'track_mismatch')


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| over |want - mean(want)|, Frobenius norms, float64;
    infinite where the shapes differ."""
    if got.shape != want.shape:
        return float('inf')
    got, want = got.double(), want.detach().double()
    scale = torch.linalg.vector_norm(want - want.mean())
    diff = torch.linalg.vector_norm(got - want)
    return float(diff / scale) if scale > 0 else float(diff)


def mismatches(got, want) -> int:
    """Entries of `got` that are not exactly `want` (NaN never equals);
    a shape that differs counts as every entry."""
    got, want = torch.as_tensor(got), torch.as_tensor(want).to(got.device)
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got != want).sum())


class Reference:
    """The reference pipeline of a cell, built once a run's window has
    closed, with the benchmark's weights."""

    def __init__(self, tree, tracker_kw, model_state, head_state, device):
        self.ref = Program('perfbench.reference')
        self.cfg = self.ref.make_config(tree, **plain_changes('float32'))
        self.device = torch.device(device)
        model = self.ref.point_rcnn.PointRCNN(self.cfg, device='meta')
        model = model.to_empty(device=self.device)
        model.load_state_dict(model_state)
        self.model = model.eval()
        feat_dim = self.cfg.RCNN.SA_CONFIG.MLPS[-1][-1]
        head = self.ref.rcnn.CorrelationHead(
            feat_dim, self.cfg.REID.LINK_FC, use_bn=self.cfg.REID.USE_BN)
        head.load_state_dict(head_state)
        self.head = head.to(self.device).eval()
        self.kw = dict(tracker_kw)
        self.track_k = self.kw.pop('track_k')
        self.thresh = self.kw.pop('det_score_thresh')
        self.kw.pop('max_tracks', None)
        self.step = self.ref.tracker.make_batched_tracker_step(
            self.head, device=self.device, **self.kw)

    @torch.no_grad()
    def compare(self, frame) -> Dict[str, float]:
        """The numbers of one captured frame (`Capture`)."""
        from perfbench.reference.models import inference, proposal
        dev, cfg = self.device, self.cfg
        pts = torch.as_tensor(frame.pts, device=dev)
        xy = torch.as_tensor(frame.xy, device=dev)
        img = None
        if frame.img is not None:
            img = torch.as_tensor(frame.img, device=dev).float() / 255.0
            img = ((img - torch.tensor(_IMG_MEAN, device=dev))
                   / torch.tensor(_IMG_STD, device=dev))
        out = {k: v.to(dev) if torch.is_tensor(v) else v
               for k, v in frame.out.items()}
        num = {}
        rpn = self.model.rpn(pts, img, xy)
        num['rpn_err'] = max(rel_err(out[k], rpn[k])
                             for k in ('rpn_cls', 'rpn_reg'))

        scores = out['rpn_cls'][:, :, 0]
        props = proposal.proposal_layer(cfg, 'EVAL', scores, out['rpn_reg'],
                                        out['backbone_xyz'])
        num['proposal_mismatch'] = float(
            mismatches(out['rois'], props.boxes)
            + mismatches(out['roi_scores_raw'], props.scores)
            + mismatches(out['roi_mask'], props.mask))

        seg = (torch.sigmoid(scores) > cfg.RPN.SCORE_THRESH).float()
        depth = torch.linalg.norm(out['backbone_xyz'], dim=2)
        pooled = proposal.pool_rois_for_eval(
            cfg, out['backbone_xyz'], out['backbone_features'], seg, depth,
            out['rois'])
        rcnn = self.model.rcnn(pooled)
        num['rcnn_err'] = max(rel_err(out[k], rcnn[k])
                              for k in ('rcnn_cls', 'rcnn_reg', 'rcnn_feat'))

        det = inference.detections(cfg, 'EVAL', out, pts.shape[0])
        num['detection_mismatch'] = float(sum(
            mismatches(frame.det[k], det[k])
            for k in ('boxes', 'scores', 'keep', 'feats')))

        pipe = self.ref.pipeline
        top = pipe._top_k(frame.det, self.track_k, self.thresh)
        n = sum(mismatches(g, w) for g, w in zip(frame.track_in[1:], top))
        state = self.ref.tracker.TrackerState(**{
            k: (v if k == 'mats' else v.to(dev))
            for k, v in frame.state_in._asdict().items()})
        state = state._replace(mats=self.ref.tracker.KalmanMats(
            *(m.to(dev) for m in state.mats)))
        new, trk = self.step(state, frame.track_in[0], *top)
        for k, v in new._asdict().items():
            if k != 'mats':
                n += mismatches(getattr(frame.state_out, k), v)
        n += mismatches(frame.packed, pipe._pack(trk))
        num['track_mismatch'] = float(n)
        return num


def judge(numbers: List[Dict[str, float]], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number's worst reading over the frames, beside its limit."""
    out = {}
    for name in NAMES:
        vals = [n[name] for n in numbers]
        out[name] = {'value': max(vals) if vals else float('nan'),
                     'limit': limits[name]}
    return out


def correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(np.isfinite(c['value']) and c['value'] <= c['limit']
               for c in checks.values())
