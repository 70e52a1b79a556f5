"""How `correct` is decided for the training step: the run's first steps
(`drivers/train.py::TrainCapture`) against the plain reference, run once
the window has closed.

The reference builds its own model from the benchmark's weights, float32
with TF32 off, and its own optimizer (the same optax chain written out).
Under RPN.FIXED the RPN takes no gradient and the loss has no RPN term,
so only the RCNN and its heads are trained.  Each step:

* `rpn_err`: the RPN on the step's frames, recomputed, against the
  program's `rpn_cls` and `rpn_reg` (as in perfbench/check.py);
* `proposal_mismatch` / `target_mismatch`: entries of the TRAIN proposal
  layer (decode, both N1 zones) on the program's RPN outputs, and of the
  RoI sampling and pooling (`proposal_target_layer`, with the step's own
  draws) on the program's proposals, that differ from the reference's;
* the reference's RCNN, link and se heads then run on the program's
  pooled RoIs, take the losses and the backward, and step its optimizer.

After the steps:

* `loss_gap`: the largest of |program - reference| / |reference| over the
  steps' losses (`grad_norm_gap`, the same of the steps' `grad_norm`, is
  read for the record and compared where a limit names it);
* `grad_gap`: the first gradient as the optimizer got it (clipped), from
  its first moments after one step (mu / (1 - b1)): over the trainable
  leaves, the gap between the program's norm and the reference's, over
  the larger of the reference's norm of that leaf and of the median leaf;
* `delta_gap`: the same of each leaf's change over the steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both gaps.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

from perfbench.check import mismatches, rel_err
from perfbench.drivers.train import TrainCapture
from perfbench.program import Program, plain_changes

NAMES = ('rpn_err', 'proposal_mismatch', 'target_mismatch', 'loss_gap',
         'grad_norm_gap', 'grad_gap', 'delta_gap')
TINY_LEAF = 1e-3


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep) -> float:
    """max over the leaves in `keep` of | |got| - |want| | / max(|want|,
    the median leaf's |want|)."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double()))
             for k in keep}
    if not norms:
        return float('nan')
    med = statistics.median(norms.values())
    return max(abs(float(torch.linalg.vector_norm(got[k].double()))
                   - norms[k]) / max(norms[k], med, 1e-30) for k in keep)


class TrainReference:
    """The reference training step of a cell, with the benchmark's weights
    of the run's seed."""

    def __init__(self, tree, traffic, seed: int, device):
        from perfbench.drivers.joint import build_weights
        self.ref = Program('perfbench.reference')
        self.cfg = self.ref.make_config(tree, **plain_changes('float32'))
        self.dev = torch.device(device)
        self.seed = seed
        model = self.ref.point_rcnn.PointRCNN(self.cfg, mode='TRAIN',
                                              device='meta')
        model = model.to_empty(device=self.dev)
        model.load_state_dict(build_weights(tree, self.dev, seed)[0])
        self.model = model
        self.opt = self.ref.train_step.make_optimizer(
            self.cfg, model, int(traffic['steps_per_epoch']))

    def _step(self, k: int, batch, out) -> Dict[str, float]:
        """Reference step k on `batch`, following the program's forward
        outputs `out`; returns the stage numbers and the loss terms."""
        from perfbench.reference.models import proposal
        ts, cfg, dev = self.ref.train_step, self.cfg, self.dev
        b = ts.to_device(batch, dev)
        num = {}
        with torch.no_grad():
            img = b.get('img')
            rpn = self.model.rpn(b['pts_input'], img, b.get('pts_xy'))
            num['rpn_err'] = max(rel_err(out[k2], rpn[k2])
                                 for k2 in ('rpn_cls', 'rpn_reg'))
            scores = out['rpn_cls'][:, :, 0]
            props = proposal.proposal_layer(cfg, 'TRAIN', scores,
                                            out['rpn_reg'],
                                            out['backbone_xyz'])
            num['proposal_mismatch'] = float(
                mismatches(out['rois'], props.boxes)
                + mismatches(out['roi_scores_raw'], props.scores)
                + mismatches(out['roi_mask'], props.mask))
            seg = (torch.sigmoid(scores) > cfg.RPN.SCORE_THRESH).float()
            depth = torch.linalg.norm(out['backbone_xyz'], dim=2)
            draws = proposal.sample_roi_draws(
                cfg, scores.shape[0], cfg.TRAIN.RPN_POST_NMS_TOP_N,
                torch.Generator().manual_seed(ts.step_seed(self.seed, k)),
                dev)
            targets = proposal.proposal_target_layer(
                cfg, draws, out['backbone_xyz'], out['backbone_features'],
                seg, depth, out['rois'], b['gt_boxes3d'], b['gt_tids'])
            got = out['targets']
            num['target_mismatch'] = float(sum(
                mismatches(getattr(got, f), getattr(targets, f))
                for f in targets._fields))
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            rcnn = self.model.rcnn(got.pts_input, gt_tids=got.gt_tids,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(
                                           ts.step_seed(self.seed, k)))
            output = dict(out, **rcnn, targets=got)
            loss, tb = ts.compute_losses(cfg, output, b)
            loss.backward()
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        tb['grad_norm'] = ts.global_norm(grads)
        self.opt.step()
        return num, ts.scalars(tb)

    def compare(self, cap: TrainCapture) -> Dict[str, float]:
        nums, terms, mu1 = [], [], None
        for k, (batch, out) in enumerate(zip(cap.batches, cap.outs)):
            num, tb = self._step(k, batch, out)
            nums.append(num)
            terms.append(tb)
            if k == 0:
                mu1 = {n: m.clone() for n, m in zip(self.opt.names,
                                                    self.opt.mu)}
        res = {n: max(x[n] for x in nums) for n in nums[0]}
        for name, term in (('loss_gap', 'loss'), ('grad_norm_gap',
                                                   'grad_norm')):
            res[name] = max(abs(p[term] - r[term]) / max(abs(r[term]), 1e-30)
                            for p, r in zip(cap.terms, terms))
        scale = 1.0 / (1.0 - self.opt.B1)
        g_ref = {k: v * scale for k, v in mu1.items()}
        g_got = {k: v.to(self.dev) * scale for k, v in cap.mu1.items()}
        norms = {k: float(torch.linalg.vector_norm(v)) for k, v in
                 g_ref.items()}
        med = statistics.median(norms.values())
        keep = [k for k in g_ref if norms[k] >= TINY_LEAF * med]
        res['grad_gap'] = leaf_gaps(g_got, g_ref, keep)
        named = dict(self.model.named_parameters())
        p0 = {k: v.to(self.dev) for k, v in cap.params0.items()}
        d_ref = {k: named[k].detach() - p0[k] for k in keep}
        d_got = {k: cap.params[k].to(self.dev) - p0[k] for k in keep}
        res['delta_gap'] = leaf_gaps(d_got, d_ref, keep)
        return res


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number the cell's limits name, beside its limit."""
    return {n: {'value': numbers[n], 'limit': limits[n]} for n in NAMES
            if n in limits}
