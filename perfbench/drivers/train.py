"""Driver of the training step (`train.train_step.make_train_step` with
`make_optimizer`): a PointRCNN(mode='TRAIN') over batches of frame pairs.

Set-up builds one training step with its model and optimizer state and
drives it through its first steps (`check_steps`, on batches whose rows
all differ), keeping what the comparison needs: each step's forward
outputs and loss terms, the optimizer's first moments after the first
step, the parameters before the first step and after the last.  The
window then runs the same object on, cycling through a pool of batches
made from the seed, without a host read until its end.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from perfbench import generator
from perfbench.drivers.joint import build_weights
from perfbench.program import Program
from perfbench.trace import Spans, profile


class TrainCapture(NamedTuple):
    """The first steps of a run, for the comparison."""
    batches: List[Dict[str, Any]]   # the numpy batches, in step order
    outs: List[Dict[str, Any]]      # each step's TRAIN forward outputs
    terms: List[Dict[str, float]]   # each step's loss terms, on the host
    params0: Dict[str, torch.Tensor]  # trainable parameters before step 1
    mu1: Dict[str, torch.Tensor]    # the optimizer's first moments after 1
    params: Dict[str, torch.Tensor]  # trainable parameters after the last


class TrainRun:
    """Set-up of one run of a training cell.  `program` is the system under
    test (or, for the control, the reference with its lower-precision
    marks, `mark`)."""

    def __init__(self, tree: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, device, program: Optional[Program] = None,
                 changes=None, mark=None):
        self.dev = torch.device(device)
        self.prog = program or Program('jmodt_torch')
        self.pairs = int(traffic['pairs'])
        cfg = self.prog.make_config(tree, **(changes or {}))
        self.model_state, _ = build_weights(tree, self.dev, seed)
        model = self.prog.point_rcnn.PointRCNN(cfg, mode='TRAIN',
                                               device='meta')
        model = model.to_empty(device=self.dev)
        model.load_state_dict(self.model_state)
        if mark is not None:
            mark(model)
        self.model = model
        ts = self.prog.train_step
        self.opt = ts.make_optimizer(cfg, model,
                                     int(traffic['steps_per_epoch']))
        self.spans = Spans()
        self._out = None
        self._keep = False
        self._hooks = list(self.spans.hook(model, 'forward'))
        self._hooks.append(model.register_forward_hook(self._keep_out))
        opt_step = self.opt.step
        self.opt.step = lambda: self._span('optimizer', opt_step)
        # the step looks these up in its module at each call
        self._saved = {n: getattr(ts, n) for n in ('compute_losses',
                                                  'to_device')}
        ts.compute_losses = lambda *a: self._span(
            'forward', self._saved['compute_losses'], *a)
        ts.to_device = lambda *a, **k: self._span(
            'upload', self._saved['to_device'], *a, **k)
        self.step = ts.make_train_step(cfg, model, self.opt, seed=seed,
                                       device=self.dev)
        img_hw = (tuple(traffic['image_hw']) if cfg.LI_FUSION.ENABLED
                  else None)
        self.pool = [generator.make_pairs(
            generator.stream_seed(seed, b), self.pairs, cfg.RPN.NUM_POINTS,
            img_hw, cfg.mean_size, cars=tuple(traffic['cars']))
            for b in range(int(traffic['batches']))]
        self.done = 0

    def _span(self, name, fn, *args, **kw):
        with self.spans(name):
            return fn(*args, **kw)

    def _keep_out(self, _mod, _args, out):
        if self._keep:
            self._out = {k: (v.detach() if torch.is_tensor(v) else v)
                         for k, v in out.items()}

    def sync(self):
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)

    def run_step(self, keep: bool = False):
        """One optimizer step on the next batch of the pool; returns its
        loss terms (device scalars) and, with `keep`, its outputs."""
        batch = self.pool[self.done % len(self.pool)]
        self.done += 1
        self._keep = keep
        with self.spans('step'):
            tb = self.step(batch)
        self._keep = False
        return tb, self._out if keep else None

    def trainable(self) -> Dict[str, torch.Tensor]:
        named = dict(self.model.named_parameters())
        return {n: named[n].detach().clone() for n in self.opt.names}

    def first_steps(self, n: int) -> TrainCapture:
        """The run's first `n` steps, kept for the comparison."""
        params0 = self.trainable()
        batches, outs, terms, mu1 = [], [], [], None
        for i in range(n):
            batches.append(self.pool[self.done % len(self.pool)])
            tb, out = self.run_step(keep=True)
            outs.append(out)
            terms.append(self.prog.train_step.scalars(tb))
            if i == 0:
                mu1 = {k: m.detach().clone()
                       for k, m in zip(self.opt.names, self.opt.mu)}
        self.sync()
        return TrainCapture(batches, outs, terms, params0, mu1,
                            self.trainable())

    def close(self):
        for h in self._hooks:
            h.remove()
        for n, f in self._saved.items():
            setattr(self.prog.train_step, n, f)


def window(run: TrainRun, seconds: float) -> dict:
    """Steps for `seconds`, reading the host only once, at the end."""
    t0 = time.perf_counter()
    end = t0 + seconds
    steps, tb = 0, None
    while time.perf_counter() < end:
        tb, _ = run.run_step()
        steps += 1
    float(tb['loss'].detach())
    return dict(steps=steps, window_s=time.perf_counter() - t0)


def traced(run: TrainRun, steps: int):
    run.spans.on = True
    try:
        return profile(lambda: [run.run_step() for _ in range(steps)],
                       steps, run.sync)
    finally:
        run.spans.on = False


class LayerContext(NamedTuple):
    """What the per-layer readers of a traced training run read."""
    trace: Any
    steps_per_s: float           # the profiler off
    flops_per_step: float
    bounds: Dict[str, float]     # least seconds a step, by kernel name


def step_flops(cfg, pairs: int) -> float:
    """The frozen count of a finetune step: the eval forward's terms at
    the step's shapes (2 x pairs frames, ROI_PER_IMAGE RoIs a frame, no
    tracker), plus the link / se heads' forward over each pair's
    ROI_PER_IMAGE x ROI_PER_IMAGE links and 2 x ROI_PER_IMAGE start / end
    features, counted three times (forward and a backward of twice the
    work).  The RCNN trunk's backward, which the step also computes (its
    gradient enters `grad_norm`), is left out: a lower bound."""
    from perfbench.flops import _mlp_macs, detection_flops
    frames = 2 * pairs
    r = cfg.RCNN.ROI_PER_IMAGE
    f = detection_flops(cfg, rois=r)['total'] * frames
    c = cfg.RCNN.SA_CONFIG.MLPS[-1][-1]
    heads = (_mlp_macs(r * r, c, list(cfg.REID.LINK_FC) + [1])
             + _mlp_macs(2 * r, c, list(cfg.REID.SE_FC) + [1]))
    return f + 3 * 2.0 * heads * pairs


def run_cell(spec) -> dict:
    """One run of a training cell: set-up with the first steps, the window
    (after a traced stretch when `spec.trace`), the reference's
    comparison."""
    from perfbench import check_train, roofline
    t = spec.traffic
    run = TrainRun(spec.tree, t, spec.seed, spec.device,
                   program=getattr(spec, 'program', None),
                   changes=getattr(spec, 'changes', None),
                   mark=getattr(spec, 'mark', None))
    cap = run.first_steps(int(t['check_steps']))
    setup_s = time.perf_counter() - spec.t0
    tr = traced(run, int(t['trace_steps'])) if spec.trace else None
    w = window(run, spec.seconds)
    peak = (torch.cuda.max_memory_allocated(run.dev)
            if run.dev.type == 'cuda' else 0)
    pairs = run.pairs
    run.close()
    del run
    if spec.device != 'cpu':
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    ref = check_train.TrainReference(spec.tree, t, spec.seed, spec.device)
    checks = check_train.judge(ref.compare(cap), spec.limits)
    check_s = time.perf_counter() - t_check
    e2e = {'train_pairs_per_s': w['steps'] * pairs / w['window_s'],
           'setup_s': setup_s}
    layer = None
    if tr is not None:
        layer = LayerContext(
            trace=tr, steps_per_s=w['steps'] / w['window_s'],
            flops_per_step=step_flops(ref.cfg, pairs),
            bounds=roofline.train_step_bounds(ref.cfg, 2 * pairs))
    return dict(end_to_end=e2e, layer=layer, checks=checks,
                attempted=w['steps'] * pairs, failed=0,
                memory_peak_bytes=peak, checked=len(cap.outs),
                check_s=check_s)
