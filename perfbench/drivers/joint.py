"""Driver of the joint detect + track step (`pipeline.make_joint_step`, or
`make_batched_joint_step` for S > 1 streams in lockstep).

A closed loop with one frame in flight: each frame's host arrays are
handed to the step and its packed rows read back to the host as numpy
before the next frame goes in.  Each stream cycles through a pool of one
generated sequence; at each wrap its tracker state is reset, as at a new
KITTI sequence.  Frames drawn from the seed are captured in the window
(references to the program's outputs, kept on the device) for the
comparison with the reference after the window.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from perfbench import generator
from perfbench.program import Program
from perfbench.trace import Spans, profile
from perfbench.weights import seeded_state


class Capture(NamedTuple):
    """One captured frame, every tensor with a leading stream axis."""
    pts: np.ndarray
    img: Optional[np.ndarray]
    xy: np.ndarray
    out: Dict[str, Any]          # the PointRCNN forward's outputs
    det: Dict[str, torch.Tensor]  # the detection step's outputs
    state_in: Any                # tracker state before the frame
    track_in: tuple              # (frame_ids, boxes, scores, feats, mask)
    state_out: Any
    packed: torch.Tensor         # (S, T, 10)


class _Recorder:
    """Keeps what the wrapped layers return while `on`."""

    def __init__(self, spans: Spans):
        self.on = False
        self.spans = spans
        self.got: Dict[str, Any] = {}

    def wrap(self, name: str, fn):
        def wrapped(*args):
            with self.spans(name):
                out = fn(*args)
            if self.on:
                self.got[name] = (args, out)
            return out
        return wrapped


def _batched_state(state):
    return state._replace(**{k: v[None] for k, v in state._asdict().items()
                             if k != 'mats'})


def build_weights(tree, device, seed):
    """(model state, link head state) drawn from `seed` on `device`, shaped
    by the reference's modules of the configuration `tree`."""
    ref = Program('perfbench.reference')
    cfg = ref.make_config(tree)
    feat_dim = cfg.RCNN.SA_CONFIG.MLPS[-1][-1]
    both = nn.ModuleDict({
        'model': ref.point_rcnn.PointRCNN(cfg, device='meta'),
        'link': ref.rcnn.CorrelationHead(feat_dim, cfg.REID.LINK_FC,
                                         use_bn=cfg.REID.USE_BN,
                                         device='meta')})
    state = seeded_state(both, seed, device)
    split = {'model': {}, 'link': {}}
    for key, value in state.items():
        part, rest = key.split('.', 1)
        split[part][rest] = value
    return split['model'], split['link']


class JointRun:
    """Set-up of one run of a joint-step cell: weights, program, pool,
    warm-up.  `program` is the system under test (or, for the control,
    the reference with its lower-precision marks, `mark`)."""

    def __init__(self, tree: Dict[str, Any], tracker: Dict[str, Any],
                 traffic: Dict[str, Any], seed: int, device,
                 program: Optional[Program] = None, changes=None,
                 mark=None):
        self.dev = torch.device(device)
        self.prog = program or Program('jmodt_torch')
        self.streams = int(traffic['streams'])
        self.traffic = traffic
        self.seed = seed
        cfg = self.prog.make_config(tree, **(changes or {}))
        self.cfg = cfg
        self.model_state, self.head_state = build_weights(tree, self.dev,
                                                          seed)
        model = self.prog.point_rcnn.PointRCNN(cfg, device='meta')
        model = model.to_empty(device=self.dev)
        model.load_state_dict(self.model_state)
        self.feat_dim = cfg.RCNN.SA_CONFIG.MLPS[-1][-1]
        head = self.prog.rcnn.CorrelationHead(
            self.feat_dim, cfg.REID.LINK_FC, use_bn=cfg.REID.USE_BN)
        head.load_state_dict(self.head_state)
        if mark is not None:
            mark(model)
        model.eval()
        head.to(self.dev).eval()

        self.spans = Spans()
        self.rec = _Recorder(self.spans)
        self._hooks = list(self.spans.hook(model.rpn.backbone, 'backbone'))
        self._hooks.append(model.register_forward_hook(self._keep_out))
        kw = dict(tracker)
        self.max_tracks = kw.pop('max_tracks')
        pipe = self.prog.pipeline
        names = ('make_detection_step', 'make_device_tracker_step',
                 'make_batched_tracker_step')
        saved = {n: getattr(pipe, n) for n in names}
        for n, layer in zip(names, ('detection', 'tracker', 'tracker')):
            setattr(pipe, n, lambda *a, _f=saved[n], _l=layer, **k:
                    self.rec.wrap(_l, _f(*a, **k)))
        try:
            make = (pipe.make_joint_step if self.streams == 1
                    else pipe.make_batched_joint_step)
            self.joint = make(cfg, model, head, device=self.dev, **kw)
        finally:
            for n in names:
                setattr(pipe, n, saved[n])

        self.pool = self._make_pool()
        self.pos = 0
        self.state = self._init_state()

    def _keep_out(self, _mod, _args, out):
        if self.rec.on:
            self.rec.got['out'] = out

    def _make_pool(self):
        t = self.traffic
        img_hw = (tuple(t['image_hw']) if self.cfg.LI_FUSION.ENABLED
                  else None)
        seqs = [generator.make_sequence(
            generator.stream_seed(self.seed, s), int(t['pool_frames']),
            self.cfg.RPN.NUM_POINTS, img_hw, self.cfg.mean_size,
            cars=tuple(t['cars']), speed=tuple(t['speed']))
            for s in range(self.streams)]
        pool = []
        for frames in zip(*seqs):
            pool.append({
                'pts': np.stack([f['pts'] for f in frames]),
                'img': (None if img_hw is None
                        else np.stack([f['img'] for f in frames])),
                'xy': np.stack([f['pts_xy'] for f in frames])})
        return pool

    def _init_state(self):
        trk = self.prog.tracker
        if self.streams == 1:
            return trk.init_state(self.max_tracks, self.feat_dim, self.dev)
        return trk.init_batched_state(self.streams, self.max_tracks,
                                      self.feat_dim, self.dev)

    def sync(self):
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)

    def frame(self, capture: bool = False):
        """Hand the next frame to the step and read its rows to the host;
        returns (rows, the Capture when `capture`)."""
        if self.pos == len(self.pool):
            self.state = self._init_state()
            self.pos = 0
        f = self.pool[self.pos]
        self.pos += 1
        fid = (self.pos if self.streams == 1
               else np.full(self.streams, self.pos, np.int32))
        self.rec.on = capture
        self.rec.got = {}
        with self.spans('joint'):
            self.state, packed = self.joint(self.state, fid, f['pts'],
                                            f['img'], f['xy'])
        rows = packed.cpu().numpy()
        self.rec.on = False
        if not capture:
            return rows, None
        (t_args, t_out) = self.rec.got['tracker']
        (_, det) = self.rec.got['detection']
        st_in, track_in = t_args[0], t_args[1:]
        st_out = t_out[0]
        if self.streams == 1:
            st_in, st_out = _batched_state(st_in), _batched_state(st_out)
            track_in = (torch.tensor([int(track_in[0])], dtype=torch.int32),
                        *(torch.as_tensor(x)[None] for x in track_in[1:]))
            packed = packed[None]
        else:
            track_in = (torch.as_tensor(track_in[0]), *track_in[1:])
        return rows, Capture(pts=f['pts'], img=f['img'], xy=f['xy'],
                             out=self.rec.got['out'], det=det,
                             state_in=st_in, track_in=tuple(track_in),
                             state_out=st_out, packed=packed)

    def warm_up(self, frames: int) -> None:
        """Every shape of the cell's traffic once: `frames` frames (a
        capture among them), then back to the pool's start."""
        for i in range(frames):
            self.frame(capture=i == frames - 1)
        self.sync()
        self.pos = len(self.pool)

    def close(self):
        for h in self._hooks:
            h.remove()


def window(run: JointRun, seconds: float, check_at, frames: int = 0
           ) -> dict:
    """The measured window: frames for `seconds` (or, with `frames`,
    exactly that many), each timed from the hand over of its host arrays
    to its rows on the host; captures the frames whose index is in
    `check_at`."""
    lat: List[float] = []
    caps: List[Capture] = []
    t0 = time.perf_counter()
    end = t0 + seconds
    t2 = t0
    while (len(lat) < frames) if frames else (t2 < end):
        k = len(lat)
        t1 = time.perf_counter()
        _, cap = run.frame(capture=k in check_at)
        t2 = time.perf_counter()
        lat.append(t2 - t1)
        if cap is not None:
            caps.append(cap)
    return dict(latencies=lat, window_s=t2 - t0, captures=caps,
                frames=len(lat) * run.streams)


def traced(run: JointRun, frames: int):
    """`frames` joint frames under the profiler with the spans on."""
    run.spans.on = True
    try:
        return profile(lambda: [run.frame() for _ in range(frames)],
                       frames * run.streams, run.sync)
    finally:
        run.spans.on = False


def check_frames(seed: int, traffic: Dict[str, Any]) -> set:
    """The window's frames that the comparison reads, drawn from the seed
    among the first `check_span` frames."""
    rng = np.random.RandomState(generator.stream_seed(seed, 1 << 20))
    span, n = int(traffic['check_span']), int(traffic['check_frames'])
    return set(int(i) for i in rng.choice(span, n, replace=False))


class LayerContext(NamedTuple):
    """What the per-layer readers of a traced run read."""
    trace: Any                   # perfbench.trace.Trace
    streams: int
    frames_per_s: float          # stream-frames/s, the profiler off
    flops_per_frame: float       # the frozen count, one stream-frame
    bounds: Dict[str, float]     # least seconds a frame, by kernel name


def run_cell(spec) -> dict:
    """One run of a joint-step cell: set-up, the window (after a traced
    stretch when `spec.trace`), the reference's comparison."""
    from perfbench import check, flops, roofline
    from perfbench.stats import percentile
    run = JointRun(spec.tree, spec.tracker, spec.traffic, spec.seed,
                   spec.device, program=getattr(spec, 'program', None),
                   changes=getattr(spec, 'changes', None),
                   mark=getattr(spec, 'mark', None))
    run.warm_up(int(spec.traffic['warm_frames']))
    setup_s = time.perf_counter() - spec.t0
    tr = None
    if spec.trace:
        tr = traced(run, int(spec.traffic['trace_frames']))
    w = window(run, spec.seconds, check_frames(spec.seed, spec.traffic))
    run.sync()
    peak = (torch.cuda.max_memory_allocated(run.dev)
            if run.dev.type == 'cuda' else 0)
    caps = w['captures']
    states = (run.model_state, run.head_state)
    run.close()
    del run
    if spec.device != 'cpu':
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    ref = check.Reference(spec.tree, spec.tracker, *states, spec.device)
    numbers = [ref.compare(c) for c in caps]
    checks = check.judge(numbers, spec.limits)
    check_s = time.perf_counter() - t_check
    lat_ms = [x * 1e3 for x in w['latencies']]
    e2e = {'frames_per_s': w['frames'] / w['window_s'],
           'frame_latency_p95_ms': percentile(lat_ms, 95),
           'setup_s': setup_s}
    layer = None
    if tr is not None:
        streams = int(spec.traffic['streams'])
        f = flops.detection_flops(ref.cfg, track_k=spec.tracker['track_k'],
                                  max_tracks=spec.tracker['max_tracks'],
                                  feat_dim=ref.cfg.RCNN.SA_CONFIG.MLPS[-1][-1])
        layer = LayerContext(trace=tr, streams=streams,
                             frames_per_s=e2e['frames_per_s'],
                             flops_per_frame=f['total'],
                             bounds=roofline.frame_bounds(ref.cfg, streams))
    return dict(end_to_end=e2e, layer=layer, checks=checks,
                attempted=w['frames'], failed=0, memory_peak_bytes=peak,
                checked=len(caps), check_s=check_s)
