"""The joint step replayed as CUDA graphs against the same step run eagerly.

`check(cfg, n_frames, streams, device, tol)` runs `make_joint_step` (or,
with `streams`, the lockstep step `make_batched_joint_step`) over
`n_frames` synthetic frames, with the tracker state reset halfway unless
`reset` is false.  The sequence runs twice from the same weights and a
fresh state: under `graphs.eager()`, and as it runs by default (on the
card the first frame eager, the second captured, the rest replayed).  Per
frame it keeps the PointRCNN forward's outputs, the detection step's, the
tracker state and the packed rows, and holds:

* every integer and boolean tensor of the two runs equal (NMS keeps, RoI
  masks, assignment, track ids, emit flags) and every float one within
  `tol` of its scale (max |a - b| / max |b|);
* each frame's tensors unchanged after the later frames (a replay's
  outputs are fresh tensors);
* the wrapper launches (`kernels.launches`) a frame: the eager run's in a
  default-run frame that ran its sections' Python (eager or captured),
  none in one that only replayed;
* on the card, a replay of each section in every frame from the second
  (its capture's) on, and in each the kernels its graphs launch, read
  from their kernel nodes through the CUDA driver (`graph_kernels`),
  equal to the eager frame's wrapper launches.

chip_smoke.py's phase 19, `perfbench/tests/test_graphs_on_card.py` and
`tests/test_torch_graphs.py` call it.
"""

from __future__ import annotations

import collections
import ctypes
import re
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from jmodt_torch.config import Config
from jmodt_torch.ops import kernels
from jmodt_torch.utils import graphs

SECTIONS = ('backbone', 'detection', 'decode', 'tracker')
JOINT = dict(track_k=16, det_score_thresh=0.2, assign='hungarian')
MAX_TRACKS = 64


def _leaves(x) -> List[tuple]:
    """[(path, tensor)] of the tensors of a pytree."""
    flat, _ = pytree.tree_flatten_with_path(x)
    return [(pytree.keystr(p), t) for p, t in flat
            if isinstance(t, torch.Tensor)]


def _names(fn: str, name: str) -> bool:
    """Whether a kernel's name, demangled or mangled (the Itanium ABI
    writes an identifier as its length and itself), is function `fn`."""
    return (f'{len(fn)}{fn}' in name
            or re.search(rf'\b{fn}\b', name) is not None)


def launches_of(names) -> Dict[str, int]:
    """{counter: launches} as `kernels.launches` would count them, read
    from the names of the kernels that ran (`kernels.KERNELS`' symbols;
    K5's launch also runs K1's FPS grid); counters with none left out."""
    seen = collections.Counter(
        c for name in names for c, k in kernels.KERNELS.items()
        if _names(k.symbol, name))
    seen['fps'] -= seen['sa_level']
    return {c: n for c, n in seen.items() if n}


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""
    _fields_ = [('func', ctypes.c_void_p), ('grid', ctypes.c_uint * 3),
                ('block', ctypes.c_uint * 3),
                ('shared_mem_bytes', ctypes.c_uint),
                ('kernel_params', ctypes.c_void_p),
                ('extra', ctypes.c_void_p), ('kern', ctypes.c_void_p),
                ('ctx', ctypes.c_void_p)]


_driver: list = []
_graph_names: 'weakref.WeakKeyDictionary' = weakref.WeakKeyDictionary()


def _cu(name: str, *args) -> None:
    if not _driver:
        _driver.append(ctypes.CDLL('libcuda.so.1'))
    err = getattr(_driver[0], name)(*args)
    if err:
        raise RuntimeError(f'{name}: CUresult {err}')


def graph_kernels(graph) -> List[str]:
    """The names of the kernel nodes of a captured `torch.cuda.CUDAGraph`
    (kept, `utils/graphs.py`), as the CUDA driver has them: what each of
    its replays launches."""
    if graph in _graph_names:
        return _graph_names[graph]
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    _cu('cuGraphGetNodes', g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _cu('cuGraphGetNodes', g, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        _cu('cuGraphNodeGetType', ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                   # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p, name = _KernelNodeParams(), ctypes.c_char_p()
        _cu('cuGraphKernelNodeGetParams_v2', ctypes.c_void_p(node),
            ctypes.byref(p))
        if p.func:
            _cu('cuFuncGetName', ctypes.byref(name), ctypes.c_void_p(p.func))
        else:
            _cu('cuKernelGetName', ctypes.byref(name),
                ctypes.c_void_p(p.kern))
        names.append(name.value.decode())
    _graph_names[graph] = names
    return names


def replayed_launches(run: Callable):
    """(what `run()` returned, {counter: launches} of the CUDA graphs it
    replayed, read from the graphs' kernel nodes): a replay calls no
    wrapper, so `kernels.launches` does not see its kernels."""
    with graphs.replayed() as seen:
        out = run()
    return out, launches_of(n for g in seen for n in graph_kernels(g))


def _scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err / scale if scale > 0 else err


def build(cfg: Config, streams: Optional[int], device, seed: int = 0,
          joint_kw: Optional[dict] = None):
    """(joint step, record, make_state): the joint step (lockstep over
    `streams` when given) on `device` with weights from `seed`, `record`
    the dict where each frame's forward outputs ('out') and detection
    outputs ('det') land, and a maker of empty states."""
    from jmodt_torch import pipeline
    from jmodt_torch.models.point_rcnn import build_detector, init_weights
    from jmodt_torch.models.rcnn import CorrelationHead
    from jmodt_torch.tracking.device_tracker import (init_batched_state,
                                                     init_state)
    feat_dim = cfg.RCNN.SA_CONFIG.MLPS[-1][-1]
    model = build_detector(cfg, device=device, seed=seed)
    head = CorrelationHead(feat_dim, cfg.REID.LINK_FC, use_bn=cfg.REID.USE_BN)
    init_weights(head, seed + 1)
    record: Dict[str, object] = {}
    model.register_forward_hook(
        lambda _m, _a, out: record.__setitem__('out', out))
    made = pipeline.make_detection_step

    def recording(*a, **k):
        step = made(*a, **k)

        def rec(*args):
            record['det'] = step(*args)
            return record['det']
        return rec

    pipeline.make_detection_step = recording
    try:
        if streams is None:
            joint = pipeline.make_joint_step(cfg, model, head, device=device,
                                             **(joint_kw or JOINT))
        else:
            joint = pipeline.make_batched_joint_step(
                cfg, model, head, device=device, **(joint_kw or JOINT))
    finally:
        pipeline.make_detection_step = made

    def make_state():
        if streams is None:
            return init_state(MAX_TRACKS, feat_dim, device)
        return init_batched_state(streams, MAX_TRACKS, feat_dim, device)

    return joint, record, make_state


def run(joint, record, make_state, inputs, reset_at: Optional[int] = None,
        on_card: bool = False):
    """The frames of `inputs` [(frame_id, pts, img, xy)] through `joint`
    from an empty state (a new one at frame `reset_at`); per frame its
    tensors {'out', 'det', 'state', 'packed'}, their clones taken right
    after it, its wrapper launches and section counts, and `on_card` the
    launches of the CUDA graphs it replayed (`replayed_launches`)."""
    frames = []
    state = make_state()
    for i, (fid, pts, img, xy) in enumerate(inputs):
        if i == reset_at:
            state = make_state()
        launches, counts = kernels.launches.copy(), kernels.graphs.copy()
        with graphs.replayed() as seen:
            state, packed = joint(state, fid, pts, img, xy)
        got = {'out': record['out'], 'det': record['det'], 'state': state,
               'packed': packed}
        frames.append(dict(
            got=got, copy=[(k, t.clone()) for k, t in _leaves(got)],
            launches=dict(kernels.launches - launches),
            graphs=dict(kernels.graphs - counts),
            replayed=launches_of(n for g in seen for n in graph_kernels(g))
            if on_card else None))
    return frames


def replay_only(counts: Dict[str, int]) -> bool:
    """Whether a frame's section counts show replays and nothing else."""
    return bool(counts) and all(k.endswith('.replays') for k in counts)


def compare(eager, replayed, tol: float) -> dict:
    """The checks of the module's docstring over two runs of `run`;
    {'failures': [...], 'max_float_err': ..., 'tensors': ...}."""
    fails: List[str] = []
    worst, n = 0.0, 0
    for name, frames in (('eager', eager), ('replayed', replayed)):
        for i, f in enumerate(frames):
            now = dict(_leaves(f['got']))
            for k, t in f['copy']:
                if not torch.equal(now[k], t):
                    fails.append(f'{name} frame {i}: {k} changed after '
                                 'later frames')
    for i, (a, b) in enumerate(zip(replayed, eager)):
        got, want = dict(_leaves(a['got'])), dict(_leaves(b['got']))
        if got.keys() != want.keys():
            fails.append(f'frame {i}: outputs {sorted(got)} against '
                         f'{sorted(want)}')
            continue
        for k, g in got.items():
            w = want[k]
            n += 1
            if g.shape != w.shape or g.dtype != w.dtype:
                fails.append(f'frame {i}: {k} {tuple(g.shape)} {g.dtype} '
                             f'against {tuple(w.shape)} {w.dtype}')
            elif g.is_floating_point():
                err = _scale_err(g, w)
                worst = max(worst, err)
                if not err <= tol:
                    fails.append(f'frame {i}: {k} err {err:.3g}')
            elif not torch.equal(g, w):
                fails.append(f'frame {i}: {k} differs')
        want_launches = {} if replay_only(a['graphs']) else b['launches']
        if a['launches'] != want_launches:
            fails.append(f'frame {i}: wrapper launches {a["launches"]} '
                         f'({a["graphs"]}), expected {want_launches}')
    return {'failures': fails, 'max_float_err': worst, 'tensors': n}


def compare_replayed(eager, replayed) -> List[str]:
    """Failures where a frame that replayed every section launched,
    by its graphs' kernel nodes, other kernels than the eager frame."""
    fails = []
    for i, (a, b) in enumerate(zip(replayed, eager)):
        every = all(a['graphs'].get(f'{s}.replays') for s in SECTIONS)
        if every and a['replayed'] != b['launches']:
            fails.append(f'frame {i}: its graphs launch {a["replayed"]}, '
                         f'the eager frame launched {b["launches"]}')
    return fails


def _sections_replayed(frames, first: int) -> List[str]:
    """Failures where a frame from index `first` on lacks a replay of
    every section."""
    out = []
    for i, f in enumerate(frames[first:], start=first):
        missing = [s for s in SECTIONS
                   if f['graphs'].get(f'{s}.replays', 0) < 1]
        if missing:
            out.append(f'replayed frame {i}: no replay of {missing} '
                       f'({f["graphs"]})')
    return out


def frames_of(cfg: Config, n: int, streams: Optional[int], fusion: bool,
              img_hw=None):
    """`n` inputs (frame_id, pts, img, xy) of one stream, or of `streams`
    streams in lockstep (stream s at seed t + s); images of `img_hw`
    (default: the synthetic scenes' 384x1280)."""
    from jmodt_torch.data import synthetic
    per = streams or 1
    hw = img_hw or (synthetic.IMG_H, synthetic.IMG_W)
    out = []
    for t in range(n):
        fs = [synthetic.make_eval_frame(t + s, cfg, img_hw=hw, raw_u8=True)
              for s in range(per)]
        img = (np.concatenate([f['img'] for f in fs]) if fusion else None)
        fid = (t + 1 if streams is None
               else np.full(streams, t + 1, np.int32))
        out.append((fid, np.concatenate([f['pts_input'] for f in fs]), img,
                    np.concatenate([f['pts_xy'] for f in fs])))
    return out


def check(cfg: Config, n_frames: int, streams: Optional[int], device,
          tol: float, reset: bool = True, img_hw=None,
          joint_kw: Optional[dict] = None) -> dict:
    """One configuration's two runs and their comparison (`joint_kw`:
    the joint step's settings, JOINT by default)."""
    fusion = cfg.LI_FUSION.ENABLED
    joint, record, make_state = build(cfg, streams, device,
                                      joint_kw=joint_kw)
    inputs = frames_of(cfg, n_frames, streams, fusion, img_hw)
    reset_at = n_frames // 2 if reset else None
    with graphs.eager():
        eager = run(joint, record, make_state, inputs, reset_at)
    on_card = torch.device(device).type == 'cuda'
    replayed = run(joint, record, make_state, inputs, reset_at, on_card)
    res = compare(eager, replayed, tol)
    if graphs.backend.supports(torch.device(device)):
        res['failures'] += _sections_replayed(replayed, 1)
    if on_card:
        res['failures'] += compare_replayed(eager, replayed)
        res['replayed_launches'] = [f['replayed'] for f in replayed]
    res['graphs'] = [f['graphs'] for f in replayed]
    emitted = [f['got']['packed'][..., 9].sum().item() for f in eager]
    res['rows_emitted'] = emitted
    if not any(emitted):
        res['failures'].append('no row emitted in any frame')
    return res
