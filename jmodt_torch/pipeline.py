"""Joint detection + tracking, one step per frame (counterpart of
`jmodt_tpu/pipeline.py`): the detection step, the top-K detections by
score, and the device tracker's step, packed into one (T, 10) tensor of
rows [tid, x, y, z, h, w, l, ry, score, emit].

`make_joint_step` steps one stream; `make_batched_joint_step` steps S
streams in lockstep, on one device or split over several; `make_scan_step`
runs K frames of one stream in one call.  `JointPipeline` and
`ScanPipeline` stream frames through them and read the rows back a few
frames, or a chunk, later.

The heads are `nn.Module`s that hold their weights; the JAX package passes
its weights as runtime arguments instead, for its TPU runtime's program
cache, which is no part of the semantics.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from jmodt_torch.config import Config
from jmodt_torch.device import resolve_device
from jmodt_torch.models.inference import make_detection_step
from jmodt_torch.models.point_rcnn import PointRCNN
from jmodt_torch.tracking.device_tracker import (init_state,
                                                 make_batched_tracker_step,
                                                 make_device_tracker_step)
from jmodt_torch.utils.trace import span, spanned


@spanned('jmodt.top_k')
def _top_k(det, track_k: int, det_score_thresh: float):
    """The tracker's inputs from a detection step's output, per frame of
    the batch: the `track_k` best kept detections, (boxes (B, K, 7),
    scores (B, K), feats (B, K, C), mask (B, K))."""
    scores = torch.where(det['keep'], det['scores'], -1.0)       # (B, M)
    # top-K with the lower index first among equal scores (masked rows
    # are all -1): a stable descending sort
    top = torch.sort(scores, dim=-1, descending=True,
                     stable=True).indices[:, :track_k]
    det_scores = torch.gather(scores, 1, top)
    boxes, feats = (torch.gather(det[k], 1, top[..., None].expand(
        -1, -1, det[k].shape[-1])) for k in ('boxes', 'feats'))
    return boxes, det_scores, feats, det_scores > det_score_thresh


@spanned('jmodt.pack')
def _pack(out) -> torch.Tensor:
    """Rows [tid, x, y, z, h, w, l, ry, score, emit] of a tracker output."""
    return torch.cat([out['tid'].float()[..., None], out['box'],
                      out['score'][..., None],
                      out['emit'].float()[..., None]], dim=-1)


def _rows(frame_id, arr):
    """(frame_id, [(tid, box (7,), score)]) of the emitted rows of one
    frame's packed (T, 10) array."""
    rows = arr[arr[:, 9] > 0.5]
    return frame_id, [(int(r[0]), r[1:8], float(r[8])) for r in rows]


def make_joint_step(cfg: Config, model: PointRCNN, link_head: nn.Module,
                    track_k: int = 16, det_score_thresh: float = 0.85,
                    device=None, **tracker_kw):
    """`joint(state, frame_id, pts, img, xy) -> (state, packed (T, 10))` on
    `device` (default: the CUDA card; raises without one), to which the
    model and heads are moved.  `tracker_kw` goes to
    `make_device_tracker_step`."""
    dev = resolve_device(device)
    det_step = make_detection_step(cfg, model, device=dev)
    trk_step = make_device_tracker_step(link_head, device=dev, **tracker_kw)

    @torch.no_grad()
    def joint(state, frame_id, pts, img, xy):
        with span('jmodt.joint'):
            det = det_step(pts, img, xy)
            boxes, scores, feats, mask = _top_k(det, track_k,
                                                det_score_thresh)
            state, out = trk_step(state, frame_id, boxes[0], scores[0],
                                  feats[0], mask[0])
            return state, _pack(out)

    return joint


def make_batched_joint_step(cfg: Config, model: PointRCNN,
                            link_head: nn.Module, track_k: int = 16,
                            det_score_thresh: float = 0.85, device=None,
                            devices: Optional[Sequence] = None,
                            **tracker_kw):
    """S independent streams advance in lockstep: one batched detection
    step over the S frames and one tracker step over the S states (offline
    evaluation over many sequences, several cameras served by one step).

    joint(states, frame_ids (S,), pts (S, N, 3), imgs (S, H, W, 3),
          xys (S, N, 2)) -> (states, packed (S, T, 10))

    on `device` (default: the CUDA card; raises without one).  Build
    `states` with `init_batched_state(S, max_tracks, feat_dim)`; packed
    rows are [tid, x, y, z, h, w, l, ry, score, emit] per stream.
    `tracker_kw` goes to `make_batched_tracker_step`.

    `devices` (the counterpart of the JAX package's `mesh`): the S streams
    split contiguously over them, S / len(devices) a part, and each part
    runs the step on its device with its own copy of the model and heads,
    with no communication; a device may be named twice.  `states` is then
    the tuple of the parts' states (`init_batched_state(..., devices=)`),
    and packed comes back on the first device in stream order.
    """
    if devices is not None:
        return _split_joint_step(cfg, model, link_head, track_k,
                                 det_score_thresh, devices, tracker_kw)
    dev = resolve_device(device)
    det_step = make_detection_step(cfg, model, device=dev)
    trk_step = make_batched_tracker_step(link_head, device=dev, **tracker_kw)

    @torch.no_grad()
    def joint(states, frame_ids, pts, imgs, xys):
        with span('jmodt.joint'):
            det = det_step(pts, imgs, xys)
            states, out = trk_step(states, frame_ids,
                                   *_top_k(det, track_k, det_score_thresh))
            return states, _pack(out)

    return joint


def _split_joint_step(cfg, model, link_head, track_k, det_score_thresh,
                      devices, tracker_kw):
    """`make_batched_joint_step` with its streams split over `devices`.

    The parts run one after another from the calling thread, so the split
    spreads the streams' memory and weights over the devices but not their
    time: each part's step is host-bound (it reads nothing back, but the
    host launches its kernels one by one), so a part's launches start only
    when the host has made the last part's.  A host thread a part was
    slower still, on one card and on two: running the parts at once needs
    a process a device."""
    devs = [resolve_device(d) for d in devices]
    parts = []
    for dev in devs:
        kw = {k: copy.deepcopy(v) if isinstance(v, nn.Module) else v
              for k, v in tracker_kw.items()}
        parts.append(make_batched_joint_step(
            cfg, copy.deepcopy(model), copy.deepcopy(link_head), track_k,
            det_score_thresh, device=dev, **kw))

    @torch.no_grad()
    def joint(states, frame_ids, pts, imgs, xys):
        s = len(frame_ids)
        if s % len(parts) or len(states) != len(parts):
            raise ValueError(f'{s} streams and {len(states)} states do not '
                             f'split over {len(parts)} devices')
        k = s // len(parts)
        new, packs = [], []
        for i, (step, state) in enumerate(zip(parts, states)):
            rows = slice(i * k, (i + 1) * k)
            state, packed = step(state, frame_ids[rows], pts[rows],
                                 None if imgs is None else imgs[rows],
                                 xys[rows])
            new.append(state)
            packs.append(packed.to(devs[0]))
        return tuple(new), torch.cat(packs)

    return joint


def make_scan_step(cfg: Config, model: PointRCNN, link_head: nn.Module,
                   track_k: int = 16, det_score_thresh: float = 0.85,
                   device=None, **tracker_kw):
    """Chunked streaming: the joint step over K stacked frames of one
    stream, in order.

    scan_step(state, frame_ids (K,), pts (K, 1, N, 3), imgs (K, 1, H, W, 3),
              xys (K, 1, N, 2)) -> (state, packed (K, T, 10))

    The same per-frame semantics as `make_joint_step`, whose step it runs
    frame after frame; the rows of the K frames come back in one tensor.
    """
    joint = make_joint_step(cfg, model, link_head, track_k=track_k,
                            det_score_thresh=det_score_thresh, device=device,
                            **tracker_kw)

    @torch.no_grad()
    def scan_step(state, frame_ids, pts, imgs, xys):
        packs = []
        for fid, p, im, xy in zip(frame_ids, pts, imgs, xys):
            state, packed = joint(state, fid, p, im, xy)
            packs.append(packed)
        return state, torch.stack(packs)

    return scan_step


class ScanPipeline:
    """Chunked streaming executor over `make_scan_step`: buffers `chunk`
    frames, runs them as one scan step, and reads the previous chunk's rows
    back (one host read a chunk) while the next one is queued."""

    def __init__(self, cfg: Config, model: PointRCNN, link_head: nn.Module,
                 feat_dim: int, chunk: int = 16, max_tracks: int = 64,
                 track_k: int = 16, det_score_thresh: float = 0.85,
                 device=None, **tracker_kw):
        self.device = resolve_device(device)
        self.scan = make_scan_step(cfg, model, link_head, track_k=track_k,
                                   det_score_thresh=det_score_thresh,
                                   device=self.device, **tracker_kw)
        self.chunk = chunk
        self.max_tracks = max_tracks
        self.feat_dim = feat_dim
        self.reset()

    def reset(self):
        self.state = init_state(self.max_tracks, self.feat_dim, self.device)
        self._buf = []
        self._pending = None  # (frame_ids, packed) of the previous chunk

    def push(self, frame_id: int, pts, img, xy):
        """Submit one frame; returns a list of (frame_id, rows) results,
        empty while buffering: results arrive a chunk at a time."""
        self._buf.append((frame_id, pts, img, xy))
        if len(self._buf) < self.chunk:
            return []
        fids = np.array([b[0] for b in self._buf], np.int32)
        stacked = [torch.stack([torch.as_tensor(b[i]) for b in self._buf])
                   for i in (1, 2, 3)]
        self._buf = []
        self.state, packed = self.scan(self.state, fids, *stacked)
        done = self._drain()
        self._pending = (fids, packed)
        return done

    def flush(self):
        """Run any buffered tail, padded to a full chunk by repeating the
        last frame, and drain all results.  Ends the sequence: the pad
        frames advance the tracker state, so call reset() before streaming
        another one."""
        out = []
        if self._buf:
            n = len(self._buf)
            last = self._buf[-1]
            while len(self._buf) < self.chunk - 1:
                self._buf.append(last)
            out.extend(self.push(*last))          # completes the chunk
            fids, packed = self._pending          # keep the n real frames
            self._pending = (fids[:n], packed[:n])
        out.extend(self._drain())
        return out

    def _drain(self):
        if self._pending is None:
            return []
        fids, packed = self._pending
        self._pending = None
        arr = packed.cpu().numpy()                # one read a chunk
        return [_rows(int(fid), a) for fid, a in zip(fids, arr)]


class JointPipeline:
    """Streams frames through the joint step and reads each frame's rows
    back `fetch_lag` frames later."""

    def __init__(self, cfg: Config, model: PointRCNN, link_head: nn.Module,
                 feat_dim: int, max_tracks: int = 64, track_k: int = 16,
                 fetch_lag: int = 4, det_score_thresh: float = 0.85,
                 device=None, **tracker_kw):
        self.device = resolve_device(device)
        self.joint = make_joint_step(cfg, model, link_head, track_k=track_k,
                                     det_score_thresh=det_score_thresh,
                                     device=self.device, **tracker_kw)
        self.max_tracks = max_tracks
        self.feat_dim = feat_dim
        self.fetch_lag = fetch_lag
        self.reset()

    def reset(self):
        self.state = init_state(self.max_tracks, self.feat_dim, self.device)
        self._pending = deque()

    def push(self, frame_id: int, pts, img, xy):
        """Submit one frame; returns the (frame_id, rows) of the frame
        `fetch_lag` steps back, or None while the pipeline fills.  A row is
        (tid, box (7,), score)."""
        self.state, packed = self.joint(self.state, frame_id, pts, img, xy)
        self._pending.append((frame_id, packed))
        if len(self._pending) > self.fetch_lag:
            return self._materialize(*self._pending.popleft())
        return None

    def flush(self):
        """The results of the frames still pending."""
        out = [self._materialize(fid, p) for fid, p in self._pending]
        self._pending.clear()
        return out

    @staticmethod
    def _materialize(frame_id, packed):
        return _rows(frame_id, packed.cpu().numpy())
