"""Online tracker with its whole state on the device, one step per frame
(counterpart of `jmodt_tpu/tracking/device_tracker.py`).

The state holds, in fixed track slots, the constant-velocity Kalman means
and covariances, appearance features, scores, miss / hit counters and track
ids (tid 0 is a free slot).  A step predicts, scores every (track,
detection) pair by link-head appearance + 3D IoU + centre distance,
assigns, updates the matched tracks, prunes the dead and births the
unmatched detections.

Assignment modes (`assign=`):

  * 'hungarian' (default): exact Jonker-Volgenant on the combined affinity.
  * 'mip': the start/end-aware association MIP, solved exactly as a
    max-weight matching on reduced weights with one "stay unmatched" dummy
    row per detection (the JAX module's docstring derives it).
  * 'greedy': best-first matching, cheaper, can differ on conflicts.

The Kalman state has its real 10 (state) and 7 (measurement) dimensions;
the JAX package pads them to 16 / 8 for the TPU's matrix unit, with exact
zeros, so the arithmetic is the same.  Kalman products run in float32
without TF32 (PyTorch's default for matmuls).

One step serves S independent streams in lockstep (the JAX package's vmap
of its single-stream step, written out as a leading S axis on the state
and every tensor); the single-stream step runs it with S = 1.

Host syncs: none on the card.  The Kalman predict loop (N3) and the
Jonker-Volgenant assignment (N2) are CUDA kernels (`csrc/tracker.cu`) that
run each stream's own loop on the device, as the JAX package's
`fori_loop` / `while_loop` do.  Their plain versions, which CPU tensors
take, read the predict steps to the host (the loop runs to the largest
count and masks each stream) and run the assignment stream after stream
on a host copy of the (S, T, D) affinity, with the kernels' float32
arithmetic.  `host_syncs` counts the reads made on CUDA tensors, so it
reads 0 a frame on the card.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from jmodt_torch.device import resolve_device, upload
from jmodt_torch.models.rcnn import masked_bidirectional_softmax
from jmodt_torch.ops import kernels
from jmodt_torch.ops.geometry import boxes_center_dist_affinity
from jmodt_torch.ops.rotated_iou import boxes_iou3d
from jmodt_torch.utils.graphs import Section
from jmodt_torch.utils.trace import span, spanned

_DIM_X = 10   # [x, y, z, h, w, l, ry, vx, vy, vz]
_DIM_Z = 7    # [x, y, z, h, w, l, ry]

# device-to-host reads made by the plain versions on CUDA tensors, counted
# like the kernels' launches
host_syncs = 0
LAP_MAX_SLOTS = 128     # N2 holds 4 track slots a lane


def _to_host(t: torch.Tensor) -> torch.Tensor:
    global host_syncs
    if t.is_cuda:
        host_syncs += 1
    return t.cpu()


class KalmanMats(NamedTuple):
    f: torch.Tensor    # (10, 10) transition
    h: torch.Tensor    # (7, 10) measurement
    q: torch.Tensor    # (10, 10) process noise
    r: torch.Tensor    # (7, 7) measurement noise
    p0: torch.Tensor   # (10, 10) initial covariance


def _make_mats(device) -> KalmanMats:
    f = torch.eye(_DIM_X)
    f[0, 7] = f[1, 8] = f[2, 9] = 1.0
    q = torch.eye(_DIM_X)
    q[7:, 7:] *= 0.01
    p0 = torch.eye(_DIM_X) * 10.0
    p0[7:, 7:] *= 1000.0
    mats = KalmanMats(f=f, h=torch.eye(_DIM_Z, _DIM_X), q=q,
                      r=torch.eye(_DIM_Z), p0=p0)
    return KalmanMats(*(m.to(device) for m in mats))


class TrackerState(NamedTuple):
    """Fixed-slot track store of T slots; tid == 0 marks a free slot."""
    mean: torch.Tensor            # (T, 10) float32
    cov: torch.Tensor             # (T, 10, 10)
    feat: torch.Tensor            # (T, C)
    score: torch.Tensor           # (T,)
    misses: torch.Tensor          # (T,) int32
    hits: torch.Tensor            # (T,) int32
    tid: torch.Tensor             # (T,) int32
    det_idx: torch.Tensor         # (T,) int32, det matched this frame or -1
    next_id: torch.Tensor         # () int32
    frame_count: torch.Tensor     # () int32
    last_frame_idx: torch.Tensor  # () int32
    mats: KalmanMats


def init_state(max_tracks: int, feat_dim: int, device=None) -> TrackerState:
    """An empty store on `device` (default: the CUDA card; raises without
    one)."""
    dev = resolve_device(device)
    t = max_tracks
    mats = _make_mats(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return TrackerState(
        mean=torch.zeros((t, _DIM_X), device=dev),
        cov=mats.p0.expand(t, _DIM_X, _DIM_X).clone(),
        feat=torch.zeros((t, feat_dim), device=dev),
        score=torch.zeros((t,), device=dev),
        misses=torch.zeros((t,), **i32), hits=torch.zeros((t,), **i32),
        tid=torch.zeros((t,), **i32),
        det_idx=torch.full((t,), -1, **i32),
        next_id=torch.tensor(1, **i32),
        frame_count=torch.tensor(0, **i32),
        last_frame_idx=torch.tensor(0, **i32),
        mats=mats)


def _wrap(theta: torch.Tensor) -> torch.Tensor:
    """Into [-pi, pi)."""
    theta = torch.where(theta >= math.pi, theta - 2 * math.pi, theta)
    return torch.where(theta < -math.pi, theta + 2 * math.pi, theta)


def _set_col(x: torch.Tensor, col: int, val: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[..., col] = val
    return x


@spanned('jmodt.kernel.kalman_predict')
def _kalman_predict(mean, cov, steps: torch.Tensor, mats: KalmanMats):
    """Advance the slots of each stream max(`steps`, 1) constant-velocity
    steps.  mean (..., T, 10), cov (..., T, 10, 10), steps an int tensor
    with the leading dims of `mean` (one count a stream).  On the card N3
    runs each stream's own count; on the CPU the plain version."""
    if kernels.on_card(mean):
        mean, cov = _kalman_predict_kernel(mean, cov, steps, mats)
    else:
        mean, cov = _kalman_predict_plain(mean, cov, steps, mats)
    return _set_col(mean, 6, _wrap(mean[..., 6])), cov


def _kalman_predict_plain(mean, cov, steps, mats: KalmanMats):
    """N3's plain version, before the angle wrap.  The counts are read to
    the host once: the loop runs to the largest count and each stream
    keeps the state of its own count."""
    steps = torch.clamp(steps, min=1)
    host = _to_host(steps)
    lo, hi = int(host.min()), int(host.max())
    for i in range(hi):
        m = mean @ mats.f.T
        c = torch.matmul(torch.matmul(mats.f, cov), mats.f.T) + mats.q
        if i < lo:
            mean, cov = m, c
        else:
            go = (steps > i)[..., None, None]
            mean, cov = torch.where(go, m, mean), torch.where(go[..., None],
                                                              c, cov)
    return mean, cov


def _kalman_predict_kernel(mean, cov, steps, mats: KalmanMats):
    """N3 (`jmodt_kalman_predict`): the plain version's sums, bit for bit,
    with the step counts read on the device.  F must be `_make_mats`'s."""
    t = mean.shape[-2]
    s = mean[..., 0, 0].numel()
    mean, cov = mean.contiguous(), cov.contiguous()
    kernels.check_cuda('kalman mean', mean, torch.float32, (*mean.shape[:-2],
                                                            t, _DIM_X))
    kernels.check_cuda('kalman cov', cov, torch.float32,
                       (*mean.shape[:-2], t, _DIM_X, _DIM_X))
    steps = steps.to(torch.int32).expand(mean.shape[:-2]).contiguous()
    q = mats.q.contiguous()
    mean_out, cov_out = torch.empty_like(mean), torch.empty_like(cov)
    kernels.launch('kalman_predict', mean.data_ptr(), cov.data_ptr(),
                   steps.data_ptr(), q.data_ptr(), s, t, mean_out.data_ptr(),
                   cov_out.data_ptr(), device=mean.device)
    return mean_out, cov_out


def _kalman_update(mean, cov, z7, apply_mask, mats: KalmanMats):
    """Measurement update with the orientation corrections (wrap, flip by
    pi when the angles differ by more than pi / 2, and the 2 pi case),
    applied where `apply_mask`.  z7: (..., T, 7) measurements."""
    x6 = _wrap(mean[..., 6])
    z6 = _wrap(z7[..., 6])
    diff = (z6 - x6).abs()
    flip = (diff > math.pi / 2) & (diff < math.pi * 3 / 2)
    x6 = torch.where(flip, _wrap(x6 + math.pi), x6)
    big = (z6 - x6).abs() >= math.pi * 3 / 2
    x6 = x6 + torch.where(big, torch.where(z6 > 0, 2 * math.pi,
                                           -2 * math.pi), 0.0)
    mean = _set_col(mean, 6, x6)
    z = _set_col(z7, 6, z6)

    y = z - mean @ mats.h.T                                   # (T, 7)
    s = torch.matmul(torch.matmul(mats.h, cov), mats.h.T) + mats.r
    # inv_ex: the inverse of linalg.inv without its error check, which
    # would read a flag back from the device
    k = torch.matmul(torch.matmul(cov, mats.h.T),
                     torch.linalg.inv_ex(s).inverse)
    new_mean = mean + torch.matmul(k, y[..., None])[..., 0]
    new_cov = cov - torch.matmul(k, torch.matmul(mats.h, cov))
    new_mean = _set_col(new_mean, 6, _wrap(new_mean[..., 6]))
    m = apply_mask[..., None]
    return (torch.where(m, new_mean, mean),
            torch.where(m[..., None], new_cov, cov))


def _jonker_volgenant(aff: torch.Tensor, match_thresh: float):
    """`_lap_assign` of one (T, D) CPU matrix; CPU results."""
    t, d = aff.shape
    assert t >= d, 'lap assumes at least as many track slots as dets'
    # Finite stand-in for gated pairs, filtered at the end.  It must stay
    # small against float32 precision: once an augmenting path ends in a
    # gated column the dual update subtracts about `big` from scanned
    # columns, and float32's ulp at 1e9 (64) would exceed the whole
    # affinity range; at 1e4 the ulp is about 1e-3.
    big = 1e4
    inf = 1e30     # scan mask
    aff = torch.where(torch.isfinite(aff), aff, torch.full_like(aff, -big))
    cost = -aff.T                                       # (D, T), minimize
    v = torch.zeros(t)
    col2row = [-1] * t
    row2col = [-1] * d
    for r in range(d):
        scanned = torch.zeros(t, dtype=torch.bool)
        dvec = cost[r] - v
        pred = torch.full((t,), r)
        jfree = -1
        while jfree < 0:
            # argmin returns the first minimum
            j = int(torch.argmin(torch.where(scanned, inf, dvec)))
            scanned[j] = True
            i = col2row[j]
            if i < 0:
                jfree = j
                continue
            red = dvec[j] + (cost[i] - v) - (cost[i, j] - v[j])
            upd = ~scanned & (red < dvec)
            pred = torch.where(upd, i, pred)
            dvec = torch.where(upd, red, dvec)
        # dual update on the scanned columns but the free one
        scanned[jfree] = False
        v = torch.where(scanned, v + dvec - dvec[jfree], v)
        # augment along the predecessors back to row r
        j = jfree
        while True:
            i = int(pred[j])
            col2row[j] = i
            j, row2col[i] = row2col[i], j
            if i == r:
                break
    t2d = torch.tensor(col2row, dtype=torch.int32)
    d2t = torch.tensor(row2col, dtype=torch.int32)
    # drop pairs at or below the threshold
    keep_t = (t2d >= 0) & (aff[torch.arange(t), t2d.clamp(min=0).long()]
                           > match_thresh)
    keep_d = (d2t >= 0) & (aff[d2t.clamp(min=0).long(), torch.arange(d)]
                           > match_thresh)
    return torch.where(keep_t, t2d, -1), torch.where(keep_d, d2t, -1)


@spanned('jmodt.kernel.lap')
def _lap_assign(affinity: torch.Tensor, match_thresh: float):
    """Exact max-weight bipartite matching, Jonker-Volgenant shortest
    augmenting paths, one augmentation per detection.

    affinity (..., T, D) with -inf for invalid pairs, T >= D; leading dims
    are independent streams.  Returns (track -> det (..., T) int32, -1
    unmatched; det -> track (..., D) int32).  On the card N2 runs a warp a
    stream; on the CPU the plain version.
    """
    if kernels.on_card(affinity):
        return _lap_assign_kernel(affinity, match_thresh)
    return _lap_assign_plain(affinity, match_thresh)


def _lap_assign_kernel(affinity: torch.Tensor, match_thresh: float):
    """N2 (`jmodt_lap`): the plain version's float32 steps, on the device."""
    t, d = affinity.shape[-2:]
    if t < d or t > LAP_MAX_SLOTS:
        raise ValueError(f'lap: {t} track slots for {d} dets; N2 takes '
                         f'{LAP_MAX_SLOTS} >= T >= D')
    lead = affinity.shape[:-2]
    aff = affinity.float().contiguous()
    s = aff[..., 0, 0].numel()
    t2d = torch.empty((*lead, t), dtype=torch.int32, device=aff.device)
    d2t = torch.empty((*lead, d), dtype=torch.int32, device=aff.device)
    kernels.launch('lap', aff.data_ptr(), s, t, d, match_thresh,
                   t2d.data_ptr(), d2t.data_ptr(), device=aff.device)
    return t2d, d2t


def _lap_assign_plain(affinity: torch.Tensor, match_thresh: float):
    """N2's plain version: the loops run, stream after stream, on one host
    copy of the whole tensor (one read for a CUDA tensor); the results go
    back to the tensor's device."""
    t, d = affinity.shape[-2:]
    aff = _to_host(affinity).reshape(-1, t, d)
    t2d, d2t = zip(*(_jonker_volgenant(a, match_thresh) for a in aff))
    lead = affinity.shape[:-2]
    dev = affinity.device
    return (torch.stack(t2d).reshape(*lead, t).to(dev),
            torch.stack(d2t).reshape(*lead, d).to(dev))


def mip_assign(combined, pred_score, det_score, start, end, active,
               det_mask, w_cls: float, w_se: float):
    """Exact solve of the start/end association MIP through its
    outside-option decomposition: a max-weight matching on the reduced
    weights w_jk = cls_j + cls_k + link_jk - out_j - out_k, with a personal
    zero-value dummy row per detection ("stay unmatched").

    combined: (..., T, D) w_app*link + w_iou*iou + w_dis*dist; pred_score
    (..., T), det_score (..., D), start (..., D), end (..., T) sigmoid
    scores; active (..., T) / det_mask (..., D) validity; leading dims are
    streams.  Returns (t2d (..., T), d2t (..., D) int32 with -1 unmatched,
    live_new (..., D) bool: an unmatched det that starts a live track;
    False means tentative).
    """
    t, d = combined.shape[-2:]
    cls_t = w_cls * (pred_score - 1.0)
    cls_d = w_cls * (det_score - 1.0)
    out_t = torch.clamp(cls_t + w_se * end, min=0.0)            # (T,)
    out_d = torch.clamp(cls_d + w_se * start, min=0.0)          # (D,)
    w = (combined + cls_t[..., :, None] + cls_d[..., None, :]
         - out_t[..., :, None] - out_d[..., None, :])
    neg_inf = torch.full_like(w, -math.inf)
    w = torch.where(active[..., :, None] & det_mask[..., None, :], w, neg_inf)
    eye = torch.eye(d, dtype=torch.bool, device=w.device)
    dummy = torch.where(eye & det_mask[..., None, :], 0.0, -math.inf)
    # threshold 0: the optimum holds no w < 0 pair (the dummy dominates);
    # dummy matches sit at exactly 0 and are filtered to "unmatched"
    t2d_aug, d2t_aug = _lap_assign(torch.cat([w, dummy], dim=-2), 0.0)
    t2d = t2d_aug[..., :t]
    d2t = torch.where(d2t_aug < t, d2t_aug, -1)
    live_new = det_mask & (d2t < 0) & (cls_d + w_se * start > 0)
    return t2d, d2t, live_new


def _greedy_assign(affinity: torch.Tensor, match_thresh: float):
    """Best-first matching on a gated affinity (..., T, D) with -inf for
    invalid pairs, leading dims independent streams; returns (track -> det
    (..., T), det -> track (..., D)) int32, -1 unmatched.  min(T, D) rounds
    of tensor ops, no host read."""
    t, d = affinity.shape[-2:]
    lead = affinity.shape[:-2]
    dev = affinity.device
    rows = torch.arange(t, device=dev)
    cols = torch.arange(d, device=dev)
    aff = affinity.clone()
    t2d = torch.full((*lead, t), -1, dtype=torch.int32, device=dev)
    d2t = torch.full((*lead, d), -1, dtype=torch.int32, device=dev)
    for _ in range(min(t, d)):
        flat = aff.flatten(-2)
        best = torch.argmax(flat, dim=-1, keepdim=True)   # the first maximum
        ok = flat.gather(-1, best) > match_thresh           # (..., 1)
        ti, di = best // d, best % d
        t2d = torch.where(ok & (rows == ti), di.to(torch.int32), t2d)
        d2t = torch.where(ok & (cols == di), ti.to(torch.int32), d2t)
        hit = ok[..., None] & ((rows[:, None] == ti[..., None])
                               | (cols == di[..., None]))
        aff = torch.where(hit, -math.inf, aff)
    return t2d, d2t


def _scatter_drop(dest: torch.Tensor, dst: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """dest (S, T, ...) with rows dst[s, i] < T set to src[s, i]; rows with
    dst[s, i] == T are dropped (they land in a spill row of their stream
    that is cut off)."""
    ext = torch.cat([dest, dest[:, :1]], dim=1)
    streams = torch.arange(dest.shape[0], device=dest.device)[:, None]
    ext[streams, dst.long()] = src.to(dest.dtype)
    return ext[:, :-1]


def init_batched_state(n_seqs: int, max_tracks: int, feat_dim: int,
                       device=None, devices=None):
    """`n_seqs` empty stores with a leading stream axis on every field but
    the Kalman matrices, which the streams share, on `device` (default:
    the CUDA card; raises without one).  With `devices`, the streams split
    contiguously over them as `make_batched_joint_step(devices=)` splits
    them: a tuple of each part's `n_seqs / len(devices)` stores."""
    if devices is not None:
        if n_seqs % len(devices):
            raise ValueError(f'{n_seqs} streams do not split over '
                             f'{len(devices)} devices')
        return tuple(init_batched_state(n_seqs // len(devices), max_tracks,
                                        feat_dim, d) for d in devices)
    state = init_state(max_tracks, feat_dim, device)
    return state._replace(**{
        k: v.expand(n_seqs, *v.shape).clone()
        for k, v in state._asdict().items() if k != 'mats'})


def make_batched_tracker_step(link_head: nn.Module, t_miss: int = 2,
                              t_hit: int = 0, w_app: float = 2.0,
                              w_iou: float = 10.0, w_dis: float = 10.0,
                              score_thresh: float = 0.0,
                              match_thresh: float = 0.0,
                              assign: str = 'hungarian',
                              se_head: Optional[nn.Module] = None,
                              w_cls: float = 100.0, w_se: float = 1.0,
                              device=None):
    """The per-frame step of S independent streams in lockstep on `device`
    (default: the CUDA card; raises without one), to which the heads are
    moved.  Streams of different lengths pad with empty frames (det_mask
    all False), which leave a stream's tracks as they were.

    step(states, frame_ids (S,), det_boxes (S, D, 7), det_scores (S, D),
    det_feats (S, D, C), det_mask (S, D)) -> (states, outputs), states from
    `init_batched_state` and every output with a leading S axis.  On the
    card a frame reads nothing back to the host; on the CPU the plain
    versions read twice ('greedy': once): the (S,) predict steps and, for
    'hungarian' and 'mip', the (S, T, D) affinity.
    """
    assert assign in ('mip', 'hungarian', 'greedy'), assign
    if assign == 'mip':
        assert se_head is not None, "assign='mip' needs the se head"
    dev = resolve_device(device)
    link_head.to(dev).eval()
    if se_head is not None:
        se_head.to(dev).eval()
    assign_fn = _lap_assign if assign == 'hungarian' else _greedy_assign

    @spanned('jmodt.tracker')
    @torch.no_grad()
    def step(state: TrackerState, frame_id, det_boxes, det_scores,
             det_feats, det_mask):
        frame_id = upload(frame_id, dev, torch.int32)
        det_boxes, det_scores, det_feats = (
            upload(x, dev, torch.float32)
            for x in (det_boxes, det_scores, det_feats))
        det_mask = upload(det_mask, dev, torch.bool)
        return section(state, frame_id, det_boxes, det_scores, det_feats,
                       det_mask)

    def body(state: TrackerState, frame_id, det_boxes, det_scores,
             det_feats, det_mask):
        """The step after its uploads: a CUDA graph section
        (`utils/graphs.py`), replayed on the card."""
        n_seq, tcap = state.tid.shape
        ndet = det_boxes.shape[1]

        with span('jmodt.tracker.predict'):        # misses += passed
            active = state.tid > 0                                # (S, T)
            any_det = det_mask.any(-1)                            # (S,)
            passed = torch.where(any_det, frame_id - state.last_frame_idx,
                                 0)
            frame_count = state.frame_count + passed
            last_frame_idx = torch.where(any_det, frame_id,
                                         state.last_frame_idx)
            do_predict = any_det & active.any(-1)
            pm, pc = _kalman_predict(state.mean, state.cov,
                                     torch.where(do_predict, passed, 1),
                                     state.mats)
            upd = do_predict[:, None] & active
            mean = torch.where(upd[..., None], pm, state.mean)
            cov = torch.where(upd[..., None, None], pc, state.cov)
            misses = torch.where(any_det[:, None] & active,
                                 state.misses + passed[:, None],
                                 state.misses)

        with span('jmodt.tracker.affinity'):
            pred_boxes = mean[..., :7]
            cor = (state.feat[:, :, None, :]
                   - det_feats[:, None, :, :]).abs()
            link_raw = link_head(cor)[..., 0]                     # (S, T, D)
            link = masked_bidirectional_softmax(link_raw, active, det_mask)
            iou = boxes_iou3d(pred_boxes, det_boxes)
            dis = boxes_center_dist_affinity(pred_boxes, det_boxes)
            pair_ok = active[..., :, None] & det_mask[..., None, :]
            combined = torch.where(pair_ok, link * w_app + iou * w_iou
                                   + dis * w_dis, -math.inf)

        with span('jmodt.tracker.assign'):
            had_active = active.any(-1, keepdim=True)             # (S, 1)
            if assign == 'mip':
                # start / end features: masked means of cor over tracks /
                # dets
                pw = active.to(cor.dtype)
                dw = det_mask.to(cor.dtype)
                start_feat = ((cor * pw[..., None, None]).sum(1)
                              / torch.clamp(pw.sum(-1), min=1.0)[:, None,
                                                                 None])
                end_feat = ((cor * dw[:, None, :, None]).sum(2)
                            / torch.clamp(dw.sum(-1), min=1.0)[:, None,
                                                               None])
                start = torch.sigmoid(se_head(start_feat)[..., 0])  # (S, D)
                end = torch.sigmoid(se_head(end_feat)[..., 0])      # (S, T)
                t2d, d2t, live_new = mip_assign(
                    combined, state.score, det_scores, start, end, active,
                    det_mask, w_cls, w_se)
                # with no live track every det is born live
                tentative_new = had_active & ~live_new
            else:
                t2d, d2t = assign_fn(combined, match_thresh)
                tentative_new = had_active & (det_scores <= score_thresh)

        with span('jmodt.tracker.update'):         # the matched tracks
            matched_t = t2d >= 0
            safe_t2d = torch.where(matched_t, t2d, 0)
            sel = safe_t2d.long()

            def take(x):   # x (S, D, ...) -> its row sel[s, t] per slot
                return torch.gather(x, 1, sel.reshape(*sel.shape, *[1] * (
                    x.dim() - 2)).expand(-1, -1, *x.shape[2:]))

            mean, cov = _kalman_update(mean, cov, take(det_boxes), matched_t,
                                       state.mats)
            feat = torch.where(matched_t[..., None], take(det_feats),
                               state.feat)
            score = torch.where(matched_t, take(det_scores), state.score)
            misses = torch.where(matched_t, 0, misses)
            hits = torch.where(matched_t, state.hits + 1, state.hits)
            det_idx = torch.where(matched_t, safe_t2d, -1)

        with span('jmodt.tracker.births'):
            # prune the dead before births, to free their slots
            tid = torch.where(active & (misses >= t_miss), 0, state.tid)

            # births: unmatched dets, live ones first (in det order), then
            # tentative ones (misses 1), into the free slots in order
            i32 = torch.int32
            is_new = det_mask & (d2t < 0)
            live_b = is_new & ~tentative_new
            tent_b = is_new & tentative_new
            rank_live = torch.cumsum(live_b.to(i32), -1, dtype=i32) - 1
            rank_tent = (live_b.sum(-1, keepdim=True, dtype=i32)
                         + torch.cumsum(tent_b.to(i32), -1, dtype=i32) - 1)
            new_rank = torch.where(live_b, rank_live, rank_tent)  # (S, D)
            free = tid == 0
            free_rank = torch.cumsum(free.to(i32), -1, dtype=i32) - 1
            # slot_of_rank[s, r] = the r-th free slot of stream s
            slot_of_rank = _scatter_drop(
                torch.full((n_seq, tcap), tcap, dtype=i32, device=dev),
                torch.where(free, free_rank, tcap),
                torch.arange(tcap, dtype=i32, device=dev).expand(n_seq, -1))
            born = is_new & (new_rank < free.sum(-1, keepdim=True,
                                                 dtype=i32))
            dst = torch.where(born, torch.gather(
                slot_of_rank, 1, new_rank.clamp(0, tcap - 1).long()), tcap)

            init_mean = torch.zeros((n_seq, ndet, _DIM_X), device=dev)
            init_mean[..., :7] = det_boxes
            mean = _scatter_drop(mean, dst, init_mean)
            cov = _scatter_drop(cov, dst, state.mats.p0.expand(
                n_seq, ndet, _DIM_X, _DIM_X))
            feat = _scatter_drop(feat, dst, det_feats)
            score = _scatter_drop(score, dst, det_scores)
            misses = _scatter_drop(misses, dst, tentative_new.to(i32).expand(
                n_seq, ndet))
            hits = _scatter_drop(hits, dst, torch.zeros(
                (n_seq, ndet), dtype=i32, device=dev))
            det_idx = _scatter_drop(det_idx, dst, torch.arange(
                ndet, dtype=i32, device=dev).expand(n_seq, -1))
            tid = _scatter_drop(tid, dst, state.next_id[:, None] + new_rank)
            next_id = state.next_id + born.sum(-1, dtype=i32)

        with span('jmodt.tracker.emit'):
            emit = ((tid > 0) & (misses == 0) & any_det[:, None]
                    & ((hits >= t_hit) | (frame_count <= t_hit)[:, None]))
            new_state = TrackerState(
                mean=mean, cov=cov, feat=feat, score=score, misses=misses,
                hits=hits, tid=tid, det_idx=det_idx, next_id=next_id,
                frame_count=frame_count, last_frame_idx=last_frame_idx,
                mats=state.mats)
            output = {'tid': tid, 'box': mean[..., :7], 'score': score,
                      'det_idx': det_idx, 'emit': emit}
        return new_state, output

    section = Section('tracker', body, [link_head, se_head])
    return step


def make_device_tracker_step(link_head: nn.Module, device=None, **kw):
    """The per-frame step of one stream on `device` (default: the CUDA
    card; raises without one), to which the heads are moved; `kw` as for
    `make_batched_tracker_step`, whose step it runs with S = 1.

    `link_head` maps (..., C) correlation features |feat_t - feat_d| to
    (..., 1) scores; `se_head` (needed by assign='mip') scores start / end
    features the same way.

    step(state, frame_id, det_boxes (D, 7), det_scores (D,), det_feats
    (D, C), det_mask (D,)) -> (state, output), output a dict of 'tid' (T,),
    'box' (T, 7), 'score' (T,), 'det_idx' (T,) and 'emit' (T,) bool.
    """
    dev = resolve_device(device)
    # the batched step's body, without its span: this step opens its own
    batched = make_batched_tracker_step(link_head, device=dev,
                                        **kw).__wrapped__

    @spanned('jmodt.tracker')
    def step(state: TrackerState, frame_id, det_boxes, det_scores,
             det_feats, det_mask):
        one = [upload(x, dev)[None] for x in (
            frame_id, det_boxes, det_scores, det_feats, det_mask)]
        states = state._replace(**{k: v[None] for k, v in
                                   state._asdict().items() if k != 'mats'})
        states, out = batched(states, *one)
        state = states._replace(**{k: v[0] for k, v in
                                   states._asdict().items() if k != 'mats'})
        return state, {k: v[0] for k, v in out.items()}

    return step


class DeviceTracker:
    """The step behind the host tracker's update() signature, with the
    state on the device: detections are padded to `max_dets`."""

    def __init__(self, link_head: nn.Module, feat_dim: int,
                 max_tracks: int = 64, max_dets: int = 32, device=None,
                 **kw):
        """For assign='mip' pass `se_head=...` in kw."""
        self.device = resolve_device(device)
        self.step = make_device_tracker_step(link_head, device=self.device,
                                             **kw)
        self.max_tracks = max_tracks
        self.max_dets = max_dets
        self.feat_dim = feat_dim
        self.reset()

    def reset(self):
        self.state = init_state(self.max_tracks, self.feat_dim, self.device)

    def update(self, frame_id: int, boxes, scores, feats
               ) -> Dict[str, torch.Tensor]:
        """The raw per-frame output dict of device tensors."""
        d = self.max_dets
        db = np.zeros((d, 7), np.float32)
        ds = np.zeros((d,), np.float32)
        df = np.zeros((d, self.feat_dim), np.float32)
        dm = np.zeros((d,), bool)
        n = min(len(scores), d)
        db[:n], ds[:n], df[:n], dm[:n] = (boxes[:n], scores[:n], feats[:n],
                                          True)
        self.state, out = self.step(self.state, frame_id, db, ds, df, dm)
        return out
