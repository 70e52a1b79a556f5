"""Smoke run of the PyTorch port (jmodt_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build    compile the hand-written kernels from jmodt_torch/csrc.
2. kernels  one frame of the detection step records the inputs each kernel
            wrapper gets on the main path; every kernel (K1 FPS, K2 batched
            FPS, K3 three-NN, K4 grouped gather-MLP-max) is then run on those
            inputs and held against its plain PyTorch version: FPS and 3-NN
            indices equal, 3-NN distances within 1e-5 relative, K4 within
            1e-4 of the output's scale.  Times come from CUDA events.
3. step     the detection step at the default Config() (bfloat16 network,
            16384 points, 384x1280 uint8 image, random weights from seed 0)
            runs 3 frames with the launch counts set to 0 just before; each
            kernel must have launched its per-frame count on every frame,
            outputs must be finite and roi_mask / keep non-empty.
4. parity   one frame with DTYPE=float32 and the same weights on the card
            and on the CPU: rpn_cls, rpn_reg, backbone_features, rois, boxes,
            scores and feats within 1e-3 of their scale; roi_mask and keep
            equal.  TF32 is switched off for matmuls and convolutions.
5. K5       one frame of the joint step with RPN.MEGA_SA records the inputs
            of the whole-SA-level kernel (K5) at RPN levels 1-3; each call
            is held against its plain version (indices and centres equal,
            pooled features within 1e-4 of their scale) and timed beside
            the default path's K1 + ball query + K4 for the same level.
6. joint    the joint detect + track step (the main path: Config() with
            RPN.MEGA_SA, bfloat16, detector weights from seed 0, a link
            head from seed 1, 64 track slots, top 16 detections, score
            threshold 0.2, Hungarian assignment) runs 4 frames with the
            launch counts set to 0 just before; each kernel must launch its
            per-frame count on every frame, packed rows must be finite and
            some emitted.  Then one frame fed three times to a new state:
            every track id emitted on the first pass comes back on the next
            two.
7. parity   3 frames of the joint step in float32 on the card and on the
            CPU with the same weights: tid and emit equal, boxes and scores
            within 1e-3 of their scale.

Prints a {"kernels": [...]} line (launches from phase 6), the card's name
and power limit, and as its last line {"ok": true, "device": {...}}.  Needs
one card; without one it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# per-frame launches of each kernel on the detection step (phase 3) and on
# the joint step with RPN.MEGA_SA (phase 6, the main path)
PER_FRAME = {'fps': 4, 'fps_batched': 2, 'three_nn': 4,
             'grouped_gather_mlp_max': 8}
PER_FRAME_JOINT = {'fps': 1, 'fps_batched': 2, 'three_nn': 4,
                   'grouped_gather_mlp_max': 2, 'sa_level': 3}
KERNELS = [
    dict(name='fps', counter='fps', source='jmodt_torch/csrc/fps.cu',
         replaces='jmodt_tpu/ops/pallas/fps.py:63'),
    dict(name='fps_batched', counter='fps_batched',
         source='jmodt_torch/csrc/fps.cu',
         replaces='jmodt_tpu/ops/pallas/fps.py:134'),
    dict(name='three_nn', counter='three_nn',
         source='jmodt_torch/csrc/three_nn.cu',
         replaces='jmodt_tpu/ops/pallas/three_nn.py:52'),
    dict(name='grouped_gather_mlp_max', counter='grouped_gather_mlp_max',
         source='jmodt_torch/csrc/grouped_gather_mlp.cu',
         replaces='jmodt_tpu/ops/pallas/grouped_gather_mlp.py:90'),
    dict(name='sa_level', counter='sa_level',
         source='jmodt_torch/csrc/sa_level.cu',
         replaces='jmodt_tpu/ops/pallas/sa_level.py:364'),
]
NET_TOL = 1e-3
K4_TOL = 1e-4
K5_TOL = 1e-4
JOINT = dict(max_tracks=64, track_k=16, det_score_thresh=0.2,
             assign='hungarian')


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


# ----------------------------------------------------------------- phase 2

def record_kernel_inputs(step, frame):
    """Run one frame, recording the arguments of every kernel wrapper call
    in main-path order: {kernel name: [args, ...]}."""
    import jmodt_torch.models.pointnet2 as pointnet2
    import jmodt_torch.ops.fused_sa as fused_sa
    calls = {k['name']: [] for k in KERNELS if k['name'] != 'sa_level'}
    originals = (pointnet2.farthest_point_sample, pointnet2.three_nn,
                 fused_sa.grouped_gather_mlp_max)

    def fps(xyz, npoint):
        calls['fps' if xyz.shape[0] == 1 else 'fps_batched'].append(
            (xyz, npoint))
        return originals[0](xyz, npoint)

    def three_nn(unknown, known):
        calls['three_nn'].append((unknown, known))
        return originals[1](unknown, known)

    def ggmm(feats1, idx, cxw, b1, layers):
        calls['grouped_gather_mlp_max'].append((feats1, idx, cxw, b1,
                                                tuple(layers)))
        return originals[2](feats1, idx, cxw, b1, layers)

    pointnet2.farthest_point_sample, pointnet2.three_nn = fps, three_nn
    fused_sa.grouped_gather_mlp_max = ggmm
    try:
        step(frame['pts_input'], frame['img'], frame['pts_xy'])
        torch.cuda.synchronize()
    finally:
        (pointnet2.farthest_point_sample, pointnet2.three_nn,
         fused_sa.grouped_gather_mlp_max) = originals
    return calls


def check_kernels(calls):
    """Each recorded call: kernel vs plain version, times and bound.
    Returns {kernel name: aggregate over one frame's calls}."""
    from jmodt_torch.ops import fused_sa, interpolate, sampling
    agg = {}
    for name, args_list in calls.items():
        check(len(args_list) == PER_FRAME[name],
              f'{name}: {len(args_list)} calls a frame, expected '
              f'{PER_FRAME[name]}')
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   t_ops=0.0, t_bytes=0.0, max_abs_err=0.0)
        for args in args_list:
            if name in ('fps', 'fps_batched'):
                xyz, npoint = args
                b, n, _ = xyz.shape
                got = sampling.farthest_point_sample(xyz, npoint)
                want = sampling.farthest_point_sample_plain(xyz, npoint)
                check(torch.equal(got, want),
                      f'{name} {b}x{n}->{npoint}: indices differ')
                err, lib = 0.0, None
                ms = cuda_ms(lambda: sampling.farthest_point_sample(
                    xyz, npoint), 10)
                plain = cuda_ms(lambda: sampling.farthest_point_sample_plain(
                    xyz, npoint), 2)
                flops = 9.0 * b * n * (npoint - 1)
                nbytes = b * (12.0 * n + 4.0 * npoint)
                shape = f'B={b} {n}->{npoint}'
            elif name == 'three_nn':
                u, k = args
                b, n, m = u.shape[0], u.shape[1], k.shape[1]
                d, i = interpolate.three_nn(u, k)
                dp, ip = interpolate.three_nn_plain(u, k)
                check(torch.equal(i, ip), f'three_nn {n}x{m}: indices differ')
                rel = float(((d - dp).abs() / dp.abs().clamp_min(1e-30))
                            .max())
                check(rel <= 1e-5, f'three_nn {n}x{m}: distance rel err {rel}')
                err = float((d - dp).abs().max())
                ms = cuda_ms(lambda: interpolate.three_nn(u, k), 20)
                plain = cuda_ms(lambda: interpolate.three_nn_plain(u, k), 3)
                lib = cuda_ms(lambda: torch.topk(torch.cdist(u, k), 3,
                                                 largest=False), 5)
                flops = 8.0 * b * n * m
                nbytes = 12.0 * b * (n + m) + 24.0 * b * n
                shape = f'B={b} {n}x{m}'
            else:
                feats1, idx, cxw, b1, layers = args
                b, n, c1 = feats1.shape
                m, s = idx.shape[1], idx.shape[2]
                got = fused_sa.grouped_gather_mlp_max(feats1, idx, cxw, b1,
                                                      layers)
                want = fused_sa.grouped_gather_mlp_max_plain(
                    feats1, idx, cxw, b1, layers)
                rel = scale_err(got, want)
                check(rel <= K4_TOL, f'K4 B={b} M={m} S={s}: err {rel}')
                err = float((got - want).abs().max())
                ms = cuda_ms(lambda: fused_sa.grouped_gather_mlp_max(
                    feats1, idx, cxw, b1, layers), 10)
                plain = cuda_ms(lambda: fused_sa.grouped_gather_mlp_max_plain(
                    feats1, idx, cxw, b1, layers), 3)
                lib = None
                rows = b * m * s
                widths = [c1] + [w.shape[1] for w, _ in layers]
                flops = rows * (3.0 * c1 + sum(
                    2.0 * ci * co + 2.0 * co
                    for ci, co in zip(widths[:-1], widths[1:])))
                nbytes = 4.0 * (feats1.numel() + idx.numel() + cxw.numel()
                                + c1 + sum(w.numel() + bb.numel()
                                           for w, bb in layers)
                                + b * m * widths[-1])
                shape = (f'B={b} N={n} M={m} S={s} '
                         f'{"->".join(map(str, widths))}')
            bms, by = bound_ms(flops, nbytes)
            print(f'  {name:24s} {shape:38s} kernel {ms:9.4f} ms  plain '
                  f'{plain:9.4f} ms  library '
                  f'{"-" if lib is None else f"{lib:.4f} ms":>11s}  bound '
                  f'{bms:.4f} ms ({by})  max_abs_err {err:.3g}', flush=True)
            tot['ms'] += ms
            tot['plain_ms'] += plain
            tot['bound_ms'] += bms
            tot['t_ops'] += flops / PEAK_F32_FLOPS
            tot['t_bytes'] += nbytes / PEAK_BYTES
            tot['library_ms'] = (None if lib is None or tot['library_ms']
                                 is None else tot['library_ms'] + lib)
            tot['max_abs_err'] = max(tot['max_abs_err'], err)
        agg[name] = tot
    return agg


# ----------------------------------------------------------- phases 3, 4

def finite(out) -> bool:
    return all(bool(torch.isfinite(v.float()).all()) for v in out.values()
               if v.is_floating_point())


def run_step(step, frames):
    from jmodt_torch.ops import kernels
    kernels.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, per_frame = [], []
    for f in frames:
        outs.append(step(f['pts_input'], f['img'], f['pts_xy']))
        per_frame.append(dict(kernels.launches))    # running totals
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    counts = dict(kernels.launches)
    for i, seen in enumerate(per_frame):
        for name, per in PER_FRAME.items():
            check(seen.get(name, 0) == per * (i + 1),
                  f'step: {name} launched {seen.get(name, 0)} times in '
                  f'{i + 1} frames, expected {per * (i + 1)}')
    for i, out in enumerate(outs):
        check(finite(out), f'step frame {i}: non-finite output')
        check(bool(out['roi_mask'].any()), f'step frame {i}: no RoI')
        check(bool(out['keep'].any()), f'step frame {i}: no detection')
    return ms, counts, outs


def parity(cfg32, frame):
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.models.point_rcnn import build_detector
    # fp32 on the card means fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for dev in ('cuda', 'cpu'):
        model = build_detector(cfg32, device=dev, seed=0)
        step = make_detection_step(cfg32, model, device=dev)
        out = dict(step(frame['pts_input'], frame['img'], frame['pts_xy']))
        img = torch.as_tensor(frame['img'], device=dev).float() / 255.0
        img = (img - torch.tensor([0.485, 0.456, 0.406], device=dev)) \
            / torch.tensor([0.229, 0.224, 0.225], device=dev)
        fwd = model(torch.as_tensor(frame['pts_input'], device=dev), img,
                    torch.as_tensor(frame['pts_xy'], device=dev))
        for key in ('rpn_cls', 'rpn_reg', 'backbone_features'):
            out[key] = fwd[key]
        results[dev] = {k: v.cpu() for k, v in out.items()}
    gpu, cpu = results['cuda'], results['cpu']
    errs = {}
    for key in ('roi_mask', 'keep'):
        check(torch.equal(gpu[key], cpu[key]), f'parity: {key} differs')
    for key in ('rpn_cls', 'rpn_reg', 'backbone_features', 'rois', 'boxes',
                'scores', 'feats'):
        errs[key] = scale_err(gpu[key], cpu[key])
        check(errs[key] <= NET_TOL, f'parity: {key} err {errs[key]}')
    return errs


# ----------------------------------------------------------- phases 5-7

def mega_cfg(dtype: str):
    from jmodt_torch.config import Config
    cfg = Config()
    return dataclasses.replace(
        cfg, DTYPE=dtype, RPN=dataclasses.replace(cfg.RPN, MEGA_SA=True))


def build_joint(cfg, device=None):
    """The main path: detector weights from seed 0, link head from seed 1."""
    from jmodt_torch.models.point_rcnn import build_detector, init_weights
    from jmodt_torch.models.rcnn import CorrelationHead
    from jmodt_torch.pipeline import make_joint_step
    model = build_detector(cfg, device=device, seed=0)
    head = CorrelationHead(cfg.RCNN.SA_CONFIG.MLPS[-1][-1], cfg.REID.LINK_FC,
                           use_bn=cfg.REID.USE_BN)
    init_weights(head, 1)
    kw = {k: v for k, v in JOINT.items() if k != 'max_tracks'}
    return make_joint_step(cfg, model, head, device=device, **kw)


def new_state(cfg, device=None):
    from jmodt_torch.tracking.device_tracker import init_state
    return init_state(JOINT['max_tracks'], cfg.RCNN.SA_CONFIG.MLPS[-1][-1],
                      device=device)


def record_k5_inputs(joint, cfg, frame):
    """Run one joint frame, recording the arguments of every K5 wrapper
    call: [(xyz, feats, npoint, radii, nsamples, folded), ...]."""
    import jmodt_torch.models.pointnet2 as pointnet2
    calls = []
    original = pointnet2.sa_level_fused

    def spy(*args):
        calls.append(args)
        return original(*args)

    pointnet2.sa_level_fused = spy
    try:
        joint(new_state(cfg), 1, frame['pts_input'], frame['img'],
              frame['pts_xy'])
        torch.cuda.synchronize()
    finally:
        pointnet2.sa_level_fused = original
    return calls


def k5_work(args, new_xyz):
    """(float32 operations, bytes) one K5 call needs on these inputs.  The
    ball query counts, per centre, the points up to the last one the scan
    must see: the nsample-th hit of the slowest scale, or the whole cloud
    when a ball is not full."""
    from jmodt_torch.ops.grouping import pairwise_d2
    xyz, feats, npoint, radii, nsamples, folded = args
    b, n, _ = xyz.shape
    c = 0 if feats is None else feats.shape[-1]
    d2 = pairwise_d2(new_xyz, xyz)                           # (B, M, N)
    need = torch.zeros(b, npoint, device=xyz.device)
    for r, ns in zip(radii, nsamples):
        cum = torch.cumsum((d2 < r * r).int(), -1)
        full = cum[..., -1] >= ns
        last = torch.where(full, torch.argmax((cum >= ns).int(), -1), n - 1)
        need = torch.maximum(need, last.float() + 1)
    flops = 9.0 * b * n * (npoint - 1)                       # FPS
    flops += float(need.sum()) * (13 + len(radii))           # ball query
    nbytes = 12.0 * b * n + 4.0 * b * n * c + 16.0 * b * npoint
    for ns, layers in zip(nsamples, folded):
        widths = [3 + c] + [w.shape[1] for w, _ in layers]
        rows = b * npoint * ns
        flops += 2.0 * b * n * widths[0] * widths[1]         # table
        flops += 6.0 * b * npoint * widths[1]                # cxw
        flops += rows * (3.0 * widths[1] + sum(
            2.0 * ci * co + 2.0 * co
            for ci, co in zip(widths[1:-1], widths[2:])))
        nbytes += 4.0 * (sum(w.numel() + bb.numel() for w, bb in layers)
                         + b * npoint * widths[-1])
    return flops, nbytes


def default_level(xyz, feats, npoint, radii, nsamples, folded):
    """The same level on the default path: K1, ball query, and per scale
    the hoisted layer 1 and K4."""
    from jmodt_torch.ops import fused_sa, grouping, sampling
    idx = sampling.farthest_point_sample(xyz, npoint)
    new_xyz = sampling.gather_xyz(xyz, idx)
    nbrs = grouping.ball_query_multi(radii, nsamples, xyz, new_xyz)
    return torch.cat([fused_sa.fused_sa_eval(xyz, feats, new_xyz, nbr, lay)
                      for nbr, lay in zip(nbrs, folded)], dim=-1)


def check_k5(calls):
    """K5 vs its plain version at each recorded level; returns the
    aggregate over the frame's calls."""
    from jmodt_torch.ops import sa_level
    check(len(calls) == PER_FRAME_JOINT['sa_level'],
          f'sa_level: {len(calls)} calls a frame, expected '
          f'{PER_FRAME_JOINT["sa_level"]}')
    tot = dict(ms=0.0, plain_ms=0.0, default_ms=0.0, t_ops=0.0,
               t_bytes=0.0, max_abs_err=0.0, library_ms=None)
    for level, args in enumerate(calls, start=1):
        xyz, feats, npoint, radii, nsamples, folded = args
        got = sa_level.sa_level_fused(*args)
        want = sa_level.sa_level_fused_plain(*args)
        check(torch.equal(got[2], want[2]), f'K5 L{level}: indices differ')
        check(torch.equal(got[0], want[0]), f'K5 L{level}: centres differ')
        rel = scale_err(got[1], want[1])
        check(rel <= K5_TOL, f'K5 L{level}: pooled err {rel}')
        err = float((got[1] - want[1]).abs().max())
        ms = cuda_ms(lambda: sa_level.sa_level_fused(*args), 10)
        plain = cuda_ms(lambda: sa_level.sa_level_fused_plain(*args), 2)
        dflt = cuda_ms(lambda: default_level(*args), 5)
        flops, nbytes = k5_work(args, want[0])
        bms, by = bound_ms(flops, nbytes)
        c = 0 if feats is None else feats.shape[-1]
        print(f'  sa_level L{level} N={xyz.shape[1]} C={c} M={npoint} S='
              f'{"/".join(map(str, nsamples))}  kernel {ms:9.4f} ms  plain '
              f'{plain:9.4f} ms  default path (K1+ball query+K4) '
              f'{dflt:9.4f} ms  bound {bms:.4f} ms ({by})  max_abs_err '
              f'{err:.3g}', flush=True)
        tot['ms'] += ms
        tot['plain_ms'] += plain
        tot['default_ms'] += dflt
        tot['t_ops'] += flops / PEAK_F32_FLOPS
        tot['t_bytes'] += nbytes / PEAK_BYTES
        tot['max_abs_err'] = max(tot['max_abs_err'], err)
    return tot


def run_joint(joint, cfg, frames):
    """Phase 6: 4 frames with per-frame launch checks, then one frame fed
    three times to a new state."""
    from jmodt_torch.ops import kernels
    state = new_state(cfg)
    kernels.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packs, per_frame = [], []
    for i, f in enumerate(frames):
        state, packed = joint(state, i + 1, f['pts_input'], f['img'],
                              f['pts_xy'])
        packs.append(packed)
        per_frame.append(dict(kernels.launches))    # running totals
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    counts = dict(kernels.launches)
    for i, seen in enumerate(per_frame):
        for name, per in PER_FRAME_JOINT.items():
            check(seen.get(name, 0) == per * (i + 1),
                  f'joint: {name} launched {seen.get(name, 0)} times in '
                  f'{i + 1} frames, expected {per * (i + 1)}')
    emitted = 0
    for i, packed in enumerate(packs):
        check(bool(torch.isfinite(packed).all()),
              f'joint frame {i}: non-finite rows')
        emitted += int((packed[:, 9] > 0.5).sum())
    check(emitted > 0, 'joint: no row emitted in 4 frames')

    state, f = new_state(cfg), frames[0]
    ids = []
    for fid in (1, 2, 3):
        state, packed = joint(state, fid, f['pts_input'], f['img'],
                              f['pts_xy'])
        ids.append(set(packed[packed[:, 9] > 0.5, 0].int().tolist()))
    check(len(ids[0]) > 0, 'joint: the repeated frame emitted nothing')
    check(ids[0] <= ids[1] and ids[0] <= ids[2],
          f'joint: ids {sorted(ids[0])} of the first pass not kept: '
          f'{sorted(ids[1])}, {sorted(ids[2])}')
    return ms, counts, emitted / len(frames), len(ids[0])


def joint_parity(frames):
    """Phase 7: float32 joint step on the card and on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = mega_cfg('float32')
    rows = {}
    for dev in ('cuda', 'cpu'):
        joint = build_joint(cfg32, device=dev)
        state = new_state(cfg32, device=dev)
        rows[dev] = []
        for i, f in enumerate(frames):
            state, packed = joint(state, i + 1, f['pts_input'], f['img'],
                                  f['pts_xy'])
            rows[dev].append(packed.cpu())
    errs = []
    for i, (g, c) in enumerate(zip(rows['cuda'], rows['cpu'])):
        check(torch.equal(g[:, 0], c[:, 0]), f'joint parity frame {i}: tid')
        check(torch.equal(g[:, 9], c[:, 9]), f'joint parity frame {i}: emit')
        errs.append(scale_err(g[:, 1:9], c[:, 1:9]))
        check(errs[-1] <= NET_TOL, f'joint parity frame {i}: boxes / '
              f'scores err {errs[-1]}')
    return errs, sum(int(r[:, 9].sum()) for r in rows['cpu'])


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from jmodt_torch.config import Config
    from jmodt_torch.data.synthetic import make_eval_frame
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.models.point_rcnn import build_detector
    from jmodt_torch.ops import kernels

    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}', flush=True)
    t0 = time.perf_counter()
    kernels.build()
    print(f'[1 build] kernels built in {time.perf_counter() - t0:.1f} s '
          f'-> {kernels.library_path().name}', flush=True)

    cfg = dataclasses.replace(Config(), DTYPE='bfloat16')
    frames = [make_eval_frame(seed, cfg, raw_u8=True) for seed in range(4)]
    model = build_detector(cfg, seed=0)
    step = make_detection_step(cfg, model)
    print('[2 kernels] inputs recorded from one detection step; kernel vs '
          'plain version:', flush=True)
    agg = check_kernels(record_kernel_inputs(step, frames[3]))

    ms, counts, _ = run_step(step, frames[:3])
    print(f'[3 step] default Config (bfloat16), 3 frames: {ms:.2f} ms/frame'
          f'; launches {counts}', flush=True)

    cfg32 = dataclasses.replace(cfg, DTYPE='float32')
    errs = parity(cfg32, frames[0])
    print('[4 parity] float32 card vs CPU: roi_mask, keep equal; errors '
          + ', '.join(f'{k} {v:.3g}' for k, v in errs.items()), flush=True)
    del model, step

    mcfg = mega_cfg('bfloat16')
    joint = build_joint(mcfg)
    print('[5 K5] inputs recorded from one joint step (RPN.MEGA_SA); kernel '
          'vs plain version:', flush=True)
    agg['sa_level'] = check_k5(record_k5_inputs(joint, mcfg, frames[3]))

    jms, jcounts, rows_per_frame, kept = run_joint(joint, mcfg, frames)
    print(f'[6 joint] Config() with RPN.MEGA_SA (bfloat16), 4 frames: '
          f'{jms:.2f} ms/frame, {rows_per_frame:.2f} rows emitted a frame; '
          f'launches {jcounts}; a frame fed 3 times kept its {kept} ids',
          flush=True)
    del joint

    jerrs, jemit = joint_parity(frames[:3])
    print('[7 parity] joint step float32 card vs CPU, 3 frames: tid, emit '
          f'equal ({jemit} rows emitted); boxes / scores errors '
          + ', '.join(f'{e:.3g}' for e in jerrs), flush=True)

    rows = []
    for k in KERNELS:
        a = agg[k['name']]
        rows.append({
            'name': k['name'], 'route': 'cuda', 'source': k['source'],
            'replaces': k['replaces'], 'launches': jcounts[k['counter']],
            'launches_by_path': {'detection': counts.get(k['counter'], 0),
                                 'joint': jcounts[k['counter']]},
            'max_abs_err': a['max_abs_err'], 'ms': a['ms'],
            'plain_ms': a['plain_ms'],
            'bound_ms': max(a['t_ops'], a['t_bytes']) * 1e3,
            'bound_by': ('operations' if a['t_ops'] >= a['t_bytes']
                         else 'bytes'),
            'library_ms': a['library_ms']})
        if 'default_ms' in a:
            rows[-1]['default_path_ms'] = a['default_ms']
    print(json.dumps({'kernels': rows}))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        with torch.no_grad():
            code = main()
        sys.exit(code)
    except SmokeFailure as e:
        print(f'chip_smoke FAILED: {e}', file=sys.stderr)
        sys.exit(1)
