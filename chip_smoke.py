"""Smoke run of the PyTorch port (jmodt_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build    compile the hand-written kernels from jmodt_torch/csrc.
2. kernels  one frame of the detection step records the inputs each kernel
            wrapper gets on the main path; every kernel (K1 FPS, K2 batched
            FPS, K3 three-NN, K4 grouped gather-MLP-max, K6 depth-to-space
            at the four NonOverlapDeconv levels) is then run on those
            inputs and held against its plain PyTorch version: FPS and 3-NN
            indices equal, 3-NN distances within 1e-5 relative, K4 within
            1e-4 of the output's scale, K6 equal bit for bit.  K1's
            cluster plan (blocks x threads x points a thread) and us a step
            are printed per call, and K3's plan (lanes a query, queries a
            thread, threads a block) with its time, bound, plain time and
            cdist + topk time at each FP level.  Times are
            device time from CUDA events, streaming from HBM (cuda_ms); a
            '*' and the kernel line's "host_clocked" mark a time the host's
            launches may have set.  K6 is also timed against
            permute().contiguous() (the move alone) and its deconv (matmul
            + K6) against F.conv_transpose2d.  K2's plan (warps a cloud,
            clouds a block, points a lane) and us a step are printed per
            call, with a sweep of 1, 2 and 4 warps a cloud (each also
            held against the plain version).
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
            the default path's K1 + ball query + K4 for the same level and
            beside its FPS floor: K1 alone on the same cloud with K5's FPS
            plan (equal indices), so K5 - floor reads off what runs
            outside the FPS.
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
8. streams  the lockstep step (make_batched_joint_step) at S = 4 streams,
            bfloat16, the joint step's weights and settings: one frame
            records every kernel's inputs, and each call is held against
            its plain version with phase 2's and 5's tolerances (K1 once,
            on level 0 of all streams, 4 x 16384 points; K2 and K4 over
            400 RoI clouds; K3, K5 and K6 at batch 4; K2 also timed, with
            its plan, us a step and warp sweep).  Then 3 frames with
            the launch counts set to 0 just before; each kernel must launch
            its per-frame count on every lockstep frame (not per stream),
            packed (4, 64, 10) rows must be finite and some emitted, and
            the tracker must read the host exactly twice a frame.  Then 2
            frames in float32 at S = 2 against two
            independent joint steps on the card: tid and emit equal, boxes
            and scores within 1e-3 of their scale.
9. scan     ScanPipeline with chunks of 3 over 4 frames (a full chunk and a
            ragged tail) against JointPipeline on the same frames: frame
            ids and the tids of the emitted rows equal, boxes within 1e-3
            of their scale.
10. backward one backward of the RPN backbone (4 SA levels, 4 FP levels,
            LI-Fusion, the image pyramid) of the main path's config in
            float32, TF32 off, weights from seed 0, at 16384 points (so
            every level takes the route it takes on the main path) and a
            96x320 image (reduced from 384x1280 to keep the CPU's backward
            short).  Under autograd K4 and K5 must launch 0 times (their
            levels take the differentiable tensor-op routes, as the JAX
            package does), K1 and K3 4 times and K6 4 times through its
            autograd.Function; every parameter's gradient on the card must
            be present and finite and within 1e-4 of its scale of the
            gradient on the card with every wrapper's plain version; the
            features within 1e-4 of the CPU's.  The gradients on the card
            against the CPU's are measured beside the CPU's own spread (the
            same frame with every pixel moved by one ulp) and printed:
            ReLU and max-pool decisions within rounding of their threshold
            flip between any two float32 evaluations, so at these widths no
            1e-4 gate holds between two devices.

Prints a {"kernels": [...]} line (launches from phase 6; per path from
phases 3, 6 and 8; per-call times and bounds; K1's largest placeable
cluster, its cluster size at each N and us a step at level 0; K2's plan,
us a step and warp sweep per call at S = 1 and 4; K3's plan and library
time per FP level; K5's FPS floor per level; K4's and K5's
tensor-core route, with bounds at the TF32 peak for the three products of
each multiply-add and, for reference, as float32 FMAs), the card's name
and power limit, and as its last line {"ok": true, "device": {...}}.  Needs
one card; without one it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# dense TF32 on the tensor cores, HBM
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# K4's layers 2..L (also K5's MLP phase) on the tensor cores: each product
# is three TF32 products (a_lo w_hi + a_hi w_lo + a_hi w_hi) for float32
# accuracy (jmodt_torch/csrc/grouped_mlp.cuh)
K4_ROUTE = 'mma.sync.m16n8k8 tf32, 3xTF32'
K4_PASSES = 3
# torch.cuda._sleep counts SM clock cycles; the H100's top SM clock
SLEEP_HZ = 1.98e9
ROTATE_BYTES = 100 << 20        # twice the H100's 50 MB L2

# per-frame launches of each kernel on the detection step (phase 3) and on
# the joint step with RPN.MEGA_SA (phase 6, the main path); the lockstep
# step (phase 8) launches the joint step's counts per lockstep frame
PER_FRAME = {'fps': 4, 'fps_batched': 2, 'three_nn': 4,
             'grouped_gather_mlp_max': 8, 'depth_to_space': 4}
PER_FRAME_JOINT = {'fps': 1, 'fps_batched': 2, 'three_nn': 4,
                   'grouped_gather_mlp_max': 2, 'sa_level': 3,
                   'depth_to_space': 4}
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
    dict(name='depth_to_space', counter='depth_to_space',
         source='jmodt_torch/csrc/depth_to_space.cu',
         replaces='jmodt_tpu/ops/pallas/depth_to_space.py:87'),
]
NET_TOL = 1e-3
K4_TOL = 1e-4
K5_TOL = 1e-4
JOINT = dict(max_tracks=64, track_k=16, det_score_thresh=0.2,
             assign='hungarian')
STREAMS = 4
HOST_READS = 2          # tracker device-to-host reads a lockstep frame
K2_WARPS = (1, 2, 4)    # K2's plans swept: warps a cloud
GRAD_TOL = 1e-4
# phase 10: kernel launches of one backbone forward under autograd
PER_GRAD = {'fps': 4, 'fps_batched': 0, 'three_nn': 4,
            'grouped_gather_mlp_max': 0, 'sa_level': 0, 'depth_to_space': 4}
GRAD_IMG_HW = (96, 320)


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, args, reps: int):
    """(mean device ms of `fn(*args)` over `reps` calls, host_clocked), from
    CUDA events around the calls, made back to back.  The calls cycle
    through copies of the tensor arguments that together hold twice the
    L2, and keep their outputs alive in a ring as long, so a call streams
    its bytes from and to HBM, as on a frame, instead of finding them in
    L2.  A sleep kernel first holds the stream for about twice the host
    time of the calls, so the host queues them all before the device
    starts: the events then time the device's work, not the host's launch
    cost.  `host_clocked` says the device reached the first call before
    the host had queued the last (the sleep, capped at 0.2 s, was too
    short, or the launch queue filled): the time may then include waits
    for the host."""
    size = sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))
    n = max(1, min(reps, -(-ROTATE_BYTES // max(size, 1))))
    copies = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args) for _ in range(n - 1)]
    ring = [None] * n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring[0] = fn(*args)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(0.2, 2 * reps * host_s + 1e-3) * SLEEP_HZ))
    start.record()
    for i in range(reps):
        ring[i % n] = fn(*copies[i % n])
    end.record()
    host_clocked = start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_clocked


def scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def bound_ms(t_ops: float, nbytes: float):
    """(least ms, what bounds it) for work taking `t_ops` seconds at the
    card's peak rates and moving `nbytes`."""
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def mlp_flops(rows: int, widths) -> tuple:
    """(tensor-core multiply-add flops, other float32 flops) of K4's
    layers 2..L over `rows` rows, widths [C1, .., CL]: the products, then
    the layer-1 add / subtract / ReLU and every bias add and ReLU."""
    pairs = list(zip(widths[:-1], widths[1:]))
    return (rows * sum(2.0 * ci * co for ci, co in pairs),
            rows * (3.0 * widths[0] + sum(2.0 * co for _, co in pairs)))


def tally(*cols):
    """An aggregate over one frame's calls of a kernel: a sum per time
    column, the bound's two times, the largest error, and the columns that
    some call timed by the host's clock."""
    return dict({c: 0.0 for c in cols}, t_ops=0.0, t_bytes=0.0,
                t_f32=0.0, max_abs_err=0.0, host_clocked=set(), per_call=[])


def add_times(tot, times):
    """Add {column: (ms, host_clocked) or None} into `tot`; a None makes
    the column None (no library call for some call of the frame)."""
    for col, t in times.items():
        if t is None or tot[col] is None:
            tot[col] = None
            continue
        tot[col] += t[0]
        if t[1]:
            tot['host_clocked'].add(col)


def show(t) -> str:
    """A time as printed: '*' marks one clocked by the host."""
    return '-' if t is None else f'{t[0]:.4f}{"*" if t[1] else ""} ms'


# ------------------------------------------------------- phases 2, 5, 8

def record_kernel_inputs(run):
    """Run one frame (`run()`), recording the arguments of every kernel
    wrapper call in main-path order, {kernel name: [args, ...]}, and every
    NonOverlapDeconv call, [(module, input), ...].  An FPS call is filed
    under the kernel whose launch count it raised.  Returns ((calls,
    deconvs), what `run` returned)."""
    import jmodt_torch.models.image_backbone as image_backbone
    import jmodt_torch.models.pointnet2 as pointnet2
    import jmodt_torch.ops.fused_sa as fused_sa
    from jmodt_torch.ops import kernels
    calls = {k['name']: [] for k in KERNELS}
    deconvs = []
    deconv_cls = image_backbone.NonOverlapDeconv
    originals = (pointnet2.farthest_point_sample, pointnet2.three_nn,
                 pointnet2.sa_level_fused, fused_sa.grouped_gather_mlp_max,
                 image_backbone.depth_to_space, deconv_cls.forward)

    def fps(xyz, npoint):
        before = kernels.launches.copy()
        out = originals[0](xyz, npoint)
        took = [n for n in ('fps', 'fps_batched')
                if kernels.launches[n] > before[n]]
        check(len(took) == 1, f'FPS {tuple(xyz.shape)}: launched {took}')
        calls[took[0]].append((xyz, npoint))
        return out

    def spy(name, fn):
        def recorded(*args):
            calls[name].append(args)
            return fn(*args)
        return recorded

    def deconv(mod, x):
        deconvs.append((mod, x))
        return originals[5](mod, x)

    pointnet2.farthest_point_sample = fps
    pointnet2.three_nn = spy('three_nn', originals[1])
    pointnet2.sa_level_fused = spy('sa_level', originals[2])
    fused_sa.grouped_gather_mlp_max = spy('grouped_gather_mlp_max',
                                          originals[3])
    image_backbone.depth_to_space = spy('depth_to_space', originals[4])
    deconv_cls.forward = deconv
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        (pointnet2.farthest_point_sample, pointnet2.three_nn,
         pointnet2.sa_level_fused, fused_sa.grouped_gather_mlp_max,
         image_backbone.depth_to_space, deconv_cls.forward) = originals
    return (calls, deconvs), out


def fps_batched_with(xyz, npoint, warps):
    """K2 with `warps` warps a cloud, whatever the wrapper's plan."""
    from jmodt_torch.ops import kernels
    b, n, _ = xyz.shape
    ppt = 1
    while 32 * warps * ppt < n:
        ppt *= 2
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    kernels.launch('fps_batched', 'jmodt_fps_batched', xyz.data_ptr(), b, n,
                   npoint, warps, ppt, out.data_ptr())
    return out


def check_kernels(recorded, per_frame, timed=True):
    """Each recorded call of the kernels in `per_frame` ({name: calls a
    frame}) against its plain version and, for the kernels `timed` names
    (True: all), its kernel, plain and library times and its bound.
    Returns {kernel name: aggregate over the frame's calls}."""
    from jmodt_torch.ops import depth_to_space as d2s
    from jmodt_torch.ops import fused_sa, interpolate, kernels, sampling
    calls, deconvs = recorded
    agg = {}
    timed_names = set(per_frame) if timed is True else set(timed or ())
    for name, per in per_frame.items():
        args_list = calls[name]
        check(len(args_list) == per, f'{name}: {len(args_list)} calls a '
              f'frame, expected {per}')
        on = name in timed_names
        if name == 'sa_level':
            agg[name] = check_k5(args_list, on)
            continue
        tot = tally('ms', 'plain_ms', 'library_ms')
        for i, args in enumerate(args_list):
            extra = ''
            t_ops = None
            if name in ('fps', 'fps_batched'):
                xyz, npoint = args
                b, n, _ = xyz.shape
                fns = (sampling.farthest_point_sample,
                       sampling.farthest_point_sample_plain, None)
                reps = (10, 2, 0)
                check(torch.equal(fns[0](*args), fns[1](*args)),
                      f'{name} {b}x{n}->{npoint}: indices differ')
                err = 0.0
                flops = 9.0 * b * n * (npoint - 1)
                nbytes = b * (12.0 * n + 4.0 * npoint)
                shape = f'B={b} {n}->{npoint}'
                call = dict(b=b, n=n, npoint=npoint)
                if name == 'fps':
                    plan = sampling.fps_launch_plan(
                        n, kernels.fps_max_cluster())
                    call.update(zip(('cluster', 'threads', 'ppt'), plan))
                    extra = (f' cluster {plan[0]} x {plan[1]} threads x '
                             f'{plan[2]} points')
                else:
                    plan = sampling.fps_batched_launch_plan(b, n)
                    call.update(zip(('warps', 'clouds', 'ppt'), plan))
                    extra = (f' plan {plan[0]} warps a cloud x {plan[1]} '
                             f'clouds a block x {plan[2]} points a lane')
                    want = fns[1](*args)
                    for w in K2_WARPS:
                        check(torch.equal(fps_batched_with(xyz, npoint, w),
                                          want),
                              f'K2 {b}x{n}->{npoint} with {w} warps a '
                              'cloud: indices differ')
            elif name == 'three_nn':
                u, kn = args
                b, n, m = u.shape[0], u.shape[1], kn.shape[1]
                fns = (interpolate.three_nn, interpolate.three_nn_plain,
                       lambda u, kn: torch.topk(torch.cdist(u, kn), 3,
                                                largest=False))
                reps = (20, 3, 5)
                (d, i_), (dp, ip) = fns[0](*args), fns[1](*args)
                check(torch.equal(i_, ip),
                      f'three_nn B={b} {n}x{m}: indices differ')
                rel = float(((d - dp).abs() / dp.abs().clamp_min(1e-30))
                            .max())
                check(rel <= 1e-5,
                      f'three_nn B={b} {n}x{m}: distance rel err {rel}')
                err = float((d - dp).abs().max())
                flops = 8.0 * b * n * m
                nbytes = 12.0 * b * (n + m) + 24.0 * b * n
                shape = f'B={b} {n}x{m}'
                plan = interpolate.three_nn_launch_plan(b, n, m)
                call = dict(b=b, n=n, m=m, lanes=plan.lanes,
                            queries=plan.queries, threads=plan.threads)
                extra = (f' {plan.lanes} lanes a query, {plan.queries} '
                         f'queries a thread, {plan.threads} threads')
            elif name == 'depth_to_space':
                taps, k, r, h0, w0, bias = args
                b = taps.shape[0]
                fns = (d2s.depth_to_space, d2s.depth_to_space_plain,
                       lambda taps, k, r, h0, w0, _bias: taps.view(
                           b, h0, w0, k, k, r).permute(
                               0, 1, 3, 2, 4, 5).contiguous())
                reps = (20, 10, 20)
                got = fns[0](*args)
                check(torch.equal(got, fns[1](*args)),
                      f'K6 B={b} k={k}: differs from plain')
                err = 0.0
                flops = float(got.numel())                  # the bias adds
                nbytes = float(taps.element_size()
                               * (taps.numel() + r + got.numel()))
                shape = (f'B={b} k={k} {h0}x{w0}x{k * k * r}->{h0 * k}x'
                         f'{w0 * k}x{r}')
                call = dict(b=b, k=k)
                if on:
                    check(len(deconvs) == per,
                          f'{len(deconvs)} NonOverlapDeconv calls a frame')
                    mod, x = deconvs[i]
                    dt = mod.dtype
                    w, bb = mod.weight.to(dt), mod.bias.to(dt)
                    dec = {'deconv_ms': cuda_ms(mod, (x,), 20),
                           'deconv_library_ms': cuda_ms(
                               lambda x: F.conv_transpose2d(
                                   x.permute(0, 3, 1, 2).to(dt), w, bb,
                                   stride=k), (x,), 20)}
                    tot.setdefault('deconv_ms', 0.0)
                    tot.setdefault('deconv_library_ms', 0.0)
                    add_times(tot, dec)
                    extra = (f' deconv: matmul+K6 {show(dec["deconv_ms"])}, '
                             'conv_transpose2d '
                             f'{show(dec["deconv_library_ms"])}')
            else:
                feats1, idx, cxw, b1, layers = args
                b, n, c1 = feats1.shape
                m, s = idx.shape[1], idx.shape[2]
                fns = (fused_sa.grouped_gather_mlp_max,
                       fused_sa.grouped_gather_mlp_max_plain, None)
                reps = (10, 3, 0)
                got, want = fns[0](*args), fns[1](*args)
                rel = scale_err(got, want)
                check(rel <= K4_TOL, f'K4 B={b} M={m} S={s}: err {rel}')
                err = float((got - want).abs().max())
                rows = b * m * s
                widths = [c1] + [w.shape[1] for w, _ in layers]
                mma, other = mlp_flops(rows, widths)
                flops = mma + other
                t_ops = (K4_PASSES * mma / PEAK_TF32_FLOPS
                         + other / PEAK_F32_FLOPS)
                nbytes = 4.0 * (feats1.numel() + idx.numel() + cxw.numel()
                                + c1 + sum(w.numel() + bb.numel()
                                           for w, bb in layers)
                                + b * m * widths[-1])
                shape = (f'B={b} N={n} M={m} S={s} '
                         f'{"->".join(map(str, widths))}')
                call = dict(b=b, m=m, s=s, widths=widths)
            tot['max_abs_err'] = max(tot['max_abs_err'], err)
            if not on:
                print(f'  {name:24s} {shape:38s} equal to plain, max_abs_err '
                      f'{err:.3g}', flush=True)
                continue
            times = {col: None if fn is None else cuda_ms(fn, args, n)
                     for col, fn, n in zip(('ms', 'plain_ms', 'library_ms'),
                                           fns, reps)}
            add_times(tot, times)
            if t_ops is None:
                t_ops = flops / PEAK_F32_FLOPS
            bms, by = bound_ms(t_ops, nbytes)
            tot['t_ops'] += t_ops
            tot['t_bytes'] += nbytes / PEAK_BYTES
            tot['t_f32'] += flops / PEAK_F32_FLOPS
            call.update(ms=times['ms'][0], bound_ms=bms)
            if name == 'three_nn':
                call.update(plain_ms=times['plain_ms'][0],
                            library_ms=times['library_ms'][0])
            if name in ('fps', 'fps_batched'):
                call['us_per_step'] = times['ms'][0] * 1e3 / (npoint - 1)
                extra += f', {call["us_per_step"]:.3f} us a step'
            if name == 'fps_batched':
                sweep = {w: cuda_ms(fps_batched_with, (xyz, npoint, w), 10)
                         for w in K2_WARPS}
                call['sweep_ms'] = {str(w): t[0] for w, t in sweep.items()}
                extra += '; warps a cloud ' + ', '.join(
                    f'{w}: {show(t)}' for w, t in sweep.items())
            tot['per_call'].append(call)
            print(f'  {name:24s} {shape:38s} kernel {show(times["ms"])}  '
                  f'plain {show(times["plain_ms"])}  library '
                  f'{show(times["library_ms"])}  bound {bms:.4f} ms ({by})  '
                  f'max_abs_err {err:.3g}{extra}', flush=True)
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


def joint_parts(cfg, device=None):
    """The main path's detector (weights from seed 0) and link head (seed
    1), and the joint step's settings but max_tracks."""
    from jmodt_torch.models.point_rcnn import build_detector, init_weights
    from jmodt_torch.models.rcnn import CorrelationHead
    model = build_detector(cfg, device=device, seed=0)
    head = CorrelationHead(cfg.RCNN.SA_CONFIG.MLPS[-1][-1], cfg.REID.LINK_FC,
                           use_bn=cfg.REID.USE_BN)
    init_weights(head, 1)
    kw = {k: v for k, v in JOINT.items() if k != 'max_tracks'}
    return model, head, kw


def build_joint(cfg, device=None, batched=False):
    """The joint step of the main path (`make_batched_joint_step` when
    `batched`)."""
    from jmodt_torch.pipeline import make_batched_joint_step, make_joint_step
    model, head, kw = joint_parts(cfg, device)
    make = make_batched_joint_step if batched else make_joint_step
    return make(cfg, model, head, device=device, **kw)


def new_state(cfg, device=None, streams=None):
    """An empty tracker state; with `streams`, one for the lockstep step."""
    from jmodt_torch.tracking.device_tracker import (init_batched_state,
                                                     init_state)
    feat_dim = cfg.RCNN.SA_CONFIG.MLPS[-1][-1]
    if streams is None:
        return init_state(JOINT['max_tracks'], feat_dim, device=device)
    return init_batched_state(streams, JOINT['max_tracks'], feat_dim,
                              device=device)


def k5_work(args, new_xyz):
    """(seconds at peak for the operations, bytes) one K5 call needs on
    these inputs.  The MLP phase's products run on the tensor cores
    (K4_PASSES TF32 products each), everything else in float32 FMAs.  The
    ball query counts, per centre, the points up to the last one the scan
    must see: the nsample-th hit of the slowest scale, or the whole cloud
    when a ball is not full.  Also returns the operations' seconds were
    they all float32 FMAs."""
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
    mma = 0.0
    for ns, layers in zip(nsamples, folded):
        widths = [3 + c] + [w.shape[1] for w, _ in layers]
        flops += 2.0 * b * n * widths[0] * widths[1]         # table
        flops += 6.0 * b * npoint * widths[1]                # cxw
        m_flops, other = mlp_flops(b * npoint * ns, widths[1:])
        mma += m_flops
        flops += other
        nbytes += 4.0 * (sum(w.numel() + bb.numel() for w, bb in layers)
                         + b * npoint * widths[-1])
    t_ops = flops / PEAK_F32_FLOPS + K4_PASSES * mma / PEAK_TF32_FLOPS
    return t_ops, nbytes, (flops + mma) / PEAK_F32_FLOPS


def default_level(xyz, feats, npoint, radii, nsamples, folded):
    """The same level on the default path: K1, ball query, and per scale
    the hoisted layer 1 and K4."""
    from jmodt_torch.ops import fused_sa, grouping, sampling
    idx = sampling.farthest_point_sample(xyz, npoint)
    new_xyz = sampling.gather_xyz(xyz, idx)
    nbrs = grouping.ball_query_multi(radii, nsamples, xyz, new_xyz)
    return torch.cat([fused_sa.fused_sa_eval(xyz, feats, new_xyz, nbr, lay)
                      for nbr, lay in zip(nbrs, folded)], dim=-1)


def k5_fps_floor(xyz, npoint, nsamples, folded):
    """K1 alone on the cloud with the FPS plan K5 runs (K5's floor: its
    table, query and MLP run behind this FPS).  Launched directly, since
    the FPS wrapper gives B > 1 clouds of at most 1024 points to K2."""
    from jmodt_torch.ops import kernels, sa_level
    b, n, _ = xyz.shape
    widths = [[layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]
              for layers in folded]
    plan = sa_level.k5_launch_plan(
        b, n, npoint, nsamples, widths, kernels.fps_max_cluster(),
        torch.cuda.get_device_properties(xyz.device).multi_processor_count)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    kernels.launch('fps', 'jmodt_fps', xyz.data_ptr(), b, n, npoint,
                   *plan.fps, out.data_ptr())
    return out


def check_k5(calls, timed=True):
    """K5 vs its plain version at each recorded level and, when `timed`,
    its times beside the default path's and beside its FPS floor; returns
    the aggregate over the frame's calls."""
    from jmodt_torch.ops import sa_level
    tot = tally('ms', 'plain_ms', 'default_ms', 'fps_floor_ms')
    tot['library_ms'] = None
    for level, args in enumerate(calls, start=1):
        xyz, feats, npoint, radii, nsamples, folded = args
        got = sa_level.sa_level_fused(*args)
        want = sa_level.sa_level_fused_plain(*args)
        check(torch.equal(got[2], want[2]), f'K5 L{level}: indices differ')
        check(torch.equal(got[0], want[0]), f'K5 L{level}: centres differ')
        rel = scale_err(got[1], want[1])
        check(rel <= K5_TOL, f'K5 L{level}: pooled err {rel}')
        err = float((got[1] - want[1]).abs().max())
        tot['max_abs_err'] = max(tot['max_abs_err'], err)
        c = 0 if feats is None else feats.shape[-1]
        shape = (f'B={xyz.shape[0]} N={xyz.shape[1]} C={c} M={npoint} S='
                 f'{"/".join(map(str, nsamples))}')
        if not timed:
            print(f'  sa_level L{level} {shape}  equal to plain, max_abs_err '
                  f'{err:.3g}', flush=True)
            continue
        floor_args = (xyz, npoint, nsamples, folded)
        check(torch.equal(k5_fps_floor(*floor_args), got[2]),
              f'K5 L{level}: K1 with K5\'s FPS plan gives other indices')
        times = {'ms': cuda_ms(sa_level.sa_level_fused, args, 10),
                 'plain_ms': cuda_ms(sa_level.sa_level_fused_plain, args, 2),
                 'default_ms': cuda_ms(default_level, args, 5),
                 'fps_floor_ms': cuda_ms(k5_fps_floor, floor_args, 10)}
        add_times(tot, times)
        t_ops, nbytes, t_f32 = k5_work(args, want[0])
        bms, by = bound_ms(t_ops, nbytes)
        tot['t_ops'] += t_ops
        tot['t_bytes'] += nbytes / PEAK_BYTES
        tot['t_f32'] += t_f32
        floor = times['fps_floor_ms'][0]
        tot['per_call'].append(dict(level=level, n=xyz.shape[1], m=npoint,
                                    ms=times['ms'][0], bound_ms=bms,
                                    fps_floor_ms=floor,
                                    over_floor_ms=times['ms'][0] - floor))
        print(f'  sa_level L{level} {shape}  kernel {show(times["ms"])}  '
              f'plain {show(times["plain_ms"])}  default path (K1+ball '
              f'query+K4) {show(times["default_ms"])}  FPS floor (K1, K5\'s '
              f'plan) {show(times["fps_floor_ms"])}, K5 - floor '
              f'{times["ms"][0] - floor:.4f} ms  bound {bms:.4f} ms ({by})  '
              f'max_abs_err {err:.3g}', flush=True)
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


# ----------------------------------------------------------- phases 8, 9

def lockstep_inputs(frames, t, streams):
    """(frame_ids, pts, imgs, xys) of lockstep frame t: stream s sees
    frames[(s + t) % len(frames)], numbered t + 1."""
    pick = [frames[(s + t) % len(frames)] for s in range(streams)]
    return (np.full(streams, t + 1, np.int32),
            *(np.concatenate([f[k] for f in pick])
              for k in ('pts_input', 'img', 'pts_xy')))


def run_batched(bjoint, cfg, frames):
    """Phase 8: one lockstep frame records every kernel's inputs, which are
    then held against the plain versions (K2 also timed); then 3 frames
    with per-frame launch and host-read checks.  Returns (ms a lockstep
    frame, launches, rows emitted a lockstep frame, K2's aggregate)."""
    from jmodt_torch.ops import kernels
    from jmodt_torch.tracking import device_tracker
    states = new_state(cfg, streams=STREAMS)
    recorded, (states, _) = record_kernel_inputs(
        lambda: bjoint(states, *lockstep_inputs(frames, 0, STREAMS)))
    level0 = tuple(recorded[0]['fps'][0][0].shape)
    check(level0 == (STREAMS, cfg.RPN.NUM_POINTS, 3),
          f'streams: K1 took {level0}, expected level 0 of all streams')
    k2 = check_kernels(recorded, PER_FRAME_JOINT,
                       timed=('fps_batched',))['fps_batched']
    inputs = [lockstep_inputs(frames, t, STREAMS) for t in (1, 2, 3)]
    kernels.launches.clear()
    reads0 = device_tracker.host_syncs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packs, per_frame, reads = [], [], []
    for args in inputs:
        states, packed = bjoint(states, *args)
        packs.append(packed)
        per_frame.append(dict(kernels.launches))    # running totals
        reads.append(device_tracker.host_syncs - reads0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(inputs)
    counts = dict(kernels.launches)
    for i, seen in enumerate(per_frame):
        for name, per in PER_FRAME_JOINT.items():
            check(seen.get(name, 0) == per * (i + 1),
                  f'streams: {name} launched {seen.get(name, 0)} times in '
                  f'{i + 1} lockstep frames, expected {per * (i + 1)}')
        check(reads[i] == HOST_READS * (i + 1),
              f'streams: {reads[i]} tracker host reads in {i + 1} frames, '
              f'expected {HOST_READS * (i + 1)}')
    emitted = 0
    for i, packed in enumerate(packs):
        check(packed.shape == (STREAMS, JOINT['max_tracks'], 10),
              f'streams frame {i}: packed {tuple(packed.shape)}')
        check(bool(torch.isfinite(packed).all()),
              f'streams frame {i}: non-finite rows')
        emitted += int((packed[..., 9] > 0.5).sum())
    check(emitted > 0, 'streams: no row emitted in 3 lockstep frames')
    return ms, counts, emitted / len(packs), k2


def batched_parity(frames, streams=2, n_frames=2):
    """Phase 8, second half: float32 lockstep streams against independent
    joint steps on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = mega_cfg('float32')
    bjoint = build_joint(cfg32, batched=True)
    states = new_state(cfg32, streams=streams)
    lock = []
    for t in range(n_frames):
        states, packed = bjoint(states, *lockstep_inputs(frames, t, streams))
        lock.append(packed.cpu())
    del bjoint
    joint = build_joint(cfg32)
    errs, emitted = [], 0
    for s in range(streams):
        state = new_state(cfg32)
        for t in range(n_frames):
            f = frames[(s + t) % len(frames)]
            state, packed = joint(state, t + 1, f['pts_input'], f['img'],
                                  f['pts_xy'])
            got, want = lock[t][s], packed.cpu()
            check(torch.equal(got[:, 0], want[:, 0]),
                  f'streams parity stream {s} frame {t}: tid')
            check(torch.equal(got[:, 9], want[:, 9]),
                  f'streams parity stream {s} frame {t}: emit')
            errs.append(scale_err(got[:, 1:9], want[:, 1:9]))
            check(errs[-1] <= NET_TOL, f'streams parity stream {s} frame '
                  f'{t}: boxes / scores err {errs[-1]}')
            emitted += int(want[:, 9].sum())
    return errs, emitted


def scan_vs_joint(cfg, frames, chunk=3):
    """Phase 9: ScanPipeline against JointPipeline on the same frames."""
    from jmodt_torch.pipeline import JointPipeline, ScanPipeline
    model, head, kw = joint_parts(cfg)
    common = dict(feat_dim=cfg.RCNN.SA_CONFIG.MLPS[-1][-1],
                  max_tracks=JOINT['max_tracks'], **kw)
    scan = ScanPipeline(cfg, model, head, chunk=chunk, **common)
    pipe = JointPipeline(cfg, model, head, fetch_lag=1, **common)
    got, want = [], []
    for i, f in enumerate(frames):
        args = (i + 1, f['pts_input'], f['img'], f['pts_xy'])
        got.extend(scan.push(*args))
        r = pipe.push(*args)
        if r is not None:
            want.append(r)
    got.extend(scan.flush())
    want.extend(pipe.flush())
    ids = [fid for fid, _ in got]
    check(ids == [fid for fid, _ in want] == list(range(1, len(frames) + 1)),
          f'scan: frame ids {ids}')
    err, rows = 0.0, 0
    for (fid, grows), (_, wrows) in zip(got, want):
        check([r[0] for r in grows] == [r[0] for r in wrows],
              f'scan frame {fid}: tids {[r[0] for r in grows]} vs '
              f'{[r[0] for r in wrows]}')
        for (_, gbox, _), (_, wbox, _) in zip(grows, wrows):
            err = max(err, scale_err(torch.as_tensor(gbox),
                                     torch.as_tensor(wbox)))
        rows += len(grows)
    check(err <= NET_TOL, f'scan: boxes err {err}')
    check(rows > 0, 'scan: no row emitted')
    return err, rows


# ----------------------------------------------------------------- phase 10

def backbone_backward(cfg32, frame, cot, dev, plain=False, img_scale=1.0):
    """One forward and backward of the RPN backbone (weights from seed 0)
    on `dev`; `plain` runs every kernel wrapper's plain version (also on
    the card), `img_scale` multiplies the image.  Returns (features,
    {parameter: gradient or None}, launches, K6 backward calls)."""
    from jmodt_torch.models.point_rcnn import build_detector
    from jmodt_torch.ops import depth_to_space as d2s
    from jmodt_torch.ops import kernels
    backbone = build_detector(cfg32, device=dev, seed=0).rpn.backbone
    pts, img, xy = (torch.as_tensor(frame[k], device=dev)
                    for k in ('pts_input', 'img', 'pts_xy'))
    backward, on_card = d2s.DepthToSpace.backward, kernels.on_card
    k6_backward = []

    def counted(ctx, grad):
        k6_backward.append(1)
        return backward(ctx, grad)

    d2s.DepthToSpace.backward = staticmethod(counted)
    if plain:
        kernels.on_card = lambda t: False
    kernels.launches.clear()
    try:
        with torch.enable_grad():
            _, feats = backbone(pts, img * img_scale, xy)
            (feats * cot.to(dev)).sum().backward()
        if dev == 'cuda':
            torch.cuda.synchronize()
    finally:
        d2s.DepthToSpace.backward, kernels.on_card = backward, on_card
    grads = {name: None if p.grad is None else p.grad.detach().cpu()
             for name, p in backbone.named_parameters()}
    return (feats.detach().cpu(), grads, dict(kernels.launches),
            len(k6_backward))


def grad_errs(got, want):
    """{parameter: max |got - want| over max |want|}."""
    return {name: float((got[name].double() - w.double()).abs().max()
                        / max(float(w.abs().max()), 1e-30))
            for name, w in want.items()}


def backward_parity(cfg32):
    """Phase 10: the RPN backbone's backward on the card with its kernels,
    on the card with every kernel wrapper's plain version, and on the CPU.
    Gates: the launches under autograd; every gradient on the card
    present and finite; the card's gradients with its kernels against
    the card's with the plain versions (the same forward, since K1, K3
    and K6 equal their plain versions bit for bit) within GRAD_TOL of
    scale; the features against the CPU's within GRAD_TOL of scale.  The
    card's gradients against the CPU's, and the CPU's against the CPU's
    for the same frame with every pixel moved by at most one float32 ulp,
    are measured and returned: ReLU and max-pool decisions that sit within
    rounding of their threshold flip between any two float32 evaluations,
    and each flip moves a whole term of a gradient."""
    from jmodt_torch.data.synthetic import make_eval_frame
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frame = make_eval_frame(0, cfg32, img_hw=GRAD_IMG_HW)
    cot = torch.randn(1, cfg32.RPN.NUM_POINTS,
                      cfg32.LI_FUSION.IMG_FEATURES_CHANNEL,
                      generator=torch.Generator().manual_seed(10))
    # the two card runs compare gradients of one forward: deterministic
    # scatters keep their sums in one order (ops without a deterministic
    # form, such as grid_sample's backward, run as they are)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', UserWarning)
            feats, grads, launches, k6_back = backbone_backward(
                cfg32, frame, cot, 'cuda')
            pfeats, pgrads, plaunches, _ = backbone_backward(
                cfg32, frame, cot, 'cuda', plain=True)
    finally:
        torch.use_deterministic_algorithms(False)
    for name, per in PER_GRAD.items():
        check(launches.get(name, 0) == per, f'backward: {name} launched '
              f'{launches.get(name, 0)} times under autograd, expected {per}')
    check(k6_back == PER_GRAD['depth_to_space'],
          f'backward: K6 backward ran {k6_back} times')
    for name, g in grads.items():
        check(g is not None and bool(torch.isfinite(g).all()),
              f'backward: no finite gradient for {name}')
    check(sum(plaunches.values()) == 0,
          f'backward: the plain run launched {plaunches}')
    check(scale_err(feats, pfeats) <= GRAD_TOL,
          f'backward: features with kernels vs plain versions err '
          f'{scale_err(feats, pfeats)}')
    vs_plain = grad_errs(grads, pgrads)
    worst = max(vs_plain, key=vs_plain.get)
    check(vs_plain[worst] <= GRAD_TOL, f'backward: {worst} gradient with '
          f'kernels vs plain versions err {vs_plain[worst]}')
    cfeats, cgrads, _, _ = backbone_backward(cfg32, frame, cot, 'cpu')
    fwd_err = scale_err(feats, cfeats)
    check(fwd_err <= GRAD_TOL, f'backward: features card vs CPU err '
          f'{fwd_err}')
    _, ugrads, _, _ = backbone_backward(cfg32, frame, cot, 'cpu',
                                        img_scale=1.0 + 2.0 ** -23)
    return dict(params=len(grads), launches=launches, k6_backward=k6_back,
                vs_plain=(vs_plain[worst], worst), fwd_vs_cpu=fwd_err,
                vs_cpu=grad_errs(grads, cgrads),
                cpu_vs_ulp=grad_errs(ugrads, cgrads))


def over(errs, tol=GRAD_TOL):
    """(largest error, its parameter, how many are over `tol`)."""
    worst = max(errs, key=errs.get)
    return errs[worst], worst, sum(e > tol for e in errs.values())


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
    f = frames[3]
    recorded, _ = record_kernel_inputs(
        lambda: step(f['pts_input'], f['img'], f['pts_xy']))
    agg = check_kernels(recorded, PER_FRAME)

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
    recorded, _ = record_kernel_inputs(
        lambda: joint(new_state(mcfg), 1, f['pts_input'], f['img'],
                      f['pts_xy']))
    agg.update(check_kernels(
        recorded, {'sa_level': PER_FRAME_JOINT['sa_level']}))

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

    bjoint = build_joint(mcfg, batched=True)
    print(f'[8 streams] inputs recorded from one lockstep frame (S={STREAMS}'
          '); kernel vs plain version:', flush=True)
    bms, bcounts, brows, k2_streams = run_batched(bjoint, mcfg, frames)
    del bjoint
    print(f'[8 streams] make_batched_joint_step, S={STREAMS} (bfloat16), 3 '
          f'lockstep frames: {bms:.2f} ms a lockstep frame, '
          f'{bms / STREAMS:.2f} ms a stream-frame, {brows:.2f} rows emitted '
          f'a lockstep frame, {HOST_READS} tracker host reads a frame; '
          f'launches {bcounts}', flush=True)
    berrs, bemit = batched_parity(frames)
    print('[8 streams] float32 S=2 lockstep vs independent joint steps, 2 '
          f'frames: tid, emit equal ({bemit} rows emitted); boxes / scores '
          'errors ' + ', '.join(f'{e:.3g}' for e in berrs), flush=True)

    serr, srows = scan_vs_joint(mcfg, frames)
    print(f'[9 scan] ScanPipeline (chunk 3, 4 frames, ragged tail) vs '
          f'JointPipeline: frame ids and tids equal ({srows} rows), boxes '
          f'err {serr:.3g}', flush=True)

    t0 = time.perf_counter()
    back = backward_parity(mega_cfg('float32'))
    cpu, ulp = over(back['vs_cpu']), over(back['cpu_vs_ulp'])
    print(f'[10 backward] RPN backbone, float32, {mcfg.RPN.NUM_POINTS} '
          f'points, {GRAD_IMG_HW[0]}x{GRAD_IMG_HW[1]} image: launches under '
          f'autograd {back["launches"]}, K6 backward {back["k6_backward"]} '
          f'times; {back["params"]} parameter gradients present and finite; '
          f'with kernels vs plain versions on the card: largest err '
          f'{back["vs_plain"][0]:.3g} of scale ({back["vs_plain"][1]}); '
          f'features card vs CPU err '
          f'{back["fwd_vs_cpu"]:.3g}; gradients card vs CPU (measured, not '
          f'gated): largest err {cpu[0]:.3g} ({cpu[1]}), {cpu[2]} over '
          f'{GRAD_TOL:g}; CPU vs CPU with the image moved by one ulp: '
          f'largest {ulp[0]:.3g} ({ulp[1]}), {ulp[2]} over {GRAD_TOL:g} '
          f'({time.perf_counter() - t0:.1f} s)', flush=True)

    rows = []
    for k in KERNELS:
        a = agg[k['name']]
        rows.append({
            'name': k['name'], 'route': 'cuda', 'source': k['source'],
            'replaces': k['replaces'], 'launches': jcounts[k['counter']],
            'launches_by_path': {'detection': counts.get(k['counter'], 0),
                                 'joint': jcounts[k['counter']],
                                 'batched': bcounts[k['counter']]},
            'max_abs_err': a['max_abs_err'], 'ms': a['ms'],
            'plain_ms': a['plain_ms'],
            'bound_ms': max(a['t_ops'], a['t_bytes']) * 1e3,
            'bound_by': ('operations' if a['t_ops'] >= a['t_bytes']
                         else 'bytes'),
            'library_ms': a['library_ms'],
            'host_clocked': sorted(a['host_clocked'])})
        row = rows[-1]
        if k['name'] in ('grouped_gather_mlp_max', 'sa_level'):
            row['tensor_cores'] = K4_ROUTE
            row['bound_f32_fma_ms'] = max(a['t_f32'], a['t_bytes']) * 1e3
        if k['name'] == 'fps_batched':
            row['per_call_streams'] = k2_streams['per_call']
            row['ms_streams'] = k2_streams['ms']
        if k['name'] == 'fps':
            row['max_cluster'] = kernels.fps_max_cluster()
            row['cluster_by_n'] = {str(c['n']): c['cluster']
                                   for c in a['per_call']}
            row['us_per_step_level0'] = a['per_call'][0]['us_per_step']
        if a['per_call']:
            row['per_call'] = a['per_call']
        if 'default_ms' in a:
            row['default_path_ms'] = a['default_ms']
            row['fps_floor_ms'] = a['fps_floor_ms']
        if 'deconv_ms' in a:
            row['deconv_ms'] = a['deconv_ms']
            row['deconv_library_ms'] = a['deconv_library_ms']
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
