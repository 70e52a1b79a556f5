"""Smoke run of the PyTorch port (jmodt_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --data-parallel    # phases 1 and 15 alone
    python3 chip_smoke.py --remainder        # phases 1 and 16 alone

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
11. finetune the training step of the link / se finetune (Config(): the
            RPN frozen, in eval mode under no_grad; the link / se heads
            trained), bfloat16, 4 frame pairs (8 frames) a step at full
            width, detector weights from seed 0 and link / se weights from
            seed 1.  With random weights no RoI reaches REID.FG_THRESH
            (0.85), so Config()'s finetune loss and gradient are 0; these
            steps run with REID.FG_THRESH 0, where every RoI keeps its gt's
            track id and the link / se terms are not 0.  3 steps with the
            launch counts set to 0 before each; every kernel must launch
            its per-step count on every step (the last step's counts go in
            the kernel line).  The inputs of every kernel call are recorded
            on step 1 and held against its plain version with phase 2's
            tolerances (K1 at B = 8, K2 over 512 RoI clouds; plans printed,
            times and bounds in the kernel line).  The loss terms must be
            finite, the loss, grad_norm and every link / se weight's
            gradient nonzero, every frozen parameter and every RPN
            BatchNorm buffer bit-equal to its value before the step, and
            every link / se weight moved.  Prints ms a step (CUDA events
            and the wall clock, steps 2-3), the peak memory and the share of
            step 3 spent in the proposal layer (synchronized around it).
            Then one float32 step on 1 pair on the card and on the CPU, TF32
            off, the same RoI draws, with Config() and again with
            REID.FG_THRESH 0: loss terms and grad_norm within 1e-3 of their
            scale, every link / se gradient within 1e-3 of its own scale
            (exactly 0 where the CPU's is), the sampled RoIs' cls_label and
            reg_valid_mask equal except where the RoI's IoU lies within
            1e-4 of a threshold (those are printed).
12. full     the full-losses training step (RPN.FIXED and TRAIN.FINETUNE
            off: train-mode BatchNorm, dropout 0.5 in the RPN heads),
            bfloat16, 1 pair at full width: per-step launch counts (K4 and
            K5 0 under autograd, K6 4 forward and 4 backward through its
            autograd.Function), every parameter's gradient present and
            finite, one BatchNorm layer's new running mean and variance
            equal (1e-5 of scale) to flax's rule recomputed from the batch
            it saw, and ms a step.
13. eval     `python -m jmodt_torch.eval` through its stage functions on a
            raw KITTI tracking tree written to a temporary directory (2
            validation sequences of 3 frames, 375x1242 PNGs written by
            utils/png.py, 24000-point sweeps of synthetic scenes moved into
            lidar coordinates by a pinhole calibration, label_02 ground
            truth) and converted by `data/converter.py`; Config()
            (16384 points, a 384x1280 uint8 image, 100 RoIs), random weights
            from seed 0 and link / se heads from seed 1, saved as a port
            .pth and read back by `--ckpt`.  Stage 1: the launch counts
            set to 0 just before; each kernel must launch its detection
            step count (K1 4 / K2 2 / K3 4 / K4 8 / K5 0 / K6 4) on every
            frame; every kernel call of frame 1 held against its plain
            version with phase 2's tolerances; the txt and feat files equal
            byte for byte to those of a direct make_detection_step run on
            the same collated batches; the recall counters equal to a CPU
            recount of the same outputs; a finite AP; `rotate_iou_eval` on
            the card within 1e-6 of scale of the CPU's (every criterion)
            and the AP dict equal to the one computed on the CPU.  Stage 2
            on perfect detections (the gt boxes written as stage-1 files):
            MOTA 1.0 and 0 id switches for the host tracker (MIP and
            --hungarian), --device_tracker and --batch_seqs, and the
            --batch_seqs tracks equal to --device_tracker's.  Prints stage
            1's ms a frame, each stage-2 mode's frames/s and the AP
            evaluation's seconds.
14. kitti   `python -m jmodt_torch.train --data_root` through its `main`
            on a raw KITTI tracking tree written to a temporary directory
            (a training sequence of 13 frames, so 12 pairs, a validation
            sequence of 3 and small_val's of 2; 375x1242 PNGs and
            24000-point sweeps as phase 13's) and converted: Config()
            finetune with REID.FG_THRESH 0 (`--set`), 4 pairs a step, 2
            loader processes, 1 epoch of 3 steps, `--async_ckpt`.  The
            launch counts are set to 0 before each step; every step must
            launch phase 11's counts, its loss terms be finite, the loss,
            grad_norm and every link / se weight gradient nonzero and
            finite; step 1's kernel calls are recorded and each held
            against its plain version with phase 2's tolerances; every
            frozen parameter and buffer bit-equal after the steps; the
            background checkpoint_epoch_1 loads into a fresh model bit-equal
            to the trained one.  A resume from it (`TRAIN.RELOAD_OPTIMIZER`,
            0 loader processes, 2 epochs) must start at iteration 3, take
            as its first batch the dataset's own collate of the seed's first
            pairs, launch the same counts and save epoch 2 at iteration 6.
            Then one full-losses step (`--finetune`, 1 pair, the small_val
            split): phase 12's counts, K6 backward 4 times, every gradient
            finite.  Prints ms a step (CUDA events and wall), the peak
            memory, the loader's host ms a batch at 0 and 2 processes and
            what `utils/png.py` takes to read one 375x1242 PNG with filter 0
            on every row and with all five filters (written by a small
            encoder here).  Last, `python -m jmodt_torch.eval.mot_sweep`
            (a 2x2 grid of cls_thresh x t_miss, on the card) over perfect
            detections of the tree: MOTA 1.0 for each config whose
            cls_thresh lies below their score, and the best config's track
            files equal to `python -m jmodt_torch.eval --only_tracking`
            with its flags.

15. parallel 2 ranks on cuda:0 over gloo (spawned,
            the kernels loaded from phase 1's build, not rebuilt) against
            one process: 3 finetune steps of 4 pairs (bfloat16) with
            every rank's launches equal to the one process's, ms a step,
            collectives and ms in them, peak memory a rank; then in
            float32 with TF32 off one finetune step of 4 pairs and one
            full-losses step of 2 pairs, each also run by one process on
            its points moved by one ulp (the control): the ranks
            bit-equal, BatchNorm statistics within 1e-5 of scale,
            gradients within the control's gap, flipped-sign gradient
            elements at most 1e-3 of a leaf (full losses: or the
            control's count there); the finetune's loss terms and
            parameters (but elements whose gradient is float32 noise, at
            most 1e-6 of the largest, or flips sign) within 1e-5; the
            full losses' RPN terms within 1e-5, every term within the
            control's gap and parameters within twice it (also over NCCL,
            a rank a card, when there are several cards; the whole smoke
            needs only one, so `--data-parallel` runs phases 1 and 15
            alone for a call on several).  Then the lockstep step (S = 4,
            RPN.MEGA_SA) split over [cuda:0, cuda:0] (and two cards when
            there are): float32 rows and states equal to the unsplit
            step's (tid, emit and integers exact, floats within 1e-4), K5
            3 launches a part a frame, and ms a lockstep frame split and
            unsplit (bfloat16).
16. remainder (a) the detection step at Config() and the joint step
            with RPN.MEGA_SA, each with LI_FUSION.FUSED_PYRAMID (the image
            pyramid sampled at the points, never made whole), bfloat16, 3
            frames with the launch counts set to 0 just before: phase 3's
            and 6's launches a frame and one fused pyramid forward a frame;
            then float32 with TF32 off, fused against materialized on the
            card with the same weights (backbone_features, rois, boxes,
            scores and the joint rows within 1e-3 of their scale; roi_mask,
            keep, tid and emit equal), and ms a frame both ways in turns
            (median, min and max of 6, wall clock and CUDA events) with the
            peak memory.  (b) the native point-cloud loader
            (jmodt_torch/native, g++) on phase 14's tree: built, one native
            load a frame read, pts_input and pts_xy within rtol 2e-4 / atol
            1e-3 of the numpy loader, and the loader's host ms a batch both
            ways.  (c) a Config() checkpoint through `python -m
            jmodt_torch.tools.export_torch_weights`, read back by
            `load_checkpoint`: every tensor and one detection frame
            bit-equal.  (d) `oracle_ap` and `recall_diagnosis` on phase 13's
            tree, its stage-1 detections and the oracle's jittered ones: the
            card's JSON equal to `--device cpu`'s (IoU floats within 1e-6).
            (e) `synthetic_ladder` at its smallest (3 frames, 2 sequences,
            an epoch a stage) prints its JSON line; its seconds printed.

Prints a {"kernels": [...]} line (launches from phase 6; per path from
phases 3, 6, 8, 13, 16 and per training step from 11, 12, 14 and 15;
per-call times and bounds; K1's largest placeable cluster, its cluster size at
each N and us a step at level 0; K2's plan, us a step and warp sweep per
call at S = 1 and 4; K3's plan and library
time per FP level; K5's FPS floor per level; K4's and K5's
tensor-core route, with bounds at the TF32 peak for the three products of
each multiply-add and, for reference, as float32 FMAs), the card's name
and power limit, and as its last line {"ok": true, "device": {...}}.  Needs
one card; without one it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
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
# phases 11-12: kernel launches of one training step.  B >= 2 clouds of at
# most 1024 points take K2, so RPN levels 2-3 run K2 beside RCNN sa_0-1
PER_STEP_FINETUNE = {'fps': 2, 'fps_batched': 4, 'three_nn': 4,
                     'grouped_gather_mlp_max': 6, 'sa_level': 0,
                     'depth_to_space': 4}
PER_STEP_FULL = {'fps': 2, 'fps_batched': 4, 'three_nn': 4,
                 'grouped_gather_mlp_max': 0, 'sa_level': 0,
                 'depth_to_space': 4}
K6_BACKWARD_FULL = 4
TRAIN_PAIRS = 4
TRAIN_STEPS = 3
IOU_EDGE = 1e-4         # phase 11 parity: RoIs this close to a threshold


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
                   npoint, warps, ppt, out.data_ptr(), device=xyz.device)
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


def detection_outputs(cfg32, frame, dev):
    """One float32 frame of the detection step on `dev` (weights from seed
    0), with the model forward's rpn_cls, rpn_reg and backbone_features."""
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.models.point_rcnn import build_detector
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
    return {k: v.cpu() for k, v in out.items()}


def parity(cfg32, frame):
    # fp32 on the card means fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu, cpu = (detection_outputs(cfg32, frame, dev)
                for dev in ('cuda', 'cpu'))
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
                   *plan.fps, out.data_ptr(), device=xyz.device)
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


# ------------------------------------------------------------ phases 11, 12

def train_cfg(finetune: bool, dtype: str, reid_fg_thresh=None):
    """Config() for the link / se finetune (the default, as tools/train.py
    builds it) or for full losses (its --finetune flag).  With random
    weights no RoI reaches REID.FG_THRESH, so the finetune loss and its
    gradient are 0; `reid_fg_thresh` 0 keeps every RoI's track id, so
    that the link / se terms have a gradient."""
    from jmodt_torch.config import Config
    cfg = Config()
    R = dataclasses.replace
    reid = (cfg.REID if reid_fg_thresh is None
            else R(cfg.REID, FG_THRESH=reid_fg_thresh))
    return R(cfg, DTYPE=dtype, RPN=R(cfg.RPN, FIXED=finetune), REID=reid,
             TRAIN=R(cfg.TRAIN, FINETUNE=finetune))


def trains(name: str) -> bool:
    """A parameter the finetune trains."""
    return 'link_layer' in name or 'se_layer' in name


def train_parts(cfg, device=None):
    """PointRCNN(mode='TRAIN') with detector weights from seed 0 and link /
    se weights from seed 1, its optimizer and its train step."""
    from torch import nn
    from jmodt_torch.models.point_rcnn import build_detector, init_weights
    from jmodt_torch.train.train_step import make_optimizer, make_train_step
    model = build_detector(cfg, mode='TRAIN', device=device, seed=0)
    init_weights(nn.ModuleList([model.rcnn.link_layer, model.rcnn.se_layer]),
                 1)
    opt = make_optimizer(cfg, model, steps_per_epoch=TRAIN_STEPS)
    return model, opt, make_train_step(cfg, model, opt, device=device)


def pair_batches(cfg, pairs, seeds, device=None):
    from jmodt_torch.data.synthetic import make_pair_batch
    from jmodt_torch.train.train_step import to_device
    out = [make_pair_batch(seed, cfg, num_pairs=pairs) for seed in seeds]
    if device is not None:
        out = [to_device(b, torch.device(device)) for b in out]
    return out


def check_counts(counts, per_step, what):
    for name, per in per_step.items():
        check(counts.get(name, 0) == per, f'{what}: {name} launched '
              f'{counts.get(name, 0)} times in a step, expected {per}')


def timed_step(step, batch, proposal_share=False):
    """(tb, CUDA-event ms, wall ms, ms inside proposal_layer or None) of one
    train step; with `proposal_share` the proposal layer is synchronized
    before and after, and its time summed."""
    import jmodt_torch.models.point_rcnn as point_rcnn
    inside = []
    orig = point_rcnn.proposal_layer

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*args)
        torch.cuda.synchronize()
        inside.append(time.perf_counter() - t)
        return out

    if proposal_share:
        point_rcnn.proposal_layer = timed
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        tb = step(batch)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        point_rcnn.proposal_layer = orig
    return (tb, start.elapsed_time(end), wall,
            sum(inside) * 1e3 if proposal_share else None)


def run_finetune(cfg):
    """Phase 11: TRAIN_STEPS finetune steps of TRAIN_PAIRS pairs, kernel
    inputs recorded on step 1 and held against the plain versions; the
    launch counts of the last step are returned."""
    from jmodt_torch.ops import kernels
    from jmodt_torch.train.train_step import scalars
    model, _, step = train_parts(cfg)
    batches = pair_batches(cfg, TRAIN_PAIRS, range(TRAIN_STEPS), 'cuda')
    ms, wall, losses = [], [], []
    agg = share = peak = counts = None
    for i, batch in enumerate(batches):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        kernels.launches.clear()
        if i == 0:
            recorded, tb = record_kernel_inputs(lambda: step(batch))
        else:
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            tb, ev_ms, wall_ms, prop_ms = timed_step(step, batch, i == 2)
            ms.append(ev_ms)
            wall.append(wall_ms)
            if prop_ms is not None:
                share = prop_ms / wall_ms
        counts = dict(kernels.launches)
        check_counts(counts, PER_STEP_FINETUNE, f'finetune step {i + 1}')
        vals = scalars(tb)
        check(all(np.isfinite(v) for v in vals.values()),
              f'finetune step {i + 1}: non-finite loss terms {vals}')
        check(vals['loss'] > 0 and vals['grad_norm'] > 0,
              f'finetune step {i + 1}: loss {vals["loss"]}, grad_norm '
              f'{vals["grad_norm"]}')
        for k, p in model.named_parameters():
            if trains(k) and k.endswith('weight'):
                check(p.grad is not None and bool(p.grad.any()),
                      f'finetune step {i + 1}: {k} has no gradient')
        losses.append(vals)
        after = model.state_dict()
        for k, v in before.items():
            if not trains(k):
                check(torch.equal(after[k], v), f'finetune step {i + 1}: '
                      f'frozen {k} changed')
            elif k.endswith('weight'):
                check(not torch.equal(after[k], v),
                      f'finetune step {i + 1}: {k} did not move')
        if i == 0:
            agg = check_kernels(recorded, {k: v for k, v in
                                           PER_STEP_FINETUNE.items() if v})
        if i == 1:
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return dict(ms=ms, wall=wall, share=share, peak_gib=peak,
                losses=losses, agg=agg, counts=counts)


def train_parity(cfg32):
    """Phase 11, second half: one float32 finetune step on 1 pair on the
    card and on the CPU with the same draws: loss terms, grad_norm and
    each link / se gradient within NET_TOL (the gradients of their own
    scale), RoI labels equal away from a threshold."""
    import jmodt_torch.models.point_rcnn as point_rcnn
    from jmodt_torch.train.train_step import scalars
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = pair_batches(cfg32, 1, (100,))[0]
    res = {}
    orig = point_rcnn.proposal_target_layer
    for dev in ('cuda', 'cpu'):
        model, _, step = train_parts(cfg32, device=dev)
        seen = []

        def spy(*args):
            seen.append(orig(*args))
            return seen[-1]

        point_rcnn.proposal_target_layer = spy
        try:
            tb = step(batch)
        finally:
            point_rcnn.proposal_target_layer = orig
        res[dev] = (scalars(tb), seen[0]._replace(
            **{f: getattr(seen[0], f).detach().cpu()
               for f in seen[0]._fields}),
            {k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
             for k, p in model.named_parameters() if trains(k)})
    (gtb, gt, ggrad), (ctb, ct, cgrad) = res['cuda'], res['cpu']
    errs = {k: abs(gtb[k] - v) / max(1.0, abs(v)) for k, v in ctb.items()
            if k != 'grad_norm'}
    errs['grad_norm'] = (abs(gtb['grad_norm'] - ctb['grad_norm'])
                         / max(abs(ctb['grad_norm']), 1e-30))
    for k, e in errs.items():
        check(e <= NET_TOL, f'train parity: {k} err {e} (card {gtb[k]}, '
              f'CPU {ctb[k]})')
    gerr = {}
    for k, want in cgrad.items():
        scale = float(want.abs().max())
        diff = float((ggrad[k] - want).abs().max())
        gerr[k] = diff / scale if scale else diff
        check(gerr[k] <= NET_TOL if scale else diff == 0, f'train parity: '
              f'{k} gradient err {diff} (scale {scale})')
    errs['link_se_grad'] = max(gerr.values())
    rc = cfg32.RCNN
    thresholds = torch.tensor([rc.REG_FG_THRESH, rc.CLS_FG_THRESH,
                               rc.CLS_BG_THRESH])
    edge = ((ct.gt_iou[:, None] - thresholds).abs() < IOU_EDGE).any(1)
    differ = ((gt.cls_label != ct.cls_label)
              | (gt.reg_valid_mask != ct.reg_valid_mask))
    check(not bool((differ & ~edge).any()), 'train parity: cls_label / '
          f'reg_valid_mask differ at RoIs {torch.nonzero(differ & ~edge)}')
    near = [(int(i), float(ct.gt_iou[i]), float(gt.gt_iou[i]))
            for i in torch.nonzero(edge).flatten()]
    return errs, (gtb['grad_norm'], ctb['grad_norm']), near, int(
        differ.sum())


def run_full(cfg):
    """Phase 12: full-losses steps on 1 pair; launches, gradients, one
    BatchNorm layer's statistics, ms a step."""
    from jmodt_torch.ops import depth_to_space as d2s
    from jmodt_torch.ops import kernels
    from jmodt_torch.train.train_step import scalars
    model, _, step = train_parts(cfg)
    batches = pair_batches(cfg, 1, (200, 201), 'cuda')
    bn = model.rpn.backbone.fp_0.PointwiseMLP_0.PointwiseLayer_0.BatchNorm_0
    seen = []
    hook = bn.register_forward_hook(
        lambda m, i, o: seen.append(i[0].detach().clone()))
    old = (bn.running_mean.clone().double(), bn.running_var.clone().double())
    backward = d2s.DepthToSpace.backward
    k6_back = []

    def counted(ctx, grad):
        k6_back.append(1)
        return backward(ctx, grad)

    d2s.DepthToSpace.backward = staticmethod(counted)
    kernels.launches.clear()
    try:
        tb = step(batches[0])
        torch.cuda.synchronize()
    finally:
        d2s.DepthToSpace.backward = backward
        hook.remove()
    counts = dict(kernels.launches)
    check_counts(counts, PER_STEP_FULL, 'full-losses step')
    check(len(k6_back) == K6_BACKWARD_FULL,
          f'full-losses step: K6 backward ran {len(k6_back)} times')
    vals = scalars(tb)
    check(all(np.isfinite(v) for v in vals.values()),
          f'full-losses step: non-finite loss terms {vals}')
    n_params = 0
    for name, p in model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f'full-losses step: no finite gradient for {name}')
        n_params += 1
    # flax's rule: float32 statistics over every leading axis, the biased
    # one-pass variance clipped at 0, running = 0.9 old + 0.1 batch
    check(len(seen) == 1, f'full-losses step: the BatchNorm ran {len(seen)} '
          'times')
    x = seen[0].double().reshape(-1, seen[0].shape[-1])
    mean = x.mean(0)
    var = ((x * x).mean(0) - mean * mean).clamp_min(0)
    bn_err = (scale_err(bn.running_mean, 0.9 * old[0] + 0.1 * mean),
              scale_err(bn.running_var, 0.9 * old[1] + 0.1 * var))
    check(max(bn_err) <= 1e-5, f'full-losses step: BatchNorm statistics err '
          f'{bn_err}')
    kernels.launches.clear()
    tb2, ev_ms, wall_ms, _ = timed_step(step, batches[1])
    check_counts(dict(kernels.launches), PER_STEP_FULL, 'full-losses step 2')
    return dict(counts=counts, k6_backward=len(k6_back), params=n_params,
                bn_err=bn_err, ms=ev_ms, wall=wall_ms,
                losses=[vals, scalars(tb2)])


# ----------------------------------------------------------------- phase 13

EVAL_SEQS = ('0000', '0002')        # two validation sequences
EVAL_FRAMES = 3                     # frames a sequence
EVAL_IMG_HW = (375, 1242)           # KITTI's camera image
EVAL_SWEEP = 24000                  # lidar points a sweep, ~20.6k in view
EVAL_MODES = {'mip': [], 'hungarian': ['--hungarian'],
              'device_tracker': ['--device_tracker'],
              'batch_seqs': ['--batch_seqs']}
IOU_EVAL_TOL = 1e-6


def eval_tree(root, cfg):
    """A raw KITTI tracking tree under root/tracking (synthetic scenes, a
    pinhole calibration with focal 2 h), converted into
    root/tracking_object."""
    from jmodt_torch.data.converter import create_train_sample_data
    from jmodt_torch.data.synthetic import write_synthetic_kitti_tree
    write_synthetic_kitti_tree(f'{root}/tracking', cfg,
                               seq_ids=EVAL_SEQS, n_frames=EVAL_FRAMES,
                               img_hw=EVAL_IMG_HW, npoints=EVAL_SWEEP, seed=0)
    create_train_sample_data(f'{root}/tracking', f'{root}/tracking_object')


def eval_checkpoint(cfg, path):
    """A port .pth: detector weights from seed 0, link / se from seed 1."""
    from torch import nn
    from jmodt_torch.models.point_rcnn import build_detector, init_weights
    from jmodt_torch.train.checkpoint import checkpoint_state, save_checkpoint
    model = build_detector(cfg, device='cpu', seed=0)
    init_weights(nn.ModuleList([model.rcnn.link_layer, model.rcnn.se_layer]),
                 1)
    return save_checkpoint(checkpoint_state(model), path)


def perfect_detections(root, det, feat_dim):
    """The converted gt boxes as stage-1 files (score 0.95), with a
    feature a track id plus noise."""
    import os
    from jmodt_torch.utils.object3d import get_objects_from_label
    rng = np.random.RandomState(0)
    ids = rng.randn(64, feat_dim).astype(np.float32)
    labels = f'{root}/tracking_object/training/label_2'
    for sub in ('txt', 'feat'):
        os.makedirs(f'{det}/{sub}')
    for name in sorted(os.listdir(labels)):
        objs = [o for o in get_objects_from_label(f'{labels}/{name}')
                if o.cls_type == 'Car']
        with open(f'{det}/txt/{name}', 'w') as f:
            for o in objs:
                f.write('Car -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
                        '%.4f %.4f %.4f %.4f 0.95\n' % (
                            o.alpha, *o.box2d, o.h, o.w, o.l, *o.pos, o.ry))
        np.save(f'{det}/feat/{name[:-4]}.npy', np.asarray(
            [ids[int(o.score)] + 0.01 * rng.randn(feat_dim) for o in objs],
            np.float32).reshape(-1, feat_dim))


def recount_recall(outs, batches):
    """The (11,) recall counters recomputed on the CPU from the step's
    outputs: [recalled(5), roi_recalled(5), n_gt]."""
    from jmodt_torch.models.inference import RECALL_THRESH
    from jmodt_torch.ops.rotated_iou import boxes_iou3d
    acc = np.zeros(11, np.int64)
    for out, data in zip(outs, batches):
        gt = torch.as_tensor(data['gt_boxes3d'][0][:32], dtype=torch.float32)
        gt = gt[gt.abs().sum(1) > 0]
        mask = out['roi_mask'][0].cpu()
        for col, boxes in ((0, out['pred_boxes_all'][0]),
                           (5, out['rois'][0])):
            iou = boxes_iou3d(boxes.cpu(), gt)[mask]
            best = (iou.amax(0) if len(iou) else torch.zeros(len(gt)))
            for i, th in enumerate(RECALL_THRESH):
                acc[col + i] += int((best > th).sum())
        acc[10] += len(gt)
    return acc


def same_files(a, b):
    import filecmp
    import os
    names = sorted(os.listdir(a))
    check(names == sorted(os.listdir(b)), f'{a} and {b} hold other files')
    _, diff, err = filecmp.cmpfiles(a, b, names, shallow=False)
    return not diff and not err


def eval_entry(tmp):
    """Phase 13: `python -m jmodt_torch.eval`'s stages on a KITTI-format
    tree, through the module's functions, on the card at Config()."""
    import logging
    import os
    from jmodt_torch.config import Config
    from jmodt_torch.eval import __main__ as ev
    from jmodt_torch.eval import clear_mot, detection_ap
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.ops import kernels
    log = logging.getLogger('chip_smoke.eval')
    log.addHandler(logging.NullHandler())
    log.propagate = False
    cfg = Config()
    eval_tree(f'{tmp}/KITTI', cfg)
    pth = eval_checkpoint(cfg, f'{tmp}/model')

    def args(out, *flags):
        return ev.build_parser().parse_args(
            ['--data_root', f'{tmp}/KITTI', '--det_output', f'{out}/det',
             '--output_dir', out, '--ckpt', pth, *flags])

    # stage 1: keep each frame's (sample id, batch, calibration, image
    # shape), the step's outputs and the running launch counts (no host
    # read is added to the frame)
    items, outs, per_frame, models, step_ms = [], [], [], [], []
    frames_of, make_step = ev.detection_frames, ev.make_detection_step

    def detection_frames(*a):
        ids, frames, dataset = frames_of(*a)

        def kept():
            for item in frames():
                items.append(item)
                yield item
        return ids, kept, dataset

    def recording_step(cfg_, model, device=None):
        models.append(model)
        step = make_step(cfg_, model, device=device)

        def run(*x):
            t = time.perf_counter()
            out = step(*x)
            torch.cuda.synchronize()   # the CLI's read of `packed` waits
            step_ms.append((time.perf_counter() - t) * 1e3)
            outs.append(out)
            per_frame.append(dict(kernels.launches))
            return out
        return run

    ev.detection_frames, ev.make_detection_step = (detection_frames,
                                                   recording_step)
    try:
        kernels.launches.clear()
        res = ev.eval_joint_detection(args(f'{tmp}/eval'), cfg, log)
    finally:
        ev.detection_frames, ev.make_detection_step = frames_of, make_step
    n = len(EVAL_SEQS) * EVAL_FRAMES
    check(res['frames'] == n == len(outs), f'eval: {res["frames"]} frames')
    for i, seen in enumerate(per_frame):
        for name in PER_FRAME_JOINT:
            want = PER_FRAME.get(name, 0) * (i + 1)
            check(seen.get(name, 0) == want, f'eval: {name} launched '
                  f'{seen.get(name, 0)} times in {i + 1} frames, expected '
                  f'{want}')
    eval_frame = {k: v // n for k, v in per_frame[-1].items()}

    # every kernel call of one frame against its plain version
    batches = [item[1] for item in items]
    step = make_detection_step(cfg, models[0])
    b0 = batches[0]
    recorded, _ = record_kernel_inputs(
        lambda: step(b0['pts_input'], b0['img'], b0['pts_xy']))
    check_kernels(recorded, PER_FRAME, timed=False)

    # the files of a direct detection-step run on the same batches
    direct = f'{tmp}/direct'
    for sub in ('txt', 'feat'):
        os.makedirs(f'{direct}/{sub}')
    for sid, data, calib, shape in items:
        packed = step(data['pts_input'], data['img'],
                      data['pts_xy'])['packed'][0].cpu().numpy()
        ev.write_detections(sid, packed, calib, shape, f'{direct}/txt',
                            f'{direct}/feat', cfg.CLASSES)
    for sub in ('txt', 'feat'):
        check(same_files(f'{tmp}/eval/det/{sub}', f'{direct}/{sub}'),
              f'eval: stage-1 {sub} files differ from a direct step run')
    recount = recount_recall(outs, batches)
    check(np.array_equal(res['recall'], recount),
          f'eval: recall {res["recall"].tolist()} != {recount.tolist()}')
    check(res['recall'][10] > 0, 'eval: no gt boxes counted')
    ap = res['ap']
    check(all(np.isfinite(v) for v in ap.values()), f'eval: AP {ap}')

    # the AP's rotated overlaps on the card against the CPU
    label_dir = f'{tmp}/KITTI/tracking_object/training/label_2'
    gt = detection_ap.get_label_annos(label_dir, list(range(n)))
    dt = detection_ap.get_label_annos(f'{tmp}/eval/det/txt')
    gb, db = (detection_ap._boxes_for_metric(a, 1) for a in (gt, dt))
    iou_err = 0.0
    for crit in (-1, 0, 1, 2):
        card = detection_ap.rotate_iou_eval(gb, db, crit, device='cuda')
        cpu = detection_ap.rotate_iou_eval(gb, db, crit, device='cpu')
        iou_err = max(iou_err, float(np.abs(card - cpu).max()
                                     / max(1.0, np.abs(cpu).max())))
    check(iou_err <= IOU_EVAL_TOL, f'eval: rotate_iou_eval card vs CPU '
          f'{iou_err}')
    _, ap_cpu = detection_ap.evaluate_detections(
        label_dir, f'{tmp}/eval/det/txt', list(range(n)), device='cpu')
    check(ap_cpu == ap, f'eval: AP on the CPU {ap_cpu} != card {ap}')

    # stage 2 on perfect detections, in every mode
    det = f'{tmp}/perfect'
    perfect_detections(f'{tmp}/KITTI', det, cfg.RCNN.SA_CONFIG.MLPS[-1][-1])
    gt_path = f'{tmp}/KITTI/tracking/training'
    fps, texts = {}, {}
    for mode, flags in EVAL_MODES.items():
        fps[mode] = []
        for run in ('cold', 'warm'):     # the same tracking, twice
            out = f'{tmp}/track_{mode}_{run}'
            a = args(out, '--only_tracking', *flags)
            a.det_output = det
            r = ev.eval_tracking(a, cfg, log)
            e = clear_mot.TrackingEvaluation(
                t_sha=a.tag, result_root=out, part='val', gt_path=gt_path,
                seqmap=ev._seqmap_from_gt(gt_path))
            check(e.load_tracker(log) and e.load_groundtruth(log)
                  and e.compute_metrics(log),
                  f'eval {mode}: CLEAR-MOT failed')
            check(abs(e.MOTA - 1.0) < 1e-9 and e.id_switches == 0
                  and r['mota'] == e.MOTA, f'eval {mode}: MOTA {e.MOTA}, '
                  f'{e.id_switches} id switches')
            check(r['frames'] == n, f'eval {mode}: {r["frames"]} frames')
            fps[mode].append(r['frames'] / r['seconds'])
            text = [open(f'{r["result_dir"]}/{s}.txt').read()
                    for s in EVAL_SEQS]
            check(texts.setdefault(mode, text) == text,
                  f'eval {mode}: a second run tracked otherwise')
    check(texts['batch_seqs'] == texts['device_tracker'],
          'eval: --batch_seqs tracks differ from --device_tracker')
    return dict(eval_frame=eval_frame, ms=res['ms_per_frame'],
                step_ms=step_ms,
                ap_s=res['ap_seconds'], ap=ap, recall=res['recall'].tolist(),
                iou_err=iou_err, fps=fps, n=n)

# ----------------------------------------------------------------- phase 14

# a raw tracking tree at KITTI's sizes: the training sequence's 13 frames
# give 12 pairs (3 steps of TRAIN_PAIRS), a validation sequence is
# tracked by the sweep, and small_val (0019) holds the 1 pair of the
# full-losses step
KITTI_TRAIN_SEQS = (('0001', 13, 2), ('0000', 3, 3), ('0019', 2, 4))
KITTI_TRAIN_STEPS = 3
TRAIN_IMG_HW = (384, 1280)           # the training CLI's image at Config()
SWEEP_GRID = {'cls_thresh': [0.5, 0.97], 't_miss': [2, 4], 't_hit': [0]}
PERFECT_SCORE = 0.95                 # perfect_detections' score
PNG_REPS = 3


def kitti_train_tree(root, cfg):
    """root/tracking (the sequences above, 375x1242 PNGs, 24000-point
    sweeps) converted into root/tracking_object."""
    from jmodt_torch.data.converter import create_train_sample_data
    from jmodt_torch.data.synthetic import write_synthetic_kitti_tree
    for seq, n, seed in KITTI_TRAIN_SEQS:
        write_synthetic_kitti_tree(f'{root}/tracking', cfg, seq_ids=(seq,),
                                   n_frames=n, img_hw=EVAL_IMG_HW,
                                   npoints=EVAL_SWEEP, seed=seed)
    create_train_sample_data(f'{root}/tracking', f'{root}/tracking_object')


def recording_train_steps(rec, kernel_inputs=False):
    """A stand-in for `trainer.make_train_step` whose steps run the real
    step with the launch counts set to 0 just before, time it (CUDA events
    and the wall clock, synchronized), read its launches, its loss terms
    and its link / se gradients, and keep the model, the optimizer's count
    before step 1, a copy of the parameters step 1 must not move and step
    1's batch; with `kernel_inputs` step 1 also records every kernel
    wrapper's inputs."""
    from jmodt_torch.ops import kernels
    from jmodt_torch.train import trainer
    from jmodt_torch.train.train_step import scalars
    make = trainer.make_train_step

    def factory(cfg, model, optimizer, seed=0, device=None):
        step = make(cfg, model, optimizer, seed, device)
        rec.update(model=model, start=optimizer.count, steps=[])

        def run(batch):
            first = not rec['steps']
            if first:
                rec['frozen'] = {k: v.clone() for k, v in
                                 model.state_dict().items() if not trains(k)}
                rec['batch'] = {k: v.cpu() for k, v in batch.items()}
            if len(rec['steps']) == 1:
                torch.cuda.reset_peak_memory_stats()
            kernels.launches.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            if first and kernel_inputs:
                rec['recorded'], tb = record_kernel_inputs(lambda: step(batch))
            else:
                tb = step(batch)
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            vals = scalars(tb)
            grads = {k: p.grad for k, p in model.named_parameters()
                     if trains(k) and k.endswith('weight')}
            rec['steps'].append(dict(
                counts=dict(kernels.launches), ms=start.elapsed_time(end),
                wall=wall, vals=vals, peak_gib=(
                    torch.cuda.max_memory_allocated() / 2 ** 30),
                grads_ok=all(g is not None and bool(g.any())
                             and bool(torch.isfinite(g).all())
                             for g in grads.values()),
                all_grads_finite=all(
                    p.grad is not None and bool(torch.isfinite(p.grad).all())
                    for p in model.parameters())))
            return tb
        return run
    return factory


def train_main(argv, factory):
    """`python -m jmodt_torch.train` in this process with `factory` as the
    trainer's make_train_step; the root logger's file handler that it
    adds is closed after."""
    import logging
    from jmodt_torch.train import __main__ as train_cli
    from jmodt_torch.train import trainer
    make = trainer.make_train_step
    trainer.make_train_step = factory
    try:
        train_cli.main(argv)
    finally:
        trainer.make_train_step = make
        root = logging.getLogger()
        for h in list(root.handlers):
            if isinstance(h, logging.FileHandler):
                root.removeHandler(h)
                h.close()


def loader_ms(dataset, workers):
    """(host ms to the first batch, ms a batch after it) of one epoch of
    `make_loader(dataset, TRAIN_PAIRS, num_workers=workers)`."""
    from jmodt_torch.train.trainer import make_loader
    t0 = time.perf_counter()
    times = []
    for _ in make_loader(dataset, TRAIN_PAIRS, num_workers=workers)():
        times.append(time.perf_counter())
    check(len(times) == KITTI_TRAIN_STEPS, f'loader at {workers} workers: '
          f'{len(times)} batches')
    return ((times[0] - t0) * 1e3,
            (times[-1] - times[0]) * 1e3 / max(len(times) - 1, 1))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_filtered_png(path, img):
    """An RGB PNG whose row r uses filter r % 5 (None, Sub, Up, Average,
    Paeth), as an adaptive encoder mixes them."""
    import struct
    import zlib
    h, w, c = img.shape
    x = img.astype(np.int32).reshape(h, w * c)
    up = np.vstack([np.zeros((1, w * c), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, c), np.int32), x[:, :-c]])
    ul = np.hstack([np.zeros((h, c), np.int32), up[:, :-c]])
    preds = [np.zeros_like(x), left, up, (left + up) >> 1,
             _paeth(left, up, ul)]
    ftype = np.arange(h) % 5
    rows = np.stack([(x[r] - preds[ftype[r]][r]) & 255 for r in range(h)])
    raw = np.hstack([ftype[:, None], rows]).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(raw, 6)) + chunk(b'IEND', b''))


def png_read_ms(tmp, src):
    """(ms to read `src`, a filter-0 PNG, ms to read the same image with
    all five filters) with `utils/png.py`, the best of PNG_REPS; the
    filtered file must decode to the same pixels."""
    from jmodt_torch.utils.png import read_png_rgb
    img = read_png_rgb(src)
    path = f'{tmp}/filtered.png'
    write_filtered_png(path, img)
    check(np.array_equal(read_png_rgb(path), img),
          'png: the filtered PNG decodes to other pixels')
    out = []
    for f in (src, path):
        ts = []
        for _ in range(PNG_REPS):
            t0 = time.perf_counter()
            read_png_rgb(f)
            ts.append((time.perf_counter() - t0) * 1e3)
        out.append(min(ts))
    return out


def check_train_steps(rec, n, per_step, what):
    check(len(rec['steps']) == n, f'{what}: {len(rec["steps"])} steps, '
          f'expected {n}')
    for i, s in enumerate(rec['steps']):
        check_counts(s['counts'], per_step, f'{what} step {i + 1}')
        check(all(np.isfinite(v) for v in s['vals'].values()),
              f'{what} step {i + 1}: non-finite loss terms {s["vals"]}')


def kitti_train(tmp):
    """Phase 14: `python -m jmodt_torch.train --data_root` at Config()
    (finetune from KITTI files, a resume, one full-losses step), the
    loader's and the PNG reader's host cost, and the MOT sweep."""
    import os
    from jmodt_torch.config import Config
    from jmodt_torch.data.kitti_dataset import KittiDataset
    from jmodt_torch.eval import __main__ as ev
    from jmodt_torch.eval import mot_sweep
    from jmodt_torch.models.point_rcnn import build_detector
    from jmodt_torch.ops import depth_to_space as d2s
    from jmodt_torch.train.checkpoint import load_checkpoint
    from jmodt_torch.train.train_step import BATCH_KEYS
    root = f'{tmp}/KITTI'
    t0 = time.perf_counter()
    kitti_train_tree(root, Config())
    tree_s = time.perf_counter() - t0
    # what the CLI builds from these overrides
    overrides = ['REID.FG_THRESH', '0.0']
    cfg = train_cfg(True, Config().DTYPE, reid_fg_thresh=0.0)

    # finetune from KITTI files: 3 steps of 4 pairs, 2 loader processes,
    # the checkpoint written in the background
    rec = {}
    t0 = time.perf_counter()
    train_main(['--data_root', root, '--batch_size', str(TRAIN_PAIRS),
                '--workers', '2', '--epochs', '1', '--async_ckpt',
                '--output_dir', f'{tmp}/ft', '--set', *overrides],
               recording_train_steps(rec, kernel_inputs=True))
    run_s = time.perf_counter() - t0
    check_train_steps(rec, KITTI_TRAIN_STEPS, PER_STEP_FINETUNE,
                      'kitti finetune')
    for i, s in enumerate(rec['steps']):
        check(s['vals']['loss'] > 0 and s['vals']['grad_norm'] > 0
              and s['grads_ok'], f'kitti finetune step {i + 1}: loss '
              f'{s["vals"]["loss"]}, a link / se weight gradient 0 or '
              'not finite')
    model = rec['model']
    after = model.state_dict()
    for k, v in rec['frozen'].items():
        check(torch.equal(after[k], v), f'kitti finetune: frozen {k} changed')
    print('[14 kitti] kernel calls of training step 1 from KITTI files vs '
          'plain version:', flush=True)
    check_kernels(rec['recorded'], {k: v for k, v in
                                    PER_STEP_FINETUNE.items() if v},
                  timed=False)
    del rec['recorded']
    ckpt = f'{tmp}/ft/ckpt/checkpoint_epoch_1.pth'
    fresh = build_detector(cfg, mode='TRAIN', seed=7)
    check(load_checkpoint(ckpt, fresh) == (KITTI_TRAIN_STEPS, 1),
          'kitti finetune: checkpoint epoch / it')
    saved = fresh.state_dict()
    check(all(torch.equal(saved[k], v) for k, v in after.items()),
          'kitti finetune: the async checkpoint differs from the model')
    steps = rec['steps']
    del fresh, saved, model, after, rec

    # resume from it at 0 loader processes: epoch 2 from iteration 3, its
    # first batch the dataset's own collate of the seed's first pairs
    rec2 = {}
    train_main(['--data_root', root, '--batch_size', str(TRAIN_PAIRS),
                '--workers', '0', '--epochs', '2', '--ckpt', ckpt,
                '--output_dir', f'{tmp}/resume', '--set', *overrides,
                'TRAIN.RELOAD_OPTIMIZER', 'True'],
               recording_train_steps(rec2))
    check_train_steps(rec2, KITTI_TRAIN_STEPS, PER_STEP_FINETUNE,
                      'kitti resume')
    check(rec2['start'] == KITTI_TRAIN_STEPS, f'kitti resume: started at '
          f'iteration {rec2["start"]}')
    state = torch.load(f'{tmp}/resume/ckpt/checkpoint_epoch_2.pth',
                       map_location='cpu', weights_only=True)
    check(state['epoch'] == 2 and state['it'] == 2 * KITTI_TRAIN_STEPS,
          f'kitti resume: saved epoch {state["epoch"]} it {state["it"]}')
    dataset = KittiDataset(root, npoints=cfg.RPN.NUM_POINTS, split='train',
                           mode='TRAIN', cfg=cfg,
                           fixed_img_size=TRAIN_IMG_HW)
    order = np.arange(len(dataset))
    np.random.RandomState(0).shuffle(order)
    direct = dataset.collate_batch([dataset[j]
                                    for j in order[:TRAIN_PAIRS]])
    keys = [k for k in BATCH_KEYS if k in direct]
    check(sorted(keys) == sorted(rec2['batch']) and all(
        torch.equal(rec2['batch'][k], torch.from_numpy(direct[k]))
        for k in keys), 'kitti resume: the first batch differs from the '
          "dataset's collate")
    del rec2, state

    # one full-losses step on the small_val pair
    rec3 = {}
    backward = d2s.DepthToSpace.backward
    k6_back = []

    def counted(ctx, grad):
        k6_back.append(1)
        return backward(ctx, grad)

    d2s.DepthToSpace.backward = staticmethod(counted)
    try:
        train_main(['--data_root', root, '--finetune', '--batch_size', '1',
                    '--workers', '0', '--epochs', '1', '--output_dir',
                    f'{tmp}/full', '--set', 'TRAIN.SPLIT', 'small_val'],
                   recording_train_steps(rec3))
    finally:
        d2s.DepthToSpace.backward = backward
    check_train_steps(rec3, 1, PER_STEP_FULL, 'kitti full losses')
    check(len(k6_back) == K6_BACKWARD_FULL and rec3['steps'][0][
        'all_grads_finite'], f'kitti full losses: K6 backward '
          f'{len(k6_back)} times, or a gradient missing or not finite')
    full = rec3['steps'][0]
    del rec3

    # the loader's host cost a batch, in this process and in 2 workers
    loader = {w: loader_ms(dataset, w) for w in (0, 2)}
    png = png_read_ms(tmp, f'{root}/tracking_object/training/image_2/'
                      '000000.png')

    # the MOT sweep over perfect detections, then the eval CLI with the
    # best config's flags
    det = f'{tmp}/perfect'
    perfect_detections(root, det, cfg.RCNN.SA_CONFIG.MLPS[-1][-1])
    pth = eval_checkpoint(Config(), f'{tmp}/heads')
    t0 = time.perf_counter()
    summary = mot_sweep.main(['--det_output', det, '--data_root', root,
                              '--ckpt', pth, '--output_dir', f'{tmp}/sweep',
                              '--grid', json.dumps(SWEEP_GRID)])
    sweep_s = time.perf_counter() - t0
    results = summary['results']
    check(len(results) == 4, f'sweep: {len(results)} configs')
    for r in results:
        if r['cls_thresh'] < PERFECT_SCORE:
            check(r['mota'] == 1.0, f'sweep: MOTA {r["mota"]} at {r}')
    best = summary['best']
    check(best is not None and best['cls_thresh'] < PERFECT_SCORE,
          f'sweep: best {best}')
    ev.main(['--data_root', root, '--det_output', det, '--output_dir',
             f'{tmp}/best', '--ckpt', pth, '--only_tracking']
            + [f'--{k}={best[k]}' for k in SWEEP_GRID])
    a, b = f'{tmp}/sweep/{best["tag"]}/val', f'{tmp}/best/mot_data/val'
    names = sorted(n for n in os.listdir(a) if n.endswith('.txt'))
    check(names == sorted(n for n in os.listdir(b) if n.endswith('.txt'))
          and all(open(f'{a}/{n}').read() == open(f'{b}/{n}').read()
                  for n in names) and any(os.path.getsize(f'{a}/{n}')
                                          for n in names),
          'sweep: the best config tracks otherwise than the eval CLI')
    return dict(steps=steps, full=full, k6_back=len(k6_back), loader=loader,
                png=png, results=results, best=best, tree_s=tree_s,
                run_s=run_s, sweep_s=sweep_s, pairs=len(dataset))


# ----------------------------------------------------------------- phase 15

DP_RANKS = 2
DP_TOL = 1e-5           # loss terms, parameters and BatchNorm statistics
# a gradient element at most this share of the largest is float32 noise:
# Adam's first step moves it by up to a learning rate along the noise's
# sign, so its value after the step is no function of the step's inputs
DP_NOISE = 1e-6
# a gradient's scale floored at this share of the largest, as
# tests/test_torch_train_step.py floors it: a float32 backward resolves a
# gradient only to about float32's epsilon of the largest
DP_GRAD_FLOOR = 1e-2
# flipped-sign gradient elements a leaf may hold, as a share of its size
DP_FLIP_SHARE = 1e-3
# full losses: the ranks' parameters within this many times the one-ulp
# run's gap
DP_ULP_PARAMS = 2.0
DP_TIMING_STEPS = 3
DP_FULL_PAIRS = 2
SPLIT_TOL = 1e-4
SPLIT_FRAMES = 3


def train_state(cfg):
    """The phase 11 weights (detector seed 0, link / se seed 1) on the
    host."""
    model, _, _ = train_parts(cfg)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def dp_gaps(ref, got):
    """How far run `got` lies from run `ref` after one step: the largest
    loss-term error, parameter error and BatchNorm-statistic error of
    scale (max(1, |ref|)), the gradient error of its own scale (floored at
    DP_GRAD_FLOOR of the largest), and the parameter elements left out of
    the parameter error: those whose gradient is float32 noise (DP_NOISE of
    the largest; counted in 'noise') or has opposite signs in the two runs
    (counted by leaf in 'flips').  Adam's first step moves an element by
    about one learning rate along its gradient's sign whatever its size,
    so a sign that rounding decides is no function of the step."""
    gaps = {'terms': 0.0, 'grads': 0.0, 'params': 0.0, 'stats': 0.0,
            'noise': 0, 'flips': {}, 'sizes': {}, 'worst_params': None,
            'worst_stats': None, 'worst_grads': None}
    for k, v in ref['steps'][-1]['tb'].items():
        gaps['terms'] = max(gaps['terms'], abs(got['steps'][-1]['tb'][k] - v)
                            / max(1.0, abs(v)))
    grads = {k: g for k, g in ref['grads'].items() if g is not None}
    top = max(float(g.abs().max()) for g in grads.values())
    skip = {}
    for k, want in grads.items():
        g = got['grads'][k]
        check(g is not None, f'{k} has a gradient in one run only')
        scale = max(float(want.abs().max()), DP_GRAD_FLOOR * top)
        e = float((g - want).abs().max()) / scale
        if e > gaps['grads']:
            gaps['grads'], gaps['worst_grads'] = e, k
        noise = want.abs() <= DP_NOISE * top
        flips = (torch.sign(g) != torch.sign(want)) & ~noise
        skip[k] = noise | flips
        gaps['noise'] += int(noise.sum())
        gaps['flips'][k] = int(flips.sum())
        gaps['sizes'][k] = want.numel()
    for k, want in ref['state'].items():
        diff = (got['state'][k].double() - want.double()).abs()
        if k in skip:
            diff = torch.where(skip[k], torch.zeros_like(diff), diff)
        part = 'stats' if 'running' in k else 'params'
        e = float(diff.max()) / max(1.0, float(want.abs().max()))
        if e > gaps[part]:
            gaps[part], gaps['worst_' + part] = e, k
    return gaps


def flip_cap(gaps, ulp, finetune):
    """{leaf: the most flipped-sign elements allowed}: DP_FLIP_SHARE of the
    leaf (at least 1); under full losses, or as many as the one-ulp run
    flips there when that is more."""
    return {k: max(1, math.ceil(DP_FLIP_SHARE * n),
                   0 if finetune else ulp['flips'][k])
            for k, n in gaps['sizes'].items()}


def print_compare(what, backend, pairs, gaps, ulp, launches, coll):
    """One phase 15 comparison's line, printed before its gates."""
    bound = ('within 1e-5' if what == 'finetune' else
             'the RPN\'s within 1e-5, all within the one-ulp gap')
    pbound = ('1e-5' if what == 'finetune' else
              f'{DP_ULP_PARAMS:g}x the one-ulp gap')
    flips = sorted(((n, k) for k, n in gaps['flips'].items() if n),
                   reverse=True)
    print(f'[15 data parallel] float32 (TF32 off) {what}, {pairs} pairs,'
          f' {DP_RANKS} ranks over {backend} vs one process (in '
          'brackets: one process vs itself on the points moved by one '
          f'ulp): loss terms ({bound}) err {gaps["terms"]:.3g} '
          f'({ulp["terms"]:.3g}), parameters (within {pbound}) '
          f'{gaps["params"]:.3g} ({ulp["params"]:.3g}; {gaps["noise"]} '
          f'and {ulp["noise"]} elements of noise aside, and '
          f'{sum(gaps["flips"].values())} and '
          f'{sum(ulp["flips"].values())} of flipped-sign gradients, '
          f'capped by leaf; most flipped: '
          + ', '.join(f'{k} {n} of {gaps["sizes"][k]}'
                      for n, k in flips[:3])
          + f'), BatchNorm statistics (within 1e-5) {gaps["stats"]:.3g} '
          f'({ulp["stats"]:.3g}), gradients (within the one-ulp gap) '
          f'{gaps["grads"]:.3g} ({ulp["grads"]:.3g}; worst '
          f'{gaps["worst_grads"]}) of their scale; ranks bit-equal; '
          f'launches a rank {launches} equal to one process\'s; {coll} '
          'collectives a rank', flush=True)


def dp_compare(one, ulp, ranks, finetune, what, backend, pairs):
    """Phase 15's gates for the ranks against the one-process run `one`:
    the kernels not rebuilt, every step's launches equal, the ranks'
    states bit-equal, BatchNorm statistics within DP_TOL of scale, the
    gradients no further from one process's than the one process's own on
    the batch's points moved by one float32 ulp (`ulp`), and no leaf with
    more flipped-sign gradient elements than `flip_cap`.  For the finetune
    every loss term and parameter within DP_TOL of scale.  Under full
    losses the RPN's terms within DP_TOL; with random weights the step is
    discontinuous at float32's resolution there (its proposals tie within
    rounding, so the RoIs sampled from them and the RCNN after them move
    with any rounding), so every loss term is held to the one-ulp run's
    gap and the parameters to DP_ULP_PARAMS times it.  Returns (the ranks'
    gaps, the one-ulp gaps)."""
    tag = f'{what} over {backend}'
    for r in ranks:
        check(r['build_s'] == 0.0, f'{tag}: rank {r["rank"]} built the '
              f'kernels ({r["build_s"]:.1f} s)')
        for i, (a, b) in enumerate(zip(one['steps'], r['steps'])):
            check(a['launches'] == b['launches'], f'{tag}: rank '
                  f'{r["rank"]} step {i + 1} launched {b["launches"]}, one '
                  f'process {a["launches"]}')
        for k, v in ranks[0]['state'].items():
            check(torch.equal(v, r['state'][k]), f'{tag}: {k} differs '
                  f'between ranks 0 and {r["rank"]}')
    gaps, self_gaps = dp_gaps(one, ranks[0]), dp_gaps(one, ulp)
    print_compare(what, backend, pairs, gaps, self_gaps,
                  one['steps'][0]['launches'],
                  ranks[0]['steps'][0]['collectives'])
    check(gaps['stats'] <= DP_TOL, f'{tag}: BatchNorm statistics err '
          f'{gaps["stats"]} ({gaps["worst_stats"]})')
    check(gaps['grads'] <= self_gaps['grads'], f'{tag}: gradients err '
          f'{gaps["grads"]} ({gaps["worst_grads"]}), one ulp '
          f'{self_gaps["grads"]}')
    cap = flip_cap(gaps, self_gaps, finetune)
    over = {k: (n, cap[k]) for k, n in gaps['flips'].items() if n > cap[k]}
    check(not over, f'{tag}: flipped-sign gradient elements over their cap '
          f'(flipped, cap) {over}')
    want, got = one['steps'][-1]['tb'], ranks[0]['steps'][-1]['tb']
    for k, v in want.items():
        if finetune or k.startswith('rpn_'):
            e = abs(got[k] - v) / max(1.0, abs(v))
            check(e <= DP_TOL, f'{tag}: {k} {got[k]}, one process {v}')
    if finetune:
        check(gaps['params'] <= DP_TOL, f'{tag}: parameters err '
              f'{gaps["params"]} ({gaps["worst_params"]})')
    else:
        check(gaps['terms'] <= max(DP_TOL, self_gaps['terms']),
              f'{tag}: loss terms err {gaps["terms"]}, one ulp '
              f'{self_gaps["terms"]}')
        check(gaps['params'] <= DP_ULP_PARAMS * self_gaps['params'],
              f'{tag}: parameters err {gaps["params"]} '
              f'({gaps["worst_params"]}), one ulp {self_gaps["params"]}')
    return gaps, self_gaps


def dp_timing(runs):
    """(ms a step of the steps after the first, collectives a step, ms in
    them) of each run."""
    out = []
    for r in runs:
        later = r['steps'][1:]
        out.append((np.mean([s['ms'] for s in later]),
                    later[-1]['collectives'],
                    np.mean([s['collective_ms'] for s in later])))
    return out


def data_parallel_steps(tmp):
    """Phase 15, first half: DP_RANKS ranks on cuda:0 over gloo (and one a
    card over NCCL when there are several) against one process."""
    import os
    from jmodt_torch.train import data_parallel
    res = {}
    tf32 = os.environ.get('NVIDIA_TF32_OVERRIDE')
    # the ranks compute float32 as this process does since phase 4: no TF32
    os.environ['NVIDIA_TF32_OVERRIDE'] = '0'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = train_cfg(True, 'bfloat16', reid_fg_thresh=0.0)
        state = train_state(cfg)
        batches = pair_batches(cfg, TRAIN_PAIRS, range(300, 300 +
                                                       DP_TIMING_STEPS))
        torch.cuda.reset_peak_memory_stats()
        one = data_parallel.run_steps('cuda', cfg, state, batches,
                                      f'{tmp}/one_bf16')
        ranks = data_parallel.on_ranks(DP_RANKS, cfg, state, batches,
                                       f'{tmp}/ranks_bf16', device='cuda:0')
        for r in ranks:
            for i, (a, b) in enumerate(zip(one['steps'], r['steps'])):
                check(a['launches'] == b['launches'], f'bf16 finetune: rank '
                      f'{r["rank"]} step {i + 1} launched {b["launches"]}, '
                      f'one process {a["launches"]}')
                check(all(np.isfinite(v) for v in b['tb'].values()),
                      f'bf16 finetune: rank {r["rank"]} step {i + 1} '
                      f'non-finite terms {b["tb"]}')
        check_counts(ranks[0]['steps'][-1]['launches'], PER_STEP_FINETUNE,
                     'data-parallel finetune rank 0')
        res['timing'] = dp_timing([one] + ranks)
        res['peak_gib'] = [one['peak_gib']] + [r['peak_gib'] for r in ranks]
        res['launches'] = ranks[0]['steps'][-1]['launches']
        res['loss'] = (one['steps'][-1]['tb']['loss'],
                       ranks[0]['steps'][-1]['tb']['loss'])
        del state, batches
        backends = [('gloo', 'cuda:0')]
        if torch.cuda.device_count() > 1:
            backends.append(('nccl', None))
        for finetune, pairs in ((True, TRAIN_PAIRS), (False, DP_FULL_PAIRS)):
            what = 'finetune' if finetune else 'full losses'
            cfg32 = train_cfg(finetune, 'float32',
                              0.0 if finetune else None)
            state = train_state(cfg32)
            batch = pair_batches(cfg32, pairs, (310,))
            one = data_parallel.run_steps('cuda', cfg32, state, batch,
                                          f'{tmp}/one_{finetune}')
            check(one['steps'][0]['tb']['loss'] > 0, f'{what}: loss 0')
            moved = [dict(b, pts_input=np.nextafter(
                b['pts_input'], np.float32(np.inf)).astype(np.float32))
                for b in batch]
            ulp = data_parallel.run_steps('cuda', cfg32, state, moved,
                                          f'{tmp}/ulp_{finetune}')
            for backend, device in backends:
                ranks = data_parallel.on_ranks(
                    DP_RANKS, cfg32, state, batch,
                    f'{tmp}/{backend}_{finetune}', device=device)
                dp_compare(one, ulp, ranks, finetune, what, backend, pairs)
    finally:
        if tf32 is None:
            os.environ.pop('NVIDIA_TF32_OVERRIDE')
        else:
            os.environ['NVIDIA_TF32_OVERRIDE'] = tf32
    return res


def split_lockstep(frames):
    """Phase 15, second half: make_batched_joint_step at STREAMS streams
    under RPN.MEGA_SA split over [cuda:0, cuda:0] (and over two cards when
    there are several) against the unsplit step: float32 rows and states
    over SPLIT_FRAMES frames, K5's launches a part; then bfloat16 ms a
    lockstep frame, split and unsplit."""
    from jmodt_torch.ops import kernels
    from jmodt_torch.pipeline import make_batched_joint_step
    from jmodt_torch.tracking.device_tracker import init_batched_state
    splits = [['cuda:0', 'cuda:0']]
    if torch.cuda.device_count() > 1:
        splits.append(['cuda:0', 'cuda:1'])
    res = {'errs': {}, 'ms': {}}
    for dtype in ('float32', 'bfloat16'):
        cfg = mega_cfg(dtype)
        feat_dim = cfg.RCNN.SA_CONFIG.MLPS[-1][-1]
        model, head, kw = joint_parts(cfg)
        steps = {'unsplit': make_batched_joint_step(cfg, model, head, **kw)}
        states = {'unsplit': new_state(cfg, streams=STREAMS)}
        for devs in splits:
            name = '+'.join(devs)
            steps[name] = make_batched_joint_step(cfg, model, head,
                                                  devices=devs, **kw)
            states[name] = init_batched_state(STREAMS, JOINT['max_tracks'],
                                              feat_dim, devices=devs)
        inputs = [lockstep_inputs(frames, t, STREAMS)
                  for t in range(SPLIT_FRAMES + 1)]
        packs = {}
        for name, step in steps.items():
            parts = 1 if name == 'unsplit' else 2
            if dtype == 'bfloat16':          # warm-up, then timed
                states[name], _ = step(states[name], *inputs[-1])
            kernels.launches.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            packs[name] = []
            for t in range(SPLIT_FRAMES):
                states[name], packed = step(states[name], *inputs[t])
                packs[name].append(packed)
                k5 = kernels.launches['sa_level']
                check(k5 == 3 * parts * (t + 1), f'split lockstep {name} '
                      f'({dtype}): K5 launched {k5} times in {t + 1} frames,'
                      f' expected {3 * parts * (t + 1)}')
            torch.cuda.synchronize()
            res['ms'][(name, dtype)] = ((time.perf_counter() - t0) * 1e3
                                        / SPLIT_FRAMES)
        for name in steps:
            check(all(bool(torch.isfinite(p).all()) for p in packs[name]),
                  f'split lockstep {name} ({dtype}): non-finite rows')
        if dtype != 'float32':
            continue
        want = states['unsplit']
        for name in steps:
            if name == 'unsplit':
                continue
            err = 0.0
            for t, (got, ref) in enumerate(zip(packs[name],
                                               packs['unsplit'])):
                got, ref = got.cpu(), ref.cpu()
                check(torch.equal(got[..., 0], ref[..., 0]) and torch.equal(
                    got[..., 9], ref[..., 9]), f'split lockstep {name} frame '
                    f'{t}: tid / emit differ from the unsplit step')
                err = max(err, scale_err(got[..., 1:9], ref[..., 1:9]))
            parts = states[name]
            for k in want._fields:
                if k == 'mats':
                    continue
                got = torch.cat([getattr(p, k).cpu() for p in parts])
                ref = getattr(want, k).cpu()
                if ref.is_floating_point():
                    err = max(err, scale_err(got, ref))
                else:
                    check(torch.equal(got, ref), f'split lockstep {name}: '
                          f'state {k} differs from the unsplit step')
            check(err <= SPLIT_TOL, f'split lockstep {name}: float err {err}')
            res['errs'][name] = err
        res['emitted'] = sum(int((p[..., 9] > 0.5).sum())
                             for p in packs['unsplit'])
        check(res['emitted'] > 0, 'split lockstep: no row emitted')
        del steps, states, packs, model, head
    return res



def data_parallel_phase(frames) -> dict:
    """Phase 15, printed; returns its data-parallel results."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dp = data_parallel_steps(tmp)
    (one_ms, _, _), *rank_t = dp['timing']
    print(f'[15 data parallel] {DP_RANKS} ranks on cuda:0 over gloo vs one '
          f'process, Config() finetune with REID.FG_THRESH 0 (bfloat16), '
          f'{TRAIN_PAIRS} pairs a step ({TRAIN_PAIRS // DP_RANKS} a rank), '
          f'{DP_TIMING_STEPS} steps: ms a step (steps 2-{DP_TIMING_STEPS}, '
          f'synchronized wall) one process {one_ms:.2f}, ranks '
          + ', '.join(f'{m:.2f}' for m, _, _ in rank_t)
          + '; collectives a rank-step '
          + ', '.join(f'{c} ({cm:.2f} ms in them)' for _, c, cm in rank_t)
          + '; peak memory GiB one process '
          f'{dp["peak_gib"][0]:.2f}, ranks '
          + ', '.join(f'{g:.2f}' for g in dp['peak_gib'][1:])
          + f'; launches a rank-step {dp["launches"]}, each step equal to '
          f'the one process\'s; loss step {DP_TIMING_STEPS} one process '
          f'{dp["loss"][0]:.6g}, rank 0 {dp["loss"][1]:.6g}', flush=True)
    sp = split_lockstep(frames)
    print(f'[15 split] make_batched_joint_step, S={STREAMS}, RPN.MEGA_SA, '
          f'{SPLIT_FRAMES} frames split over '
          + ', '.join(n for n in sp['errs'])
          + ' vs unsplit: float32 tid, emit and state integers equal, '
          'rows and state floats err '
          + ', '.join(f'{e:.3g}' for e in sp['errs'].values())
          + f' ({sp["emitted"]} rows emitted); K5 3 launches a part a frame; '
          'ms a lockstep frame (bfloat16, synchronized wall) '
          + ', '.join(f'{n} {m:.2f}' for (n, d), m in sp['ms'].items()
                      if d == 'bfloat16')
          + f' ({time.perf_counter() - t0:.1f} s)', flush=True)
    return dp


# ----------------------------------------------------------------- phase 16

PYRAMID_FRAMES = 3      # frames a path with LI_FUSION.FUSED_PYRAMID
PYRAMID_ROUNDS = 2      # timed rounds, the routes' order flipped each
LOADER_TOL = dict(rtol=2e-4, atol=1e-3)     # tests/test_native_loader.py
LADDER_ARGS = ['--frames', '3', '--seqs', '2', '--epochs1', '1', '--epochs2',
               '1', '--epochs3', '1', '--batch', '2']


def pyramid_cfg(cfg, fused: bool):
    return dataclasses.replace(cfg, LI_FUSION=dataclasses.replace(
        cfg.LI_FUSION, FUSED_PYRAMID=fused))


def routes_since(before: dict) -> dict:
    """ImagePyramidFusion's forwards by route since `before`."""
    from jmodt_torch.models import image_backbone
    now = image_backbone.pyramid_routes
    return {k: now[k] - before.get(k, 0) for k in ('fused', 'materialized')}


def fused_paths(frames):
    """Phase 16 (a), bfloat16: the detection step at Config() and the
    joint step with RPN.MEGA_SA, each with FUSED_PYRAMID, phases 3's and
    6's launch checks a frame and one fused forward a frame."""
    from jmodt_torch.config import Config
    from jmodt_torch.models import image_backbone
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.models.point_rcnn import build_detector
    n = PYRAMID_FRAMES
    cfg = pyramid_cfg(dataclasses.replace(Config(), DTYPE='bfloat16'), True)
    step = make_detection_step(cfg, build_detector(cfg, seed=0))
    before = dict(image_backbone.pyramid_routes)
    _, det_counts, _ = run_step(step, frames[:n])
    routes = routes_since(before)
    check(routes == {'fused': n, 'materialized': 0},
          f'fused pyramid: detection step routes {routes} in {n} frames')
    mcfg = pyramid_cfg(mega_cfg('bfloat16'), True)
    joint = build_joint(mcfg)
    before = dict(image_backbone.pyramid_routes)
    # n frames, then one frame fed three times (run_joint)
    _, joint_counts, _, _ = run_joint(joint, mcfg, frames[:n])
    routes = routes_since(before)
    check(routes == {'fused': n + 3, 'materialized': 0},
          f'fused pyramid: joint step routes {routes} in {n + 3} frames')
    return ({k: v // n for k, v in det_counts.items()},
            {k: v // n for k, v in joint_counts.items()})


def fused_parity(frames):
    """Phase 16 (a), float32 with TF32 off, on the card: the fused route
    against the materialized one with the same weights."""
    from jmodt_torch.config import Config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(Config(), DTYPE='float32')
    mat, fused = (detection_outputs(pyramid_cfg(cfg32, f), frames[0], 'cuda')
                  for f in (False, True))
    errs = {}
    for key in ('roi_mask', 'keep'):
        check(torch.equal(mat[key], fused[key]),
              f'fused pyramid parity: {key} differs')
    for key in ('backbone_features', 'rois', 'boxes', 'scores'):
        errs[key] = scale_err(fused[key], mat[key])
        check(errs[key] <= NET_TOL, f'fused pyramid parity: {key} err '
              f'{errs[key]}')
    rows = {}
    for f in (False, True):
        c = pyramid_cfg(mega_cfg('float32'), f)
        joint, state = build_joint(c), new_state(c)
        rows[f] = []
        for i, fr in enumerate(frames[:PYRAMID_FRAMES]):
            state, packed = joint(state, i + 1, fr['pts_input'], fr['img'],
                                  fr['pts_xy'])
            rows[f].append(packed.cpu())
    joint_err = 0.0
    for i, (m, g) in enumerate(zip(rows[False], rows[True])):
        check(torch.equal(m[:, 0], g[:, 0]) and torch.equal(m[:, 9], g[:, 9]),
              f'fused pyramid joint parity frame {i}: tid or emit differs')
        joint_err = max(joint_err, scale_err(g[:, 1:9], m[:, 1:9]))
    check(joint_err <= NET_TOL, f'fused pyramid joint parity: boxes / '
          f'scores err {joint_err}')
    errs['joint_rows'] = joint_err
    return errs, sum(int(r[:, 9].sum()) for r in rows[True])


def frame_times(run, frames):
    """[(wall ms, CUDA-event ms, peak GiB, GiB over the frame's start)] a
    frame of `run(frame)`, each frame synchronized."""
    out = []
    for f in frames:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run(f)
        end.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out.append(((time.perf_counter() - t0) * 1e3, start.elapsed_time(end),
                    peak / 2**30, (peak - base) / 2**30))
    return out


def pyramid_timing(frames):
    """Phase 16 (a): ms a frame and peak memory of the detection step and
    the joint step (bfloat16), the materialized route against the fused
    one in turns, PYRAMID_FRAMES frames a turn."""
    from jmodt_torch.config import Config
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.models.point_rcnn import build_detector
    base = dataclasses.replace(Config(), DTYPE='bfloat16')
    runs = {}
    for fused in (False, True):
        c = pyramid_cfg(base, fused)
        step = make_detection_step(c, build_detector(c, seed=0))
        runs[('detection', fused)] = (
            lambda f, step=step: step(f['pts_input'], f['img'], f['pts_xy']))
        mc = pyramid_cfg(mega_cfg('bfloat16'), fused)
        joint, st = build_joint(mc), {'state': new_state(mc), 'id': 0}

        def run_joint_frame(f, joint=joint, st=st):
            st['id'] += 1
            st['state'], packed = joint(st['state'], st['id'],
                                        f['pts_input'], f['img'],
                                        f['pts_xy'])
            return packed
        runs[('joint', fused)] = run_joint_frame
    for run in runs.values():                 # warm up, kernels built
        frame_times(run, frames[:1])
    samples = {k: [] for k in runs}
    for r in range(PYRAMID_ROUNDS):
        for path in ('detection', 'joint'):
            for fused in ((False, True) if r % 2 == 0 else (True, False)):
                samples[(path, fused)] += frame_times(
                    runs[(path, fused)], frames[:PYRAMID_FRAMES])
    return samples


def pyramid_layer(frames, reps: int = 20):
    """Phase 16 (a): the image pyramid alone on one frame's levels
    (bfloat16, Config()): device ms (cuda_ms) and peak memory over the
    call's start of the materialized map sampled by feature_gather, and of
    the fused gather.  Returns {route: ((ms, host_clocked), GiB)}."""
    from jmodt_torch.config import Config
    from jmodt_torch.models.image_backbone import feature_gather
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.models.point_rcnn import build_detector
    cfg = dataclasses.replace(Config(), DTYPE='bfloat16')
    model = build_detector(cfg, seed=0)
    pyr = model.rpn.backbone.img_pyramid
    seen = []
    hook = pyr.register_forward_pre_hook(lambda m, a: seen.append(a))
    f = frames[0]
    make_detection_step(cfg, model)(f['pts_input'], f['img'], f['pts_xy'])
    hook.remove()
    levels = list(seen[0][0])
    xy = torch.as_tensor(f['pts_xy'], device=levels[0].device).float()
    routes = {
        'materialized': lambda *a: feature_gather(pyr(list(a[:-1])), a[-1]),
        'fused': lambda *a: pyr(list(a[:-1]), a[-1])}
    out = {}
    for name, fn in routes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(*levels, xy)
        torch.cuda.synchronize()
        grow = (torch.cuda.max_memory_allocated() - base) / 2**30
        out[name] = (cuda_ms(fn, (*levels, xy), reps), grow)
    return out


def show_frame_times(samples) -> str:
    def stat(vals):
        return (f'{np.median(vals):.2f} (min {min(vals):.2f}, max '
                f'{max(vals):.2f})')
    parts = []
    for (path, fused), s in samples.items():
        wall, ev, peak, grow = zip(*s)
        parts.append(f'{path} {"fused" if fused else "materialized"}: wall '
                     f'{stat(wall)} ms, CUDA events {stat(ev)} ms, peak '
                     f'{max(peak):.3f} GiB ({max(grow):.3f} over the frame\'s '
                     'start)')
    return '; '.join(parts)


def native_loader(root):
    """Phase 16 (b): the native loader on phase 14's tree (KITTI's sizes)
    against the numpy one, and the loader's host ms a batch both ways."""
    from jmodt_torch import native
    from jmodt_torch.config import Config
    from jmodt_torch.data.kitti_dataset import KittiDataset
    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    check(native.get_lib() is not None, 'native loader: no library')
    cfg = Config()
    kw = dict(npoints=cfg.RPN.NUM_POINTS, split='val', mode='EVAL', cfg=cfg,
              fixed_img_size=TRAIN_IMG_HW, seed=0)
    a = KittiDataset(root, **kw)
    b = KittiDataset(root, use_native=False, **kw)
    native.loads.clear()
    err = 0.0
    for i in range(len(a)):
        x, y = a[i], b[i]
        for key in ('pts_input', 'pts_xy'):
            check(np.allclose(x[key], y[key], **LOADER_TOL),
                  f'native loader: frame {i} {key} differs from numpy')
            err = max(err, float(np.abs(x[key] - y[key]).max()))
    check(native.loads['load_velodyne'] == native.loads['project_and_filter']
          == len(a) > 0, f'native loader: {dict(native.loads)} loads for '
          f'{len(a)} frames')
    # the loader's host cost, native and numpy in turns
    tcfg = train_cfg(True, cfg.DTYPE, reid_fg_thresh=0.0)
    per_epoch = 2 * TRAIN_PAIRS * KITTI_TRAIN_STEPS
    ms = {True: [], False: []}
    for use in (True, False, False, True):
        ds = KittiDataset(root, npoints=cfg.RPN.NUM_POINTS, split='train',
                          mode='TRAIN', cfg=tcfg, fixed_img_size=TRAIN_IMG_HW,
                          use_native=use)
        native.loads.clear()
        first, rest = loader_ms(ds, 0)
        reads = native.loads['project_and_filter']
        check(reads == (per_epoch if use else 0), f'native loader: '
              f'{reads} native loads in an epoch of {per_epoch} frames '
              f'(use_native={use})')
        ms[use].append((first, rest))
    return dict(build_s=build_s, lib=path.name, frames=len(a), err=err,
                ms=ms, per_epoch=per_epoch)


def export_round_trip(tmp, frames):
    """Phase 16 (c): a saved Config() checkpoint through `python -m
    jmodt_torch.tools.export_torch_weights`, read back by
    `load_checkpoint` into a new model: every tensor and one detection
    frame bit-equal."""
    import contextlib
    import io
    from jmodt_torch.config import Config
    from jmodt_torch.models.inference import make_detection_step
    from jmodt_torch.models.point_rcnn import build_detector
    from jmodt_torch.tools import export_torch_weights
    from jmodt_torch.train.checkpoint import (checkpoint_state,
                                              load_checkpoint,
                                              save_checkpoint)
    cfg = dataclasses.replace(Config(), DTYPE='bfloat16')
    model = build_detector(cfg, seed=0)
    ckpt = save_checkpoint(checkpoint_state(model, epoch=1, it=3),
                           f'{tmp}/port_model')
    with contextlib.redirect_stdout(io.StringIO()):
        out = export_torch_weights.main(['--ckpt', ckpt, '--out',
                                         f'{tmp}/reference.pth'])
    saved = torch.load(out, map_location='cpu', weights_only=True)
    check(all(k.startswith(('rpn.backbone_net.', 'rpn.rpn_', 'rcnn_net.'))
              for k in saved['model_state']),
          'export: a key outside the reference\'s names')
    again = build_detector(cfg, seed=7)
    it, epoch = load_checkpoint(out, again)
    check((it, epoch) == (3, 1), f'export: it, epoch {it}, {epoch}')
    own, back = model.state_dict(), again.state_dict()
    for k, v in own.items():
        check(torch.equal(back[k], v), f'export: {k} not bit-equal')
    f = frames[0]
    want = make_detection_step(cfg, model)(f['pts_input'], f['img'],
                                           f['pts_xy'])
    got = make_detection_step(cfg, again)(f['pts_input'], f['img'],
                                          f['pts_xy'])
    for k, v in want.items():
        check(torch.equal(got[k], v), f'export: detection {k} differs')
    return len(saved['model_state']), len(own)


def same_json(a, b, float_tol: float) -> float:
    """Raise unless `a` and `b` are the same JSON (floats within
    `float_tol`); returns the largest float gap."""
    check(type(a) is type(b), f'json: {a!r} vs {b!r}')
    if isinstance(a, dict):
        check(list(a) == list(b), f'json keys {list(a)} vs {list(b)}')
        return max([same_json(a[k], b[k], float_tol) for k in a] or [0.0])
    if isinstance(a, list):
        check(len(a) == len(b), f'json: {a} vs {b}')
        return max([same_json(x, y, float_tol) for x, y in zip(a, b)]
                   or [0.0])
    if isinstance(a, float):
        check(abs(a - b) <= float_tol, f'json: {a} vs {b}')
        return abs(a - b)
    check(a == b, f'json: {a!r} vs {b!r}')
    return 0.0


def oracle_and_recall(tmp):
    """Phase 16 (d): `oracle_ap` and `recall_diagnosis` on phase 13's tree
    and its stage-1 detections (and the oracle's jittered ones), on the
    card and with `--device cpu`."""
    import contextlib
    import io
    import logging
    from jmodt_torch.config import Config
    from jmodt_torch.eval import __main__ as ev
    from jmodt_torch.tools import oracle_ap, recall_diagnosis
    log = logging.getLogger('chip_smoke.remainder')
    log.addHandler(logging.NullHandler())
    log.propagate = False
    cfg = Config()
    root = f'{tmp}/KITTI'
    eval_tree(root, cfg)
    pth = eval_checkpoint(cfg, f'{tmp}/model')
    args = ev.build_parser().parse_args(
        ['--data_root', root, '--det_output', f'{tmp}/eval/det',
         '--output_dir', f'{tmp}/eval', '--ckpt', pth])
    with contextlib.redirect_stdout(io.StringIO()):
        ev.eval_joint_detection(args, cfg, log)
    res, secs = {}, {}
    for dev in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            oracle = oracle_ap.main(['--data_root', root, '--jitter', '0.3',
                                     '--out', f'{tmp}/oracle_{dev}',
                                     '--device', dev])
            recalls = [recall_diagnosis.main(
                ['--data_root', root, '--det_dir', d, '--device', dev])
                for d in (f'{tmp}/eval/det/txt',
                          f'{tmp}/oracle_cuda/txt_jitter')]
        secs[dev] = time.perf_counter() - t0
        res[dev] = (oracle, recalls)
    (o_card, r_card), (o_cpu, r_cpu) = res['cuda'], res['cpu']
    check(o_card == o_cpu, f'oracle_ap: card {o_card} != CPU {o_cpu}')
    gap = max(same_json(a, b, IOU_EVAL_TOL) for a, b in zip(r_card, r_cpu))
    check(o_card['oracle_dets'] > 0 and r_card[1]['n_gt'] > 0,
          'oracle / recall: nothing scored')
    return dict(oracle=o_card, recalls=r_card, gap=gap, secs=secs)


def ladder_run(tmp):
    """Phase 16 (e): `python -m jmodt_torch.tools.synthetic_ladder` at its
    smallest on the card."""
    import contextlib
    import io
    import logging
    from jmodt_torch.tools import synthetic_ladder
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            res = synthetic_ladder.main(['--out', f'{tmp}/ladder',
                                         *LADDER_ARGS])
    except Exception as e:
        raise SmokeFailure(f'synthetic_ladder: {e!r}; its output ends '
                           f'{buf.getvalue()[-2000:]}') from e
    finally:
        root = logging.getLogger()
        for h in list(root.handlers):
            if isinstance(h, logging.FileHandler):
                root.removeHandler(h)
                h.close()
    secs = time.perf_counter() - t0
    last = buf.getvalue().strip().splitlines()[-1]
    check(json.loads(last) == res and list(res) == [
        'ap_3d_moderate', 'ap_bev_moderate', 'mota', 'stages'],
        f'synthetic_ladder: last line {last}')
    return res, secs


def remainder_phase(frames) -> dict:
    """Phase 16, printed; returns the fused paths' launches a frame."""
    t0 = time.perf_counter()
    det_counts, joint_counts = fused_paths(frames)
    print(f'[16 remainder] (a) LI_FUSION.FUSED_PYRAMID, bfloat16, '
          f'{PYRAMID_FRAMES} frames: launches a frame detection step '
          f'{det_counts}, joint step (RPN.MEGA_SA) {joint_counts}; one fused '
          'pyramid forward a frame, none materialized', flush=True)
    errs, emitted = fused_parity(frames)
    print('[16 remainder] (a) float32, TF32 off, fused vs materialized on '
          'the card: roi_mask, keep equal; joint tid, emit equal ('
          f'{emitted} rows emitted); errors '
          + ', '.join(f'{k} {v:.3g}' for k, v in errs.items()), flush=True)
    samples = pyramid_timing(frames)
    print(f'[16 remainder] (a) ms a frame, bfloat16, median of '
          f'{PYRAMID_ROUNDS * PYRAMID_FRAMES} in turns: '
          + show_frame_times(samples), flush=True)
    layer = pyramid_layer(frames)
    print('[16 remainder] (a) the image pyramid alone, one frame\'s levels '
          '(bfloat16), device time and peak memory over the call\'s start: '
          + '; '.join(f'{k} {show(t)}, {g:.4f} GiB'
                      for k, (t, g) in layer.items()), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        from jmodt_torch.config import Config
        kitti_train_tree(f'{tmp}/KITTI', Config())
        nl = native_loader(f'{tmp}/KITTI')
    print(f'[16 remainder] (b) native loader {nl["lib"]} built in '
          f'{nl["build_s"]:.2f} s; {nl["frames"]} EVAL frames of '
          f'{EVAL_SWEEP}-point sweeps, {EVAL_IMG_HW[0]}x{EVAL_IMG_HW[1]} '
          f'PNGs: pts_input and pts_xy within rtol {LOADER_TOL["rtol"]:g} / '
          f'atol {LOADER_TOL["atol"]:g} of numpy (largest gap '
          f'{nl["err"]:.3g}), one native load a frame; loader host ms a batch '
          f'of {TRAIN_PAIRS} pairs in this process (first batch, then a '
          'batch): '
          + '; '.join(f'{"native" if u else "numpy"} '
                      + ', '.join(f'{a:.1f} / {b:.1f}' for a, b in v)
                      for u, v in nl['ms'].items())
          + f'; {nl["per_epoch"]} native loads an epoch '
          f'({time.perf_counter() - t1:.1f} s)', flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        n_ref, n_own = export_round_trip(tmp, frames)
    print(f'[16 remainder] (c) export: a Config() checkpoint through python '
          f'-m jmodt_torch.tools.export_torch_weights ({n_ref} reference '
          f'tensors), read back by load_checkpoint: {n_own} tensors and one '
          'detection frame bit-equal', flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        orc = oracle_and_recall(tmp)
    o, r = orc['oracle'], orc['recalls']
    print(f'[16 remainder] (d) oracle_ap on phase 13\'s tree: ceiling '
          f'{json.dumps(o["ceiling"])}, jitter 0.3 '
          f'{json.dumps(o["jittered"])}, card JSON equal to --device cpu; '
          f'recall_diagnosis on the stage-1 detections (recall '
          f'{r[0]["recall"]:.3f} of {r[0]["n_gt"]}) and the jittered oracle '
          f'(recall {r[1]["recall"]:.3f}): card JSON equal to --device cpu '
          f'(largest float gap {orc["gap"]:.3g}); seconds card '
          f'{orc["secs"]["cuda"]:.2f}, CPU {orc["secs"]["cpu"]:.2f}',
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        lad, secs = ladder_run(tmp)
    print(f'[16 remainder] (e) python -m jmodt_torch.tools.synthetic_ladder '
          f'{" ".join(LADDER_ARGS)}: {json.dumps(lad)} in {secs:.1f} s '
          f'(phase {time.perf_counter() - t0:.1f} s)', flush=True)
    return dict(detection=det_counts, joint=joint_counts)


def main(argv) -> int:
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
    if argv == ['--data-parallel']:     # phase 15 alone: a multi-card call
        data_parallel_phase(frames)
        print_device()
        return 0
    if argv == ['--remainder']:         # phase 16 alone
        remainder_phase(frames)
        print_device()
        return 0
    if argv:
        print(f'chip_smoke: unknown arguments {argv}', file=sys.stderr)
        return 2
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

    cfg_ft = train_cfg(True, 'bfloat16', reid_fg_thresh=0.0)
    print(f'[11 finetune] inputs recorded from training step 1 ('
          f'{TRAIN_PAIRS} pairs); kernel vs plain version:', flush=True)
    t0 = time.perf_counter()
    ft = run_finetune(cfg_ft)
    print(f'[11 finetune] Config() link / se finetune with REID.FG_THRESH 0'
          f' (bfloat16), {TRAIN_PAIRS} pairs a step, {TRAIN_STEPS} steps: '
          f'launches step {TRAIN_STEPS} {ft["counts"]}; loss and every link / '
          'se weight gradient nonzero; frozen parameters and RPN buffers '
          'bit-equal, link / se weights moved; steps 2-3 '
          + ', '.join(f'{m:.2f}' for m in ft['ms']) + ' ms (CUDA events), '
          + ', '.join(f'{m:.2f}' for m in ft['wall']) + ' ms (wall); peak '
          f'memory {ft["peak_gib"]:.2f} GiB; proposal layer '
          f'{100 * ft["share"]:.1f}% of step 3; losses step 1 '
          + json.dumps({k: round(v, 5) for k, v in ft['losses'][0].items()})
          + f' ({time.perf_counter() - t0:.1f} s)', flush=True)
    # Config()'s finetune loss is 0 with random weights (train_cfg); the
    # second run compares the link / se terms and gradients too
    for what, c in (('Config()', train_cfg(True, 'float32')),
                    ('REID.FG_THRESH 0', train_cfg(True, 'float32', 0.0))):
        t0 = time.perf_counter()
        perrs, gnorms, near, ndiff = train_parity(c)
        print(f'[11 parity] float32 finetune step ({what}), 1 pair, card vs '
              'CPU: loss terms ' + ', '.join(f'{k} {v:.3g}' for k, v in
                                             perrs.items())
              + f' (link_se_grad: the largest, of its own scale); grad_norm '
              f'card {gnorms[0]:.6g} CPU {gnorms[1]:.6g}; '
              f'{ndiff} RoI labels differ, all within {IOU_EDGE:g} of a '
              f'threshold; RoIs near a threshold (index, CPU IoU, card '
              f'IoU): {near} ({time.perf_counter() - t0:.1f} s)', flush=True)
    t0 = time.perf_counter()
    full = run_full(train_cfg(False, 'bfloat16'))
    print(f'[12 full] full losses (bfloat16), 1 pair: launches a step '
          f'{full["counts"]}, K6 backward {full["k6_backward"]} times; '
          f'{full["params"]} parameter gradients present and finite; '
          f'BatchNorm statistics vs flax\'s rule err {full["bn_err"][0]:.3g} '
          f'/ {full["bn_err"][1]:.3g}; step 2 {full["ms"]:.2f} ms (CUDA '
          f'events), {full["wall"]:.2f} ms (wall); losses '
          + json.dumps({k: round(v, 5) for k, v in full['losses'][0].items()})
          + f' ({time.perf_counter() - t0:.1f} s)', flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ev = eval_entry(tmp)
    print(f'[13 eval] python -m jmodt_torch.eval on a KITTI-format tree '
          f'({len(EVAL_SEQS)} sequences x {EVAL_FRAMES} frames, '
          f'{EVAL_IMG_HW[0]}x{EVAL_IMG_HW[1]} PNGs, {EVAL_SWEEP}-point sweeps)'
          f', Config() ({Config().DTYPE}): launches a frame '
          f'{ev["eval_frame"]}; '
          'each kernel call of frame 1 equal to its plain version; txt and '
          'feat files equal to a direct detection-step run; recall '
          f'{ev["recall"]} equal to a CPU recount; rotate_iou_eval card vs '
          f'CPU err {ev["iou_err"]:.3g}, AP equal ({ev["ap"]}); stage 1 '
          f'{ev["ms"]:.2f} ms a frame (the CLI\'s clock: step to host read'
          '); the step synchronized, frame by frame: '
          + ', '.join(f'{m:.2f}' for m in ev['step_ms'])
          + f' ms; AP evaluation {ev["ap_s"]:.4f} s; stage 2 on perfect '
          'detections, MOTA 1.0 and 0 id switches in every mode and run, '
          '--batch_seqs tracks equal to --device_tracker; frames/s (first '
          'run, second run): '
          + ', '.join(f'{m} {f[0]:.1f}, {f[1]:.1f}'
                      for m, f in ev['fps'].items())
          + f' ({time.perf_counter() - t0:.1f} s)', flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        kt = kitti_train(tmp)
    st, fl, ld = kt['steps'], kt['full'], kt['loader']
    print(f'[14 kitti] python -m jmodt_torch.train --data_root on a '
          f'KITTI-format tree ({kt["pairs"]} training pairs, '
          f'{EVAL_IMG_HW[0]}x{EVAL_IMG_HW[1]} PNGs, {EVAL_SWEEP}-point '
          f'sweeps, written in {kt["tree_s"]:.1f} s), Config() '
          f'({Config().DTYPE}) finetune with REID.FG_THRESH 0, {TRAIN_PAIRS} '
          'pairs a step, 2 loader processes, async checkpoint: launches a '
          f'step {st[-1]["counts"]}; each kernel call of step 1 equal to its '
          'plain version; loss and every link / se weight gradient finite '
          'and nonzero; frozen parameters bit-equal; checkpoint_epoch_1 '
          'loads bit-equal; a resume at 0 loader processes starts at '
          f'iteration {KITTI_TRAIN_STEPS} with the dataset\'s own first '
          'batch; steps 1-3 '
          + ', '.join(f'{s["ms"]:.2f}' for s in st) + ' ms (CUDA events), '
          + ', '.join(f'{s["wall"]:.2f}' for s in st) + ' ms (wall); peak '
          f'memory {st[-1]["peak_gib"]:.2f} GiB (steps 2-3); the run '
          f'{kt["run_s"]:.1f} s; losses step 1 '
          + json.dumps({k: round(v, 5) for k, v in st[0]['vals'].items()}),
          flush=True)
    print(f'[14 kitti] full losses (--finetune passed), 1 pair: launches '
          f'{fl["counts"]}, K6 backward {kt["k6_back"]} times, every '
          f'gradient finite; {fl["ms"]:.2f} ms (CUDA events), '
          f'{fl["wall"]:.2f} ms (wall)', flush=True)
    print(f'[14 kitti] loader, host ms a batch of {TRAIN_PAIRS} pairs: '
          + '; '.join(f'{w} workers: first batch {a:.1f} ms, then '
                      f'{b:.1f} ms a batch' for w, (a, b) in ld.items())
          + f'; utils/png.py reading one {EVAL_IMG_HW[0]}x{EVAL_IMG_HW[1]} '
          f'PNG: filter 0 on every row {kt["png"][0]:.1f} ms, all five '
          f'filters {kt["png"][1]:.1f} ms (best of {PNG_REPS})', flush=True)
    print(f'[14 sweep] python -m jmodt_torch.eval.mot_sweep, grid '
          f'{json.dumps(SWEEP_GRID)} on perfect detections: MOTA '
          + ', '.join(f'{r["tag"]} {r["mota"]}' for r in kt['results'])
          + f'; best {kt["best"]["tag"]}, its tracks byte-equal to '
          f'python -m jmodt_torch.eval --only_tracking with its flags '
          f'({kt["sweep_s"]:.2f} s; phase {time.perf_counter() - t0:.1f} s)',
          flush=True)

    dp = data_parallel_phase(frames)
    rem = remainder_phase(frames)

    rows = []
    for k in KERNELS:
        a = agg[k['name']]
        rows.append({
            'name': k['name'], 'route': 'cuda', 'source': k['source'],
            'replaces': k['replaces'], 'launches': jcounts[k['counter']],
            'launches_by_path': {
                'detection': counts.get(k['counter'], 0),
                'joint': jcounts[k['counter']],
                'batched': bcounts[k['counter']],
                'train_finetune_step': ft['counts'].get(k['counter'], 0),
                'train_full_step': full['counts'].get(k['counter'], 0),
                'eval_frame': ev['eval_frame'].get(k['counter'], 0),
                'train_kitti_step': st[-1]['counts'].get(k['counter'], 0),
                'train_kitti_full_step': fl['counts'].get(k['counter'],
                                                          0),
                'train_finetune_rank_step': dp['launches'].get(
                    k['counter'], 0),
                'detection_fused_pyramid': rem['detection'].get(
                    k['counter'], 0),
                'joint_fused_pyramid': rem['joint'].get(k['counter'], 0)},
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
        tr = ft['agg'].get(k['name'])
        if tr is not None and tr['per_call']:
            row['per_call_train'] = tr['per_call']
            row['ms_train_step'] = tr['ms']
        if k['name'] == 'depth_to_space':
            row['backward_launches_train_full_step'] = full['k6_backward']
        if 'default_ms' in a:
            row['default_path_ms'] = a['default_ms']
            row['fps_floor_ms'] = a['fps_floor_ms']
        if 'deconv_ms' in a:
            row['deconv_ms'] = a['deconv_ms']
            row['deconv_library_ms'] = a['deconv_library_ms']
    print(json.dumps({'kernels': rows}))
    print_device()
    return 0


def print_device() -> None:
    """The card's name and power limit, then the contract's last line."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        with torch.no_grad():
            code = main(sys.argv[1:])
        sys.exit(code)
    except SmokeFailure as e:
        print(f'chip_smoke FAILED: {e}', file=sys.stderr)
        sys.exit(1)
