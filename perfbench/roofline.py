"""The card's peaks and the least time each hand-written kernel of a frame
could take, as functions of the frame's shapes.

A kernel's bound is the larger of its operations over their peak rate
and its bytes over the HBM rate, counting each input byte read once and
each output byte written once.  Operations are float32 FMAs at 67 TFLOP/s
outside the tensor cores; the products of K4's and K5's MLP layers 2..L
run on the tensor cores as three TF32 products each (3xTF32, float32
accuracy) at 495 TFLOP/s.  Per pair of points: 9 operations a step of
farthest point sampling (a squared distance and the running minimum), 8
a ball-query or three-NN distance.  N1-N3 do data-dependent work that no
shape fixes, so their bound is their bytes alone: a lower bound.

The bounds are keyed by the name of the CUDA kernel that does the work,
so a trace's kernel times can be set against them: `frame_bounds` a
joint frame's on the main path, `train_step_bounds` a finetune step's.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TF32_PASSES = 3


def bound_s(f32_ops: float = 0.0, nbytes: float = 0.0,
            tf32_ops: float = 0.0) -> float:
    """Least seconds for the work: the larger of operations and bytes."""
    t_ops = f32_ops / PEAK_F32_FLOPS + TF32_PASSES * tf32_ops / PEAK_TF32_FLOPS
    return max(t_ops, nbytes / PEAK_BYTES)


def fps_s(clouds: int, n: int, npoint: int) -> float:
    """Farthest point sampling of `clouds` clouds of n points to npoint."""
    return bound_s(9.0 * clouds * n * npoint,
                   4.0 * clouds * (3 * n + npoint))


def three_nn_s(clouds: int, n: int, m: int) -> float:
    """The 3 nearest of m known points for each of n queries."""
    return bound_s(8.0 * clouds * n * m,
                   4.0 * clouds * (3 * n + 3 * m + 6 * n))


def mlp_ops(rows: int, widths) -> tuple:
    """(tensor-core products, float32 operations) of MLP layers 2..L over
    `rows` grouped rows of widths [C1, .., CL] whose first layer was
    projected per point: the products, then the layer-1 add, subtract and
    ReLU and every later bias add and ReLU."""
    pairs = list(zip(widths[:-1], widths[1:]))
    return (rows * sum(2.0 * ci * co for ci, co in pairs),
            rows * (3.0 * widths[0] + sum(2.0 * co for _, co in pairs)))


def grouped_mlp_s(clouds: int, n: int, m: int, nsample: int, widths
                  ) -> float:
    """K4: gather nsample neighbours of m centres out of n points, run the
    MLP, max over the neighbours."""
    mma, other = mlp_ops(clouds * m * nsample, widths)
    nbytes = 4.0 * clouds * (n * widths[0] + m * nsample + m * widths[0]
                             + m * widths[-1])
    return bound_s(other, nbytes, mma)


def sa_consumer_s(clouds: int, n: int, cin: int, m: int, nsamples, mlps
                  ) -> float:
    """K5 past its FPS: the ball query of m centres over n points, the
    first layer projected once a point, layers 2..L over the grouped
    rows, the max over each group."""
    f32 = 8.0 * clouds * n * m
    mma = 0.0
    for ns, widths in zip(nsamples, mlps):
        f32 += 2.0 * clouds * n * (cin + 3) * widths[0]
        a, b = mlp_ops(clouds * m * ns, widths)
        mma += a
        f32 += b
    weights = sum((cin + 3) * w[0] + sum(a * b for a, b in zip(w[:-1], w[1:]))
                  for w in mlps)
    nbytes = 4.0 * (clouds * (n * (3 + cin) + m * sum(w[-1] for w in mlps))
                    + weights)
    return bound_s(f32, nbytes, mma)


def _rpn_bounds(cfg, b: int) -> Dict[str, float]:
    """The RPN of b clouds on the main path (RPN.MEGA_SA): K1 at level 0
    and K5's FPS grids at levels 1-3 (`fps_cluster_kernel`), K5's consumer
    grids, K3 at the four FP levels, K6 at the four pyramid levels."""
    sa = cfg.RPN.SA_CONFIG
    counts = [cfg.RPN.NUM_POINTS] + list(sa.NPOINTS)
    widths = [0] + [sum(w[-1] for w in m) for m in sa.MLPS]
    out = {'fps_cluster_kernel': fps_s(b, counts[0], counts[1]),
           'sa_consumer_kernel': 0.0}
    for k in range(1, len(sa.NPOINTS)):
        out['fps_cluster_kernel'] += fps_s(b, counts[k], counts[k + 1])
        out['sa_consumer_kernel'] += sa_consumer_s(
            b, counts[k], widths[k], counts[k + 1], sa.NSAMPLE[k],
            sa.MLPS[k])
    out['three_nn_kernel'] = sum(three_nn_s(b, counts[k], counts[k + 1])
                                 for k in range(len(sa.NPOINTS)))
    li = cfg.LI_FUSION
    if li.ENABLED:
        full = 384 * 1280
        per = 2.0 * b * full * 2 * li.DeConv_Reduce[0]       # bf16 in + out
        out['d2s_kernel'] = bound_s(0.0, per * len(li.DeConv_Kernels))
    return out


def _rcnn_bounds(cfg, rois: int, mlp: bool) -> Dict[str, float]:
    """The RCNN's SA levels over `rois` RoIs: K2's FPS and, with `mlp`
    (the eval route), K4's grouped MLP."""
    rsa = cfg.RCNN.SA_CONFIG
    n_prev = cfg.RCNN.NUM_POINTS
    out = {'fps_batched_kernel': 0.0}
    if mlp:
        out['grouped_gather_mlp_max_kernel'] = 0.0
    for k, m in enumerate(rsa.NPOINTS):
        if m <= 0:
            continue
        out['fps_batched_kernel'] += fps_s(rois, n_prev, m)
        if mlp:
            out['grouped_gather_mlp_max_kernel'] += grouped_mlp_s(
                rois, n_prev, m, rsa.NSAMPLE[k], list(rsa.MLPS[k]))
        n_prev = m
    return out


def _nms_s(problems: int, calls) -> float:
    """N1 over `problems` problems for each (candidates, kept) call: the
    candidates (6 floats a box, a score and an index) in, the keep buffer
    out."""
    return bound_s(0.0, sum(4.0 * problems * (8 * n + 2 * keep)
                            for n, keep in calls))


def _zones(mode) -> list:
    """The proposal layer's two N1 zones: the pre-NMS candidates and the
    kept ones split 70 / 30."""
    pre, post = mode.RPN_PRE_NMS_TOP_N, mode.RPN_POST_NMS_TOP_N
    return [(int(pre * 0.7), int(post * 0.7)),
            (pre - int(pre * 0.7), post - int(post * 0.7))]


def frame_bounds(cfg, streams: int) -> Dict[str, float]:
    """Least seconds per joint frame of `streams` streams (one lockstep
    frame) of each kernel name on the main path: the RPN, the RCNN at
    EVAL's RoIs with K2 and K4, N1's three calls (the two proposal zones
    and the final NMS), N2 and N3 over 64 track slots and 16 detections.
    `cfg` is the reference configuration of the cell."""
    b = streams
    post = cfg.EVAL.RPN_POST_NMS_TOP_N
    out = _rpn_bounds(cfg, b)
    out.update(_rcnn_bounds(cfg, b * post, mlp=True))
    out['nms'] = _nms_s(b, _zones(cfg.EVAL) + [(post, post)])
    t, d = 64, 16
    out['lap_kernel'] = bound_s(0.0, 4.0 * b * (t * d + t + d))
    out['kalman_predict_kernel'] = bound_s(0.0, 2 * 4.0 * b * t * 110)
    return out


def train_step_bounds(cfg, frames: int) -> Dict[str, float]:
    """Least seconds per finetune step over `frames` frames: the RPN (in
    eval mode), the RCNN's K2 over ROI_PER_IMAGE RoIs a frame (its MLPs
    train on tensor ops), N1's two TRAIN zones."""
    out = _rpn_bounds(cfg, frames)
    out.update(_rcnn_bounds(cfg, frames * cfg.RCNN.ROI_PER_IMAGE,
                            mlp=False))
    out['nms'] = _nms_s(frames, _zones(cfg.TRAIN))
    return out


def family(kernel_name: str):
    """The key of `frame_bounds` that a traced kernel name belongs to, or
    None for a kernel that is not hand-written."""
    if 'nms_mask_kernel' in kernel_name or 'nms_scan_kernel' in kernel_name:
        return 'nms'
    for key in ('fps_cluster_kernel', 'sa_consumer_kernel',
                'fps_batched_kernel', 'three_nn_kernel',
                'grouped_gather_mlp_max_kernel', 'd2s_kernel', 'lap_kernel',
                'kalman_predict_kernel'):
        if key in kernel_name:
            return key
    return None
