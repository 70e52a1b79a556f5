"""A whole set-abstraction level in one call (counterpart of
`jmodt_tpu/ops/pallas/sa_level.py`): FPS, multi-scale ball query, the
hoisted first layer, gather, folded MLP and max-pool, for use_xyz levels on
eval (BatchNorm-folded) weights.

On a CUDA tensor `sa_level_fused` launches K5 (`jmodt_torch/csrc/
sa_level.cu`, replaces `jmodt_tpu/ops/pallas/sa_level.py::sa_level_fused`),
which computes every part of the level in its own code; the wrapper only
checks its arguments and allocates outputs and scratch.  On a CPU tensor it
runs `sa_level_fused_plain`, the composition of the port's plain ops
(the counterpart of the JAX package's `sa_level_fused_xla`).  Always
float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from jmodt_torch.ops import kernels
from jmodt_torch.ops.fused_sa import (Layers, check_weight_aligned,
                                      grouped_gather_mlp_max_plain,
                                      k4_launch_plan)
from jmodt_torch.ops.grouping import ball_query_multi
from jmodt_torch.ops.sampling import (FPS_MAX_POINTS,
                                      farthest_point_sample_plain,
                                      fps_launch_plan, gather_xyz)

# limits of the CUDA entry (sa_level.cu): scales, layers per scale, and
# the 64-row MLP tiles of grouped_mlp.cuh
_K5_MAX_SCALES = 4
_K5_MAX_LAYERS = 5
_K5_ROWS = 64


def _catf(xyz: torch.Tensor, feats: Optional[torch.Tensor]) -> torch.Tensor:
    return xyz if feats is None else torch.cat([xyz, feats.float()], dim=-1)


def sa_level_fused_plain(xyz: torch.Tensor, feats: Optional[torch.Tensor],
                         npoint: int, radii: Sequence[float],
                         nsamples: Sequence[int],
                         folded_per_scale: Sequence[Layers]):
    """The level as a composition of plain tensor ops: FPS, gather, one
    shared d2 for all scales' ball queries, then per scale the hoisted
    layer 1 (catf @ W1, new_xyz @ W1[:3]) and the grouped MLP + max.
    Returns (new_xyz (B, M, 3), pooled (B, M, sum C_last), idx (B, M))."""
    idx = farthest_point_sample_plain(xyz, npoint)
    new_xyz = gather_xyz(xyz, idx)
    nbrs = ball_query_multi(tuple(radii), tuple(nsamples), xyz, new_xyz)
    catf = _catf(xyz, feats)
    outs = []
    for nbr, layers in zip(nbrs, folded_per_scale):
        (w1, b1), rest = layers[0], layers[1:]
        feats1 = torch.matmul(catf, w1)
        cxw = torch.matmul(new_xyz, w1[:3])
        outs.append(grouped_gather_mlp_max_plain(feats1, nbr, cxw, b1, rest))
    return new_xyz, torch.cat(outs, dim=-1), idx


def _k5_plan(xyz: torch.Tensor, feats: Optional[torch.Tensor], npoint: int,
             radii: Sequence[float], nsamples: Sequence[int],
             folded_per_scale: Sequence[Layers], check=kernels.check_cuda):
    """Check K5's arguments with `check` (per tensor) and return, per
    scale, the widths [3 + C, C1, .., CL] and the MLP phase's launch plan
    (`k4_launch_plan`); raise ValueError on what the CUDA entry does not
    take."""
    b, n, _ = xyz.shape
    check('xyz', xyz, torch.float32, (b, n, 3))
    c = 0
    if feats is not None:
        c = feats.shape[-1]
        check('feats', feats, torch.float32, (b, n, c))
    if not (1 <= len(radii) <= _K5_MAX_SCALES
            and len(nsamples) == len(folded_per_scale) == len(radii)):
        raise ValueError(f'K5 takes 1..{_K5_MAX_SCALES} scales with one '
                         f'nsample and one MLP each, got {len(radii)} radii, '
                         f'{len(nsamples)} nsamples, '
                         f'{len(folded_per_scale)} MLPs')
    if not 1 <= npoint <= n:
        raise ValueError(f'npoint={npoint} must be in [1, N={n}]')
    if n > FPS_MAX_POINTS:
        raise ValueError(f'K5 FPS holds at most {FPS_MAX_POINTS} points in '
                         f'registers, got N={n}')
    plan = []
    for si, (ns, layers) in enumerate(zip(nsamples, folded_per_scale)):
        if ns < 4 or ns % 4 or _K5_ROWS % ns:
            raise ValueError(f'K5 needs nsample a multiple of 4 dividing '
                             f'{_K5_ROWS}, got {ns}')
        if not 2 <= len(layers) <= _K5_MAX_LAYERS:
            raise ValueError(f'K5 takes 2..{_K5_MAX_LAYERS} MLP layers a '
                             f'scale, got {len(layers)}')
        widths = [3 + c]
        for li, (w, bias) in enumerate(layers):
            check(f'scale {si} W{li + 1}', w, torch.float32,
                  (widths[-1], None))
            check(f'scale {si} b{li + 1}', bias, torch.float32,
                  (w.shape[1],))
            if li > 0:
                check_weight_aligned(f'scale {si} W{li + 1}', w)
            widths.append(w.shape[1])
        plan.append((widths, k4_launch_plan(b, npoint, ns, widths[1:])))
    return plan


def sa_level_fused(xyz: torch.Tensor, feats: Optional[torch.Tensor],
                   npoint: int, radii: Sequence[float],
                   nsamples: Sequence[int],
                   folded_per_scale: Sequence[Layers]):
    """K5 on a CUDA tensor, the plain version on a CPU tensor.

    :param xyz: (B, N, 3) f32; :param feats: (B, N, C) f32 or None
    :param folded_per_scale: per scale, the folded (W (Cin, Cout), b (Cout,))
        layers (`fold_pointwise_mlp`), W1 of shape (3 + C, C1)
    :return: (new_xyz (B, M, 3) f32, pooled (B, M, sum C_last) f32,
        idx (B, M) int32)
    """
    if not xyz.is_cuda:
        return sa_level_fused_plain(xyz, feats, npoint, radii, nsamples,
                                    folded_per_scale)
    plan = _k5_plan(xyz, feats, npoint, radii, nsamples, folded_per_scale)
    b, n, _ = xyz.shape
    fps_plan = fps_launch_plan(n, kernels.fps_max_cluster())
    nscales = len(plan)
    dev = xyz.device
    dims = np.zeros((nscales, _K5_MAX_LAYERS + 1), np.int32)
    n_layers = np.array([len(w) - 1 for w, _ in plan], np.int32)
    smem = np.array([k4.smem for _, k4 in plan], np.int32)
    col_splits = np.array([k4.col_split for _, k4 in plan], np.int32)
    w_ptrs = (ctypes.c_void_p * (nscales * _K5_MAX_LAYERS))()
    b_ptrs = (ctypes.c_void_p * (nscales * _K5_MAX_LAYERS))()
    tables, cxws, nbrs = [], [], []
    for si, (ns, layers, (widths, _)) in enumerate(
            zip(nsamples, folded_per_scale, plan)):
        dims[si, :len(widths)] = widths
        for li, (w, bias) in enumerate(layers):
            w_ptrs[si * _K5_MAX_LAYERS + li] = w.data_ptr()
            b_ptrs[si * _K5_MAX_LAYERS + li] = bias.data_ptr()
        tables.append(torch.empty((b, n, widths[1]), dtype=torch.float32,
                                  device=dev))
        cxws.append(torch.empty((b, npoint, widths[1]), dtype=torch.float32,
                                device=dev))
        nbrs.append(torch.empty((b, npoint, ns), dtype=torch.int32,
                                device=dev))
    idx = torch.empty((b, npoint), dtype=torch.int32, device=dev)
    new_xyz = torch.empty((b, npoint, 3), dtype=torch.float32, device=dev)
    pooled = torch.empty((b, npoint, sum(w[-1] for w, _ in plan)),
                         dtype=torch.float32, device=dev)
    # r^2 as the plain version's `d2 < r * r` compares it: in float32
    radii2 = np.array([r * r for r in radii], np.float32)
    ns_arr = np.array(nsamples, np.int32)     # host arrays live past the call
    ptrs = ctypes.c_void_p * nscales
    kernels.launch(
        'sa_level', 'jmodt_sa_level', xyz.data_ptr(),
        None if feats is None else feats.data_ptr(), b, n,
        plan[0][0][0] - 3, npoint, *fps_plan, nscales, radii2.ctypes.data,
        ns_arr.ctypes.data, n_layers.ctypes.data, dims.ctypes.data, w_ptrs,
        b_ptrs, smem.ctypes.data, col_splits.ctypes.data,
        ptrs(*[t.data_ptr() for t in tables]),
        ptrs(*[t.data_ptr() for t in cxws]),
        ptrs(*[t.data_ptr() for t in nbrs]), idx.data_ptr(),
        new_xyz.data_ptr(), pooled.data_ptr())
    return new_xyz, pooled, idx
