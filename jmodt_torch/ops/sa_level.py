"""A whole set-abstraction level in one call (counterpart of
`jmodt_tpu/ops/pallas/sa_level.py`): FPS, multi-scale ball query, the
hoisted first layer, gather, folded MLP and max-pool, for use_xyz levels on
eval (BatchNorm-folded) weights.

On a CUDA tensor `sa_level_fused` launches K5 (`jmodt_torch/csrc/
sa_level.cu`, replaces `jmodt_tpu/ops/pallas/sa_level.py::sa_level_fused`),
which computes every part of the level in its own code: K1's FPS grid,
publishing its centres chunk by chunk, and one consumer grid beside it
that builds the layer-1 tables, then queries and pools each chunk of
centres as it comes.  The wrapper checks its arguments, lays the two grids
out (`k5_launch_plan`) and allocates outputs, scratch and the zeroed
counters the consumer grid synchronises through.  On a CPU tensor it
runs `sa_level_fused_plain`, the composition of the port's plain ops
(the counterpart of the JAX package's `sa_level_fused_xla`).  K5 has no
backward: with grad mode on it refuses a CUDA input that requires grad
(RuntimeError), as the JAX package never takes it under autodiff.  Always
float32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from jmodt_torch.ops import kernels
from jmodt_torch.ops.fused_sa import (Layers, check_weight_aligned,
                                      grouped_gather_mlp_max_plain,
                                      k4_launch_plan)
from jmodt_torch.ops.grouping import ball_query_multi_plain
from jmodt_torch.ops.sampling import (FPS_MAX_CLUSTER,
                                      farthest_point_sample_plain,
                                      fps_launch_plan, gather_xyz)
from jmodt_torch.utils.trace import spanned

# limits of the CUDA entry (sa_level.cu): scales, layers per scale, the
# 64-row MLP tiles of grouped_mlp.cuh, 32 x 32 table tiles, 8 query warps a
# block, and the shared memory a block may have, which must hold the
# cloud's coordinates for the query (12 bytes a point)
_K5_MAX_SCALES = 4
_K5_MAX_LAYERS = 5
_K5_ROWS = 64
_K5_TABLE_TILE = 32
_K5_QUERY_WARPS = 8
_K5_SMEM_LIMIT = 232448 - 1024
# FPS publishes its centres in chunks of a multiple of 16 (so every
# scale's 64 / S centres a block and the query blocks tile a chunk), about
# 16 chunks a cloud
_K5_CHUNK_ALIGN = 16
_K5_CHUNKS = 16
# an H100's SMs and each SM's shared memory (less 1 KB a block for the
# system and a margin for the consumer's static bytes): the consumer grid
# takes every SM that FPS leaves, with two blocks where half of it holds
# the MLP's shared memory
_K5_SMS = 132
_K5_HALF_SM_SMEM = 233472 // 2 - 1024 - 256


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
    nbrs = ball_query_multi_plain(tuple(radii), tuple(nsamples), xyz,
                                  new_xyz)
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
    scale, the widths [3 + C, C1, .., CL]; raise ValueError on what the
    CUDA entry does not take."""
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
    widths_per_scale = []
    for si, layers in enumerate(folded_per_scale):
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
        widths_per_scale.append(widths)
    k5_launch_plan(b, n, npoint, nsamples, widths_per_scale)
    return widths_per_scale


class K5Plan(NamedTuple):
    fps: Tuple[int, int, int]     # K1's plan: blocks, threads, points a thread
    chunk: int                    # centres FPS publishes at a time
    chunks: int                   # chunks a cloud
    consumers: int                # consumer blocks
    per_sm: int                   # consumer blocks an SM (1 or 2)
    col_splits: Tuple[int, ...]   # blocks sharing each scale's last layer
    table_tiles: int              # 64 x 64 layer-1 table tiles, all scales
    query_units: int              # query blocks a chunk, 8 centres each
    mlp_units: Tuple[int, ...]    # each scale's MLP blocks a chunk
    tickets: int                  # work items of the consumer grid
    smem: Tuple[int, ...]         # each scale's MLP shared memory, bytes
    counters: int                 # int32 counters, zeroed by the wrapper


def k5_launch_plan(b: int, n: int, npoint: int, nsamples: Sequence[int],
                   widths: Sequence[Sequence[int]],
                   max_cluster: int = FPS_MAX_CLUSTER,
                   sms: int = _K5_SMS) -> K5Plan:
    """K5's two grids for B clouds of N points, M = npoint centres, per
    scale S and widths [3 + C, C1, .., CL].  FPS runs K1's plan and
    publishes every `chunk` centres (a multiple of 16, about 16 chunks a
    cloud).  The consumer grid has one block on each SM the FPS clusters
    leave, two where half an SM's shared memory holds every scale's MLP
    and the cloud, and at most one a ticket.  All scales' MLP units share that grid, so
    their column split is chosen together: the largest split (capped by
    each scale's 128-column passes) whose units still fit one block each.
    The counters are the next ticket, the table tiles done and each
    (cloud, chunk)'s query units done.  Raises
    ValueError on what the kernel does not take."""
    if not 1 <= npoint <= n:
        raise ValueError(f'npoint={npoint} must be in [1, N={n}]')
    if 12 * n > _K5_SMEM_LIMIT:
        raise ValueError(f'K5 stages the cloud in shared memory: at most '
                         f'{_K5_SMEM_LIMIT // 12} points, got N={n}')
    if not 1 <= len(nsamples) == len(widths) <= _K5_MAX_SCALES:
        raise ValueError(f'K5 takes 1..{_K5_MAX_SCALES} scales, got '
                         f'{len(nsamples)} nsamples and {len(widths)} MLPs')
    k4 = []
    for ns, w in zip(nsamples, widths):
        if ns < 4 or ns % 4 or _K5_ROWS % ns:
            raise ValueError(f'K5 needs nsample a multiple of 4 dividing '
                             f'{_K5_ROWS}, got {ns}')
        if not 3 <= len(w) <= _K5_MAX_LAYERS + 1:
            raise ValueError(f'K5 takes 2..{_K5_MAX_LAYERS} MLP layers a '
                             f'scale, got {len(w) - 1}')
        k4.append(k4_launch_plan(b, npoint, ns, w[1:]))
    fps = fps_launch_plan(n, max_cluster)
    chunk = _K5_CHUNK_ALIGN * -(-npoint // (_K5_CHUNK_ALIGN * _K5_CHUNKS))
    chunks = -(-npoint // chunk)
    smem = [p.smem for p in k4]
    per_sm = 2 if max(smem + [12 * n]) <= _K5_HALF_SM_SMEM else 1
    free = per_sm * max(1, sms - b * fps[0])
    blocks = [b * -(-npoint // p.centres) for p in k4]
    split = 1
    while (split < max(p.passes[-1] for p in k4)
           and sum(nb * min(split + 1, p.passes[-1])
                   for nb, p in zip(blocks, k4)) <= free):
        split += 1
    col_splits = tuple(min(split, p.passes[-1]) for p in k4)
    row_tiles = -(-b * n // _K5_TABLE_TILE)
    table_tiles = row_tiles * sum(-(-w[1] // _K5_TABLE_TILE) for w in widths)
    query_units = chunk // _K5_QUERY_WARPS
    mlp_units = tuple(chunk // p.centres * z for p, z in zip(k4, col_splits))
    tickets = table_tiles + b * chunks * (query_units + sum(mlp_units))
    return K5Plan(fps, chunk, chunks, min(free, tickets), per_sm, col_splits,
                  table_tiles, query_units, mlp_units, tickets,
                  tuple(smem), 2 + b * chunks)


@spanned('jmodt.kernel.sa_level')
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
    if not kernels.on_card(xyz):
        return sa_level_fused_plain(xyz, feats, npoint, radii, nsamples,
                                    folded_per_scale)
    kernels.refuse_grad('sa_level_fused (K5)', xyz, feats,
                        *(t for layers in folded_per_scale
                          for layer in layers for t in layer))
    widths = _k5_plan(xyz, feats, npoint, radii, nsamples, folded_per_scale)
    b, n, _ = xyz.shape
    dev = xyz.device
    plan = k5_launch_plan(
        b, n, npoint, nsamples, widths, kernels.fps_max_cluster(),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    nscales = len(widths)
    dims = np.zeros((nscales, _K5_MAX_LAYERS + 1), np.int32)
    n_layers = np.array([len(w) - 1 for w in widths], np.int32)
    smem = np.array(plan.smem, np.int32)
    col_splits = np.array(plan.col_splits, np.int32)
    w_ptrs = (ctypes.c_void_p * (nscales * _K5_MAX_LAYERS))()
    b_ptrs = (ctypes.c_void_p * (nscales * _K5_MAX_LAYERS))()
    tables, cxws, nbrs = [], [], []
    for si, (ns, layers, w) in enumerate(zip(nsamples, folded_per_scale,
                                             widths)):
        dims[si, :len(w)] = w
        for li, (wt, bias) in enumerate(layers):
            w_ptrs[si * _K5_MAX_LAYERS + li] = wt.data_ptr()
            b_ptrs[si * _K5_MAX_LAYERS + li] = bias.data_ptr()
        tables.append(torch.empty((b, n, w[1]), dtype=torch.float32,
                                  device=dev))
        cxws.append(torch.empty((b, npoint, w[1]), dtype=torch.float32,
                                device=dev))
        nbrs.append(torch.empty((b, npoint, ns), dtype=torch.int32,
                                device=dev))
    counters = torch.zeros(plan.counters, dtype=torch.int32, device=dev)
    # the consumer grid polls idx until FPS has written each centre
    idx = torch.full((b, npoint), -1, dtype=torch.int32, device=dev)
    new_xyz = torch.empty((b, npoint, 3), dtype=torch.float32, device=dev)
    pooled = torch.empty((b, npoint, sum(w[-1] for w in widths)),
                         dtype=torch.float32, device=dev)
    # r^2 as the plain version's `d2 < r * r` compares it: in float32
    radii2 = np.array([r * r for r in radii], np.float32)
    ns_arr = np.array(nsamples, np.int32)     # host arrays live past the call
    ptrs = ctypes.c_void_p * nscales
    kernels.launch(
        'sa_level', xyz.data_ptr(),
        None if feats is None else feats.data_ptr(), b, n,
        widths[0][0] - 3, npoint, *plan.fps, plan.chunk, plan.consumers,
        plan.per_sm, nscales, radii2.ctypes.data, ns_arr.ctypes.data,
        n_layers.ctypes.data, dims.ctypes.data, w_ptrs, b_ptrs,
        smem.ctypes.data, col_splits.ctypes.data,
        ptrs(*[t.data_ptr() for t in tables]),
        ptrs(*[t.data_ptr() for t in cxws]),
        ptrs(*[t.data_ptr() for t in nbrs]), counters.data_ptr(),
        idx.data_ptr(), new_xyz.data_ptr(), pooled.data_ptr(), device=dev)
    return new_xyz, pooled, idx
