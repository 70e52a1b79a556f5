"""Farthest point sampling and index gathering (counterpart of
`jmodt_tpu/ops/sampling.py`).

On a CUDA tensor `farthest_point_sample` launches a hand-written kernel
(`jmodt_torch/csrc/fps.cu`): K2, 1, 2 or 4 warps a cloud with the cloud
staged in shared memory (replaces
`jmodt_tpu/ops/pallas/fps.py::farthest_point_sample_batched_pallas`), for
B > 1 clouds of at most 1024 points (the RCNN's RoI clouds), laid out by
`fps_batched_launch_plan`; K1, one
thread-block cluster a cloud (replaces `farthest_point_sample_pallas`), for
every other batch and size up to `FPS_MAX_POINTS` (the RPN's level 0 at
any number of streams), laid out by `fps_launch_plan`.  On a CPU tensor
it runs `farthest_point_sample_plain`, the same arithmetic as a loop of
tensor ops, which is also what the kernels are checked against on the card.

Semantics: idx[:, 0] = 0; the running min-distance starts at 1e10; each
step takes the argmax of the min-distance, ties to the smallest index.
Distances are (dx*dx + dy*dy) + dz*dz rounded after every operation (no
fused multiply-add), so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from jmodt_torch.ops import kernels
from jmodt_torch.utils.trace import spanned

# K1 keeps each point in one thread's registers (fps.cuh): a block takes
# up to 1024 points, with 128 threads while that is 8 points a thread or
# fewer, and a cluster up to 16 blocks; past 16384 points a block grows to
# 1024 threads of 8 points each
FPS_THREADS = 128
FPS_MAX_THREADS = 1024
FPS_MAX_PPT = 8
FPS_BLOCK_POINTS = FPS_THREADS * FPS_MAX_PPT
FPS_MAX_CLUSTER = 16
FPS_MAX_POINTS = FPS_MAX_CLUSTER * FPS_MAX_THREADS * FPS_MAX_PPT
# K2 keeps each cloud in the registers of 1, 2 or 4 warps, at most 32
# points a lane, in blocks of 4 warps
FPS_WARP_MAX_POINTS = 32 * 32
K2_BLOCK_WARPS = 4
K2_SMS = 132            # SMs of an H100, 4 sub-partitions each


def farthest_point_sample_plain(xyz: torch.Tensor, npoint: int
                                ) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32, a loop of tensor ops."""
    b, n, _ = xyz.shape
    x, y, z = (c.contiguous() for c in xyz.float().unbind(-1))
    mind = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((b, 1), dtype=torch.long, device=xyz.device)
    for t in range(1, npoint):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        d = (dx * dx + dy * dy) + dz * dz
        mind = torch.minimum(mind, d)
        last = torch.argmax(mind, dim=1, keepdim=True)   # first maximum
        idx[:, t] = last[:, 0].to(torch.int32)
    return idx


def fps_launch_plan(n: int, max_cluster: int = FPS_MAX_CLUSTER):
    """K1's launch for a cloud of n points: (blocks a cluster, threads a
    block, points a thread).  The cluster takes one block per 1024 points up
    to `max_cluster` (what the card can place); a block's share of the cloud
    goes to 128 threads (fewer for a small cloud), more when that would be
    over 8 points a thread, and a thread holds the power of two of points
    that covers the rest.  Every block holds at least one point.  Fewer
    threads a block make the block's barrier and argmax shorter, and a step
    measured shortest on an H100 at 128."""
    if n < 1:
        raise ValueError(f'K1 needs a point, got N={n}')
    blocks = min(-(-n // FPS_BLOCK_POINTS), max_cluster)
    share = -(-n // blocks)
    need = max(min(share, FPS_THREADS), -(-share // FPS_MAX_PPT))
    threads = 32 * -(-need // 32)
    if threads > FPS_MAX_THREADS:
        raise ValueError(f'K1 holds at most {FPS_MAX_THREADS * FPS_MAX_PPT} '
                         f'points a block in registers, got N={n} over '
                         f'{max_cluster} blocks')
    ppt = 1
    while threads * ppt < share:
        ppt *= 2
    return -(-n // (threads * ppt)), threads, ppt


def fps_batched_launch_plan(b: int, n: int):
    """K2's launch for b clouds of n points: (warps a cloud, clouds a
    block, points a lane).  A cloud takes 4 warps, one on each
    sub-partition of an SM of its own, where there are no more clouds than
    SMs and the cloud gives a lane more than 2 points; else 1 warp.  A
    block of 4 warps holds 4 / warps clouds, and a lane the power of two
    of points that covers its share.  On an H100 this was the fastest of
    1, 2 and 4 warps at the RCNN's shapes, S = 1 and 4 (PERF.md,
    chip_smoke's sweep)."""
    if not 1 <= n <= FPS_WARP_MAX_POINTS:
        raise ValueError(f'K2 takes 1..{FPS_WARP_MAX_POINTS} points a '
                         f'cloud, got N={n}')
    if b < 1:
        raise ValueError(f'K2 needs a cloud, got B={b}')
    warps = K2_BLOCK_WARPS if b <= K2_SMS and n > 2 * 32 * 4 else 1
    ppt = 1
    while 32 * warps * ppt < n:
        ppt *= 2
    return warps, K2_BLOCK_WARPS // warps, ppt


@spanned('jmodt.kernel.fps')
def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative farthest point sampling, (B, N, 3) f32 -> (B, npoint)
    int32.  CPU tensors take the plain version; CUDA tensors the kernel."""
    if not kernels.on_card(xyz):
        return farthest_point_sample_plain(xyz, npoint)
    b, n, _ = xyz.shape
    kernels.check_cuda('xyz', xyz, torch.float32, (None, None, 3))
    if not 1 <= npoint <= n:
        raise ValueError(f'npoint={npoint} must be in [1, N={n}]')
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    if b > 1 and n <= FPS_WARP_MAX_POINTS:
        warps, _, ppt = fps_batched_launch_plan(b, n)
        kernels.launch('fps_batched', xyz.data_ptr(), b, n, npoint, warps,
                       ppt, out.data_ptr(), device=xyz.device)
    else:
        csize, threads, ppt = fps_launch_plan(n, kernels.fps_max_cluster())
        kernels.launch('fps', xyz.data_ptr(), b, n, npoint, csize, threads,
                       ppt, out.data_ptr(), device=xyz.device)
    return out


def gather_xyz(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Point-layout gather: xyz (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(xyz, 1, idx.long()[:, :, None].expand(
        -1, -1, xyz.shape[-1]))
