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


# K1 keeps each point in one thread's registers (fps.cuh): a block takes
# up to 1024 points, with 128 threads while that is 8 points a thread or
# fewer, and a cluster up to 16 blocks; past 16384 points a block grows to
# 1024 threads of 8 points each
# K2 keeps each cloud in the registers of 1, 2 or 4 warps, at most 32
# points a lane, in blocks of 4 warps


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



def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative farthest point sampling, (B, N, 3) f32 -> (B, npoint)
    int32, the plain version on every device."""
    return farthest_point_sample_plain(xyz, npoint)


def gather_xyz(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Point-layout gather: xyz (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(xyz, 1, idx.long()[:, :, None].expand(
        -1, -1, xyz.shape[-1]))
