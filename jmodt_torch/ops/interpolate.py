"""Three-nearest-neighbor interpolation (counterpart of
`jmodt_tpu/ops/interpolate.py`).

On a CUDA tensor `three_nn` launches K3 (`jmodt_torch/csrc/three_nn.cu`,
replaces `jmodt_tpu/ops/pallas/three_nn.py::three_nn_pallas`) at every FP
level; on a CPU tensor it runs `three_nn_plain`.  Both compute the direct
distance (dx*dx + dy*dy) + dz*dz, rounded after every operation, and rank
by (distance, index): among equal distances the lower index comes first.
K3 splits each query's known set over L lanes and gives each thread Q
queries; `three_nn_launch_plan` picks L, Q and the block size.  K3 has no
backward: with grad mode on it refuses CUDA coordinates that require grad
(RuntimeError); the FP levels' coordinates never do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jmodt_torch.ops import kernels
from jmodt_torch.utils.trace import spanned

_PLAIN_CHUNK = 4096   # queries per block of the plain version
# K3's launch plan: threads the grid should hold to fill an H100 (132 SMs,
# 16 warps each), queries a thread, lanes a query and block sizes it may take
K3_TARGET_THREADS = 65536
K3_QUERIES = (4, 2, 1)
K3_MAX_LANES = 32
K3_BLOCKS = (256, 128, 64)
K3_SMS = 132


class K3Plan(NamedTuple):
    lanes: int              # lanes sharing a query's known set
    queries: int            # queries a thread
    threads: int            # threads a block
    grid: tuple             # (blocks over N, B)


def three_nn_launch_plan(b: int, n: int, m: int) -> K3Plan:
    """K3's launch for B clouds of N queries and M known points.  More
    queries a thread (fewer shared-memory reads a pair) come first, then as
    few lanes a query (fewer merge steps) as give the grid
    `K3_TARGET_THREADS` threads; a lane keeps at least 2 known points.
    Where no choice reaches the target, 1 query a thread over the most
    lanes.  Blocks are as large as still give one block an SM."""
    if m < 3:
        raise ValueError(f'three_nn needs at least 3 known points, got {m}')
    if n < 1 or b < 1:
        raise ValueError(f'three_nn needs queries, got B={b}, N={n}')
    max_lanes = 1
    while max_lanes < K3_MAX_LANES and 4 * max_lanes <= m:
        max_lanes *= 2
    lanes, queries = max_lanes, 1
    for q in K3_QUERIES:
        fit = [ln for ln in (1, 2, 4, 8, 16, 32) if ln <= max_lanes
               and b * -(-n // q) * ln >= K3_TARGET_THREADS]
        if fit:
            lanes, queries = fit[0], q
            break
    threads = K3_BLOCKS[-1]
    for t in K3_BLOCKS:
        if b * -(-n * lanes // (t * queries)) >= K3_SMS:
            threads = t
            break
    per_block = threads // lanes * queries
    return K3Plan(lanes, queries, threads, (-(-n // per_block), b))


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor):
    """(B, N, 3), (B, M, 3) -> (dist (B, N, 3) euclidean, idx (B, N, 3)
    int32), as tensor ops over blocks of queries."""
    ds, ids = [], []
    kx, ky, kz = (c[:, None, :] for c in known.unbind(-1))
    for s in range(0, unknown.shape[1], _PLAIN_CHUNK):
        ux, uy, uz = (c[:, :, None]
                      for c in unknown[:, s:s + _PLAIN_CHUNK].unbind(-1))
        dx, dy, dz = kx - ux, ky - uy, kz - uz
        d = (dx * dx + dy * dy) + dz * dz                 # (B, n, M)
        # three min passes; argmin returns the first minimum, so equal
        # distances rank the lower index first
        dv, di = [], []
        for k in range(3):
            j = torch.argmin(d, dim=-1, keepdim=True)
            dv.append(d.gather(-1, j))
            di.append(j)
            if k < 2:
                d = d.scatter(-1, j, float('inf'))
        ds.append(torch.cat(dv, -1))
        ids.append(torch.cat(di, -1).to(torch.int32))
    return torch.sqrt(torch.cat(ds, 1)), torch.cat(ids, 1)


@spanned('jmodt.kernel.three_nn')
def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """3 nearest known points of each unknown point: (B, N, 3), (B, M, 3)
    -> (dist (B, N, 3), idx (B, N, 3) int32).  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if not kernels.on_card(unknown):
        return three_nn_plain(unknown, known)
    kernels.refuse_grad('three_nn (K3)', unknown, known)
    b, n, _ = unknown.shape
    m = known.shape[1]
    kernels.check_cuda('unknown', unknown, torch.float32, (None, None, 3))
    kernels.check_cuda('known', known, torch.float32, (b, None, 3))
    plan = three_nn_launch_plan(b, n, m)
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=unknown.device)
    kernels.launch('three_nn', unknown.data_ptr(), known.data_ptr(), b, n, m,
                   plan.lanes, plan.queries, plan.threads, dist.data_ptr(),
                   idx.data_ptr(), device=unknown.device)
    return dist, idx


def three_interpolate_fl(features: torch.Tensor, idx: torch.Tensor,
                         weight: torch.Tensor) -> torch.Tensor:
    """Feature-last weighted 3-point interpolation: features (B, M, C),
    idx/weight (B, N, 3) -> (B, N, C)."""
    b, m, c = features.shape
    n = idx.shape[1]
    gathered = torch.gather(
        features, 1, idx.reshape(b, n * 3, 1).long().expand(-1, -1, c)
    ).reshape(b, n, 3, c)
    return (gathered * weight[..., None]).sum(2)
