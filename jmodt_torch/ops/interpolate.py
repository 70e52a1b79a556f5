"""Three-nearest-neighbor interpolation (counterpart of
`jmodt_tpu/ops/interpolate.py`).

On a CUDA tensor `three_nn` launches K3 (`jmodt_torch/csrc/three_nn.cu`,
replaces `jmodt_tpu/ops/pallas/three_nn.py::three_nn_pallas`) at every FP
level; on a CPU tensor it runs `three_nn_plain`.  Both compute the direct
distance (dx*dx + dy*dy) + dz*dz, rounded after every operation, and rank
by (distance, index): among equal distances the lower index comes first.
"""

from __future__ import annotations

import torch

from jmodt_torch.ops import kernels

_PLAIN_CHUNK = 4096   # queries per block of the plain version


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


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """3 nearest known points of each unknown point: (B, N, 3), (B, M, 3)
    -> (dist (B, N, 3), idx (B, N, 3) int32).  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if not unknown.is_cuda:
        return three_nn_plain(unknown, known)
    b, n, _ = unknown.shape
    m = known.shape[1]
    kernels.check_cuda('unknown', unknown, torch.float32, (None, None, 3))
    kernels.check_cuda('known', known, torch.float32, (b, None, 3))
    if m < 3:
        raise ValueError(f'three_nn needs at least 3 known points, got {m}')
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=unknown.device)
    kernels.launch('three_nn', 'jmodt_three_nn', unknown.data_ptr(),
                   known.data_ptr(), b, n, m, dist.data_ptr(),
                   idx.data_ptr())
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
