"""Ball query and neighborhood grouping (counterpart of
`jmodt_tpu/ops/grouping.py`).

Ball query takes, per centroid, the first `nsample` point indices (in point
order) with d2 < r^2, pads misses with the first hit, and gives a row with
no hit index 0.

d2 is (|q|^2 + |p|^2) - 2 q.p in float32, with each dot product and squared
norm rounded as a fused multiply-add chain: fma(z, z', fma(y, y', x x')).
That is the rounding the JAX package's float32 dot gets on the CPU, so the
two packages pick the same points even at the r^2 boundary, where the
cancellation in this expression leaves only a few bits.  The fma steps are
computed in float64 and rounded to float32 (a product of two float32 values
is exact in float64), which gives the same bits on the CPU and the GPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# cap on B * chunk * N distance elements per block
_D2_BUDGET = 16 * 1024 * 1024


def first_k_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the first k True entries along the last dim, ascending,
    padded with N where a row has fewer.  Ranks come from a cumulative sum,
    so no sort order is relied on.  (..., N) bool -> (..., k) int64."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    take = mask & (rank <= k)
    # every entry that is not taken lands in a spill column k, dropped below
    dst = torch.where(take, rank - 1, k).long()
    out = torch.full(mask.shape[:-1] + (k + 1,), n, dtype=torch.long,
                     device=mask.device)
    col = torch.arange(n, device=mask.device).expand(mask.shape)
    out.scatter_(-1, dst, col)
    return out[..., :k]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding (via float64)."""
    return (a.double() * b.double() + c.double()).float()


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) |p|^2 as an fma chain."""
    x, y, z = p.unbind(-1)
    return _fma(z, z, _fma(y, y, x * x))


def pairwise_d2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) x (B, N, 3) -> (B, M, N) (|q|^2 + |p|^2) - 2 q.p."""
    qx, qy, qz = (c[:, :, None] for c in q.unbind(-1))
    px, py, pz = (c[:, None, :] for c in p.unbind(-1))
    dot = _fma(qz, pz, _fma(qy, py, qx * px))
    return (_sq_norm(q)[:, :, None] + _sq_norm(p)[:, None, :]) - 2.0 * dot


def _first_k_in_radius(d2: torch.Tensor, r2: float, nsample: int
                       ) -> torch.Tensor:
    n = d2.shape[-1]
    idx = first_k_true(d2 < r2, nsample)
    first = idx[..., 0:1]
    fallback = torch.where(first >= n, torch.zeros_like(first), first)
    return torch.where(idx >= n, fallback, idx).to(torch.int32)


def ball_query_multi(radii: Sequence[float], nsamples: Sequence[int],
                     xyz: torch.Tensor, new_xyz: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """Ball query for several (radius, nsample) scales sharing one d2.

    :param xyz: (B, N, 3) all points; :param new_xyz: (B, M, 3) centroids
    :return: tuple of (B, M, nsamples[i]) int32, one per scale
    """
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    chunk = min(max(128, _D2_BUDGET // (b * n)), m)
    outs = [[] for _ in radii]
    for s in range(0, m, chunk):
        d2 = pairwise_d2(new_xyz[:, s:s + chunk], xyz)
        for i, (r, ns) in enumerate(zip(radii, nsamples)):
            outs[i].append(_first_k_in_radius(d2, r * r, ns))
    return tuple(torch.cat(o, dim=1) for o in outs)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """First-`nsample` neighbors within `radius` (strict d2 < r^2):
    (B, N, 3), (B, M, 3) -> (B, M, nsample) int32."""
    return ball_query_multi((radius,), (nsample,), xyz, new_xyz)[0]


def group_points_fl(features: torch.Tensor, idx: torch.Tensor
                    ) -> torch.Tensor:
    """Feature-last grouping: (B, N, C), idx (B, M, S) -> (B, M, S, C)."""
    b, n, c = features.shape
    _, m, s = idx.shape
    flat = torch.gather(features, 1,
                        idx.reshape(b, m * s, 1).long().expand(-1, -1, c))
    return flat.reshape(b, m, s, c)


def group_xyz(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Point-layout grouping: xyz (B, N, 3), idx (B, M, S) -> (B, M, S, 3)."""
    return group_points_fl(xyz, idx)
