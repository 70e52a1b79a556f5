"""PointNet++ set-abstraction and feature-propagation modules (counterpart
of `jmodt_tpu/models/pointnet2.py`).  Feature-last (B, N, C) throughout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from perfbench.reference.models.layers import PointwiseMLP
from perfbench.reference.ops.grouping import (ball_query_multi, group_points_fl,
                                      group_xyz)
from perfbench.reference.ops.interpolate import three_interpolate_fl, three_nn
from perfbench.reference.ops.sampling import farthest_point_sample, gather_xyz
from perfbench.reference.parallel import mesh


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction.

    forward(xyz (B, N, 3), features (B, N, C) | None, fused) ->
        new_xyz (B, npoint, 3), new_features (B, npoint, sum(mlps[-1])),
        idx (B, npoint) FPS indices.  With npoint None the whole cloud is
        one group (GroupAll): new_xyz and idx are None and new_features is
        (B, 1, C').

    `fused` and `mega` are accepted and ignored: in this reference every
    level takes the plain path (FPS, ball query, grouped MLP, max-pool).

    In the points region of a (data, points) mesh (`parallel.mesh`) xyz
    and features are this rank's slice of the cloud: the level gathers the
    whole cloud over the points group, samples it (the one-process
    indices, the same on every rank), and keeps the contiguous npoint / sp
    of the centres in FPS order that are this rank's, which it groups
    against the whole cloud; idx then indexes the whole cloud.
    """

    def __init__(self, npoint: Optional[int], radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 cin: int, use_xyz: bool = True, use_bn: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        assert len(radii) == len(nsamples) == len(mlps)
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        self.use_bn = use_bn
        self.dtype = dtype
        for i, mlp in enumerate(mlps):
            self.add_module(f'mlp_{i}', PointwiseMLP(
                cin + 3 * int(use_xyz), mlp, use_bn=use_bn, dtype=dtype,
                device=device))

    def _mlps(self):
        return [getattr(self, f'mlp_{i}') for i in range(len(self.radii))]

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                fused: bool = False, mega: bool = False):
        if self.npoint is None:
            return None, self._group_all(xyz, features), None
        part = mesh.points_split()
        if part is not None:
            if self.npoint % part[1]:
                raise ValueError(f'an SA level of {self.npoint} centres '
                                 f'does not split over {part[1]} points '
                                 'ranks')
            xyz = mesh.gather_points(xyz)
            features = mesh.gather_points(features)
        idx = _own_centres(farthest_point_sample(xyz, self.npoint), part)
        new_xyz = gather_xyz(xyz, idx)
        nbrs = ball_query_multi(self.radii, self.nsamples, xyz, new_xyz)
        cdt = self.dtype
        outs = []
        for nbr, mlp in zip(nbrs, self._mlps()):
            g = (group_xyz(xyz, nbr) - new_xyz[:, :, None, :]).to(cdt)
            if features is not None:
                grouped = group_points_fl(features, nbr).to(cdt)
                g = torch.cat([g, grouped], dim=-1) if self.use_xyz \
                    else grouped
            outs.append(mlp(g).amax(dim=2))      # max-pool over samples
        return new_xyz, torch.cat(outs, dim=-1), idx

    def _group_all(self, xyz, features):
        cdt = self.dtype
        g = xyz[:, None, :, :].to(cdt)                    # (B, 1, N, 3)
        if features is not None:
            f = features[:, None].to(cdt)
            g = torch.cat([g, f], dim=-1) if self.use_xyz else f
        return torch.cat([mlp(g).amax(dim=2) for mlp in self._mlps()],
                         dim=-1)


def _own_centres(t: torch.Tensor, part) -> torch.Tensor:
    """This points rank's contiguous share of the centres (dim 1) of `t`;
    all of them outside a points split (`part` None)."""
    if part is None:
        return t
    r, sp = part
    m = t.shape[1] // sp
    return t[:, r * m:(r + 1) * m]


class FPModule(nn.Module):
    """Feature propagation: inverse-distance-weighted 3-NN interpolation,
    skip concat, shared MLP.  forward(unknown (B, n, 3), known (B, m, 3),
    unknown_feats (B, n, C1) | None, known_feats (B, m, C2)) ->
    (B, n, mlp[-1]).  In the points region the queries are this rank's
    slice of the finer level and the known set is gathered whole."""

    def __init__(self, cin: int, mlp: Sequence[int], use_bn: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.add_module('PointwiseMLP_0', PointwiseMLP(
            cin, mlp, use_bn=use_bn, dtype=dtype, device=device))

    def forward(self, unknown, known, unknown_feats, known_feats):
        cdt = self.dtype
        if mesh.points_split() is not None:
            known = mesh.gather_points(known)
            known_feats = mesh.gather_points(known_feats)
        # 3-NN distances and weights on float32 coordinates
        dist, idx = three_nn(unknown, known)
        recip = 1.0 / (dist + 1e-8)
        weight = recip / recip.sum(2, keepdim=True)
        new = three_interpolate_fl(known_feats.to(cdt), idx, weight.to(cdt))
        if unknown_feats is not None:
            new = torch.cat([new, unknown_feats.to(cdt)], dim=-1)
        return self.PointwiseMLP_0(new)
