"""PointNet++ set-abstraction and feature-propagation modules (counterpart
of `jmodt_tpu/models/pointnet2.py`).  Feature-last (B, N, C) throughout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from jmodt_torch.models.layers import PointwiseMLP
from jmodt_torch.ops.fused_sa import fold_pointwise_mlp, fused_sa_eval
from jmodt_torch.ops.grouping import (ball_query_multi, group_points_fl,
                                      group_xyz)
from jmodt_torch.ops.interpolate import three_interpolate_fl, three_nn
from jmodt_torch.ops.sa_level import sa_level_fused
from jmodt_torch.ops.sampling import farthest_point_sample, gather_xyz


def sa_route(training: bool, under_grad: bool, use_bn: bool, mega: bool,
             fused: bool) -> str:
    """Which path an SA level takes: the JAX package's gate
    (`jmodt_tpu/models/pointnet2.py:58-59, 121-122, 134`).

    'mega' is the whole level in one call (K5), eval only and never under
    autograd; 'fused_kernel' the BN-folded path through K4; 'fused_plain'
    the same folded math as tensor ops, which autograd differentiates (the
    JAX package's `use_pallas=False`), taken in training without BN or
    under autograd; 'plain' the unfused path, which training with BN
    needs.  `mega` and `fused` are the level's flags."""
    if mega and not training and not under_grad:
        return 'mega'
    if fused and (not training or not use_bn):
        return 'fused_plain' if training or under_grad else 'fused_kernel'
    return 'plain'


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction.

    forward(xyz (B, N, 3), features (B, N, C) | None, fused) ->
        new_xyz (B, npoint, 3), new_features (B, npoint, sum(mlps[-1])),
        idx (B, npoint) FPS indices.  With npoint None the whole cloud is
        one group (GroupAll): new_xyz and idx are None and new_features is
        (B, 1, C').

    `fused` takes the BN-folded gather->MLP->max path (ops/fused_sa.py,
    always float32) for each scale; it needs npoint and use_xyz.  `mega`
    runs the whole level, FPS included, in one call (ops/sa_level.py, K5
    on the card, always float32); it takes precedence over `fused` and has
    the same needs.  `sa_route` decides with the module's training flag and
    whether autograd records the call: grad mode on, and a parameter or a
    float input requiring grad.
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
        under_grad = torch.is_grad_enabled() and (
            xyz.requires_grad
            or (features is not None and features.requires_grad)
            or any(p.requires_grad for p in self.parameters()))
        route = sa_route(self.training, under_grad, self.use_bn,
                         mega and self.use_xyz, fused and self.use_xyz)
        if route == 'mega':
            return sa_level_fused(
                xyz.contiguous(),
                None if features is None else features.float().contiguous(),
                self.npoint, self.radii, self.nsamples,
                [fold_pointwise_mlp(mlp) for mlp in self._mlps()])
        idx = farthest_point_sample(xyz, self.npoint)
        new_xyz = gather_xyz(xyz, idx)
        nbrs = ball_query_multi(self.radii, self.nsamples, xyz, new_xyz)
        if route != 'plain':
            outs = [fused_sa_eval(xyz, features, new_xyz, nbr,
                                  fold_pointwise_mlp(mlp),
                                  use_kernel=route == 'fused_kernel')
                    for nbr, mlp in zip(nbrs, self._mlps())]
            return new_xyz, torch.cat(outs, dim=-1), idx
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


class FPModule(nn.Module):
    """Feature propagation: inverse-distance-weighted 3-NN interpolation,
    skip concat, shared MLP.  forward(unknown (B, n, 3), known (B, m, 3),
    unknown_feats (B, n, C1) | None, known_feats (B, m, C2)) ->
    (B, n, mlp[-1])."""

    def __init__(self, cin: int, mlp: Sequence[int], use_bn: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.add_module('PointwiseMLP_0', PointwiseMLP(
            cin, mlp, use_bn=use_bn, dtype=dtype, device=device))

    def forward(self, unknown, known, unknown_feats, known_feats):
        cdt = self.dtype
        # 3-NN distances and weights on float32 coordinates
        dist, idx = three_nn(unknown, known)
        recip = 1.0 / (dist + 1e-8)
        weight = recip / recip.sum(2, keepdim=True)
        new = three_interpolate_fl(known_feats.to(cdt), idx, weight.to(cdt))
        if unknown_feats is not None:
            new = torch.cat([new, unknown_feats.to(cdt)], dim=-1)
        return self.PointwiseMLP_0(new)
