"""Shared building blocks (counterpart of `jmodt_tpu/models/layers.py`).

Every pointwise channel map works on a feature-last (..., C) layout.  Module
and parameter names follow the flax tree (`PointwiseLayer_0.Dense_0.weight`,
`...BatchNorm_0.running_var`) so `jmodt_torch.weights.load_jax_variables`
maps the JAX package's variables by layout alone.  In eval mode BatchNorm
uses its running statistics and dropout is an identity; in training mode
(`module.train()`) BatchNorm normalizes with flax's batch statistics and
updates its running ones, and `HeadMLP` drops out after its first hidden
layer, as `nn.BatchNorm(use_running_average=not train)` and `nn.Dropout`
do in the JAX package.

Params stay float32; each layer computes in its `dtype` (cfg.DTYPE) and
heads emit float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def compute_dtype(cfg) -> torch.dtype:
    """Network compute dtype from cfg.DTYPE."""
    return torch.bfloat16 if cfg.DTYPE == 'bfloat16' else torch.float32


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """`layer` applied in `dtype` (params cast, kept float32)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class BatchNorm(nn.Module):
    """BatchNorm over the last dim, eps 1e-5.

    Eval: (x - mean) * (scale / sqrt(var + eps)) + bias with the running
    statistics, in x's dtype (flax's order of operations).  Training: flax's
    batch statistics (`flax.linen.normalization._compute_stats` with its
    fast variance): in float32 whatever x's dtype, the mean over every
    leading axis and the biased variance E[x^2] - E[x]^2 clipped at 0; the
    normalization in float32, cast back to x's dtype; and the running
    statistics become 0.9 old + 0.1 batch.  (`F.batch_norm` would update
    the running variance with the unbiased variance.)"""

    def __init__(self, channels: int, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(channels, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))
        self.register_buffer('running_mean', torch.zeros(channels, **kw))
        self.register_buffer('running_var', torch.ones(channels, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._batch_norm(x)
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        dt = x.dtype
        return (x - self.running_mean.to(dt)) * mul.to(dt) + self.bias.to(dt)

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(axes)
        var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1 - BN_MOMENTUM) * mean.to(
                                        self.running_mean.dtype))
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1 - BN_MOMENTUM) * var.to(
                                       self.running_var.dtype))
        mul = torch.rsqrt(var + BN_EPS) * self.weight.to(xf.dtype)
        return ((xf - mean) * mul + self.bias.to(xf.dtype)).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's `nn.Dropout`: keep each entry with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate); the draws come from
    `generator` (on x's device), or from torch's default one when it is
    None."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class PointwiseLayer(nn.Module):
    """Dense -> optional BN -> ReLU on (..., C); the Dense has a bias only
    when BN is off."""

    def __init__(self, cin: int, cout: int, use_bn: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.add_module('Dense_0', nn.Linear(cin, cout, bias=not use_bn,
                                             device=device))
        if use_bn:
            self.add_module('BatchNorm_0', BatchNorm(cout, device=device))

    @property
    def dense(self) -> nn.Linear:
        return self.Dense_0

    @property
    def bn(self) -> Optional[BatchNorm]:
        return getattr(self, 'BatchNorm_0', None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dense(self.dense, x, self.dtype)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x)


class PointwiseMLP(nn.Module):
    """Stack of ReLU PointwiseLayers (SharedMLP)."""

    def __init__(self, cin: int, features: Sequence[int],
                 use_bn: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        for i, f in enumerate(features):
            self.add_module(f'PointwiseLayer_{i}', PointwiseLayer(
                cin, f, use_bn=use_bn, dtype=dtype, device=device))
            cin = f

    @property
    def layers(self):
        return list(self.children())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class HeadMLP(nn.Module):
    """Hidden PointwiseLayers and a linear output; emits float32.  In
    training mode, with `dp_ratio` > 0, dropout follows the first hidden
    layer; forward's `generator` draws its mask."""

    def __init__(self, cin: int, hidden: Sequence[int], out_features: int,
                 use_bn: bool = False, dp_ratio: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.dp_ratio = dp_ratio
        for i, f in enumerate(hidden):
            self.add_module(f'PointwiseLayer_{i}', PointwiseLayer(
                cin, f, use_bn=use_bn, dtype=dtype, device=device))
            cin = f
        self.n_hidden = len(hidden)
        self.add_module('Dense_0', nn.Linear(cin, out_features, device=device))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = getattr(self, f'PointwiseLayer_{i}')(x)
            if i == 0 and self.training and self.dp_ratio > 0:
                x = dropout(x, self.dp_ratio, generator)
        return dense(self.Dense_0, x, self.dtype).float()
