"""Shared building blocks (counterpart of `jmodt_tpu/models/layers.py`).

Every pointwise channel map works on a feature-last (..., C) layout.  Module
and parameter names follow the flax tree (`PointwiseLayer_0.Dense_0.weight`,
`...BatchNorm_0.running_var`) so `jmodt_torch.weights.load_jax_variables`
maps the JAX package's variables by layout alone.  The port is
inference-only: BatchNorm always uses its running statistics.

Params stay float32; each layer computes in its `dtype` (cfg.DTYPE) and
heads emit float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def compute_dtype(cfg) -> torch.dtype:
    """Network compute dtype from cfg.DTYPE."""
    return torch.bfloat16 if cfg.DTYPE == 'bfloat16' else torch.float32


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """`layer` applied in `dtype` (params cast, kept float32)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class BatchNorm(nn.Module):
    """Eval BatchNorm over the last dim: (x - mean) * (scale / sqrt(var +
    eps)) + bias, eps 1e-5 (flax's order of operations)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(channels, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))
        self.register_buffer('running_mean', torch.zeros(channels, **kw))
        self.register_buffer('running_var', torch.ones(channels, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        dt = x.dtype
        return (x - self.running_mean.to(dt)) * mul.to(dt) + self.bias.to(dt)


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
    """Hidden PointwiseLayers and a linear output; emits float32 (dropout
    is an identity at inference)."""

    def __init__(self, cin: int, hidden: Sequence[int], out_features: int,
                 use_bn: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        for i, f in enumerate(hidden):
            self.add_module(f'PointwiseLayer_{i}', PointwiseLayer(
                cin, f, use_bn=use_bn, dtype=dtype, device=device))
            cin = f
        self.n_hidden = len(hidden)
        self.add_module('Dense_0', nn.Linear(cin, out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = getattr(self, f'PointwiseLayer_{i}')(x)
        return dense(self.Dense_0, x, self.dtype).float()
