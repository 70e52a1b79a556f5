"""Shared building blocks (counterpart of `jmodt_tpu/models/layers.py`).

Every pointwise channel map works on a feature-last (..., C) layout.  Module
and parameter names follow the flax tree (`PointwiseLayer_0.Dense_0.weight`,
`...BatchNorm_0.running_var`) so `perfbench.reference.weights.load_jax_variables`
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

import contextlib
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.parallel import mesh

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 with one scale for the whole tensor (its
    largest magnitude to e4m3's 448), back in `t`'s dtype: the inputs of a
    float8 product with a float32 accumulator.  Gradients pass through
    the rounding unchanged."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    # straight through: the rounded value forward, the identity backward
    return t + (q.to(t.dtype) - t).detach()


def mark_fp8(model: nn.Module) -> nn.Module:
    """Make every dense, convolution and deconvolution of `model` round
    its two inputs to float8 (`fp8_round`): the lower-precision control
    of a bfloat16 configuration."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)) or hasattr(mod,
                                                              '_tap_major'):
            mod.fp8 = True
    return model


def _inputs(layer: nn.Module, x: torch.Tensor, weight: torch.Tensor):
    if getattr(layer, 'fp8', False):
        return fp8_round(x), fp8_round(weight)
    return x, weight


def compute_dtype(cfg) -> torch.dtype:
    """Network compute dtype from cfg.DTYPE."""
    return torch.bfloat16 if cfg.DTYPE == 'bfloat16' else torch.float32


def split_invariant() -> bool:
    """Whether the process runs with CUBLAS_WORKSPACE_CONFIG=:0:0, the
    setting under which a split of the batch or of its points over ranks
    rounds as one process on the card: cuBLAS then does not split a
    product's K by its shape, and `dense` computes a one-output layer in a
    way that does not depend on the row count either."""
    return os.environ.get('CUBLAS_WORKSPACE_CONFIG') == ':0:0'


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """`layer` applied in `dtype` (params cast, kept float32).  Under
    `split_invariant()` a layer of one output (an attention logit, a class
    score) is the product with the weight row summed over the last dim in
    float32, cast to `dtype`: cuBLAS's one-column product rounds a row by
    how many rows it is given, even with its workspace off (measured on
    the H100 at the fusion layers' sizes, `tools/split_diagnosis.py`), so
    a row's value would depend on how the batch or its points are split
    over ranks; this sum does not."""
    x, weight = _inputs(layer, x.to(dtype), layer.weight.to(dtype))
    bias = None if layer.bias is None else layer.bias.to(dtype)
    if weight.shape[0] != 1 or not split_invariant():
        return F.linear(x, weight, bias)
    y = (x.to(dtype).float() * weight[0].float()).sum(-1, keepdim=True)
    return (y if bias is None else y + bias.float()).to(dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last dim, eps 1e-5.

    Eval: (x - mean) * (scale / sqrt(var + eps)) + bias with the running
    statistics, in x's dtype (flax's order of operations).  Training: flax's
    batch statistics (`flax.linen.normalization._compute_stats` with its
    fast variance): in float32 whatever x's dtype, the mean over every
    leading axis and the biased variance E[x^2] - E[x]^2 clipped at 0; the
    normalization in float32, cast back to x's dtype; and the running
    statistics become 0.9 old + 0.1 batch.  (`F.batch_norm` would update
    the running variance with the unbiased variance.)  When the batch is
    split over ranks (`parallel.mesh`), the float32 sums of x and x^2 and
    the row count are summed over them, gradients flowing through the sum,
    and the statistics, the running averages and the backward are the
    global batch's, as flax computes them under GSPMD, up to float32
    summation order.  In the points region (`mesh.points_split`) the rows
    are this rank's slice of the points or of the image width, the sums go
    over the whole world, and they are taken in float64, so that they do
    not depend on how the points are split: float32 sums in another order
    moved near-eps-variance channels of the RPN heads far enough to flip a
    ReLU (tests/test_torch_points_parallel.py at (2, 2))."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(channels, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))
        self.register_buffer('running_mean', torch.zeros(channels, **kw))
        self.register_buffer('running_var', torch.ones(channels, **kw))
        self.updates = 0       # training-mode calls: running-stat updates

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._batch_norm(x)
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        dt = x.dtype
        return (x - self.running_mean.to(dt)) * mul.to(dt) + self.bias.to(dt)

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.dim() - 1))
        if mesh.split() is None:
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        else:
            c = x.shape[-1]
            if mesh.points_split() is None:
                s1, s2 = torch.sum(xf, axes), torch.sum(xf * xf, axes)
            else:
                s1 = torch.sum(xf, axes, dtype=torch.float64)
                s2 = torch.linalg.vector_norm(xf, 2, dim=axes,
                                              dtype=torch.float64) ** 2
            sums = mesh.stat_sum(torch.cat([
                s1, s2, torch.full((1,), xf.numel() // c, dtype=s1.dtype,
                                   device=x.device)]))
            mean = sums[:c] / sums[-1]
            var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean,
                              min=0.0).to(xf.dtype)
            mean = mean.to(xf.dtype)
        self.updates += 1
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1 - BN_MOMENTUM) * mean.to(
                                        self.running_mean.dtype))
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1 - BN_MOMENTUM) * var.to(
                                       self.running_var.dtype))
        mul = torch.rsqrt(var + BN_EPS) * self.weight.to(xf.dtype)
        return ((xf - mean) * mul + self.bias.to(xf.dtype)).to(x.dtype)


@contextlib.contextmanager
def per_call_batches(*modules: nn.Module):
    """Inside, BatchNorm and dropout in `modules` take each call's input as
    a batch of its own (the ReID heads' per-pair tensors), not as this
    rank's rows of a batch split over ranks (`mesh.rank_local`).  Each
    training-mode call still moves a BatchNorm's running statistics, as in
    one process; with the batch split over ranks they become, on exit,
    what one process leaves after every rank's calls in rank order: with
    K calls a rank, momentum m and r0 before, m^(N K) r0 plus the sum over
    ranks of m^((N - 1 - r) K) (r_r - m^K r0)."""
    split = mesh.split()
    bns = [b for mod in modules for b in mod.modules()
           if isinstance(b, BatchNorm)]
    before = [(b.updates, b.running_mean.clone(), b.running_var.clone())
              for b in bns]
    with mesh.rank_local():
        yield
    if split is None or not bns:
        return
    rank, world = split
    with torch.no_grad():
        parts, starts = [], []
        for b, (n0, mean0, var0) in zip(bns, before):
            k = b.updates - n0
            for now, start in ((b.running_mean, mean0), (b.running_var,
                                                         var0)):
                parts.append(BN_MOMENTUM ** ((world - 1 - rank) * k)
                             * (now - BN_MOMENTUM ** k * start))
                starts.append((now, BN_MOMENTUM ** (world * k) * start))
        folded = mesh.loss_sum(torch.cat(parts))
        for (now, start), part in zip(starts, folded.split(
                [now.numel() for now, _ in starts])):
            now.copy_(start + part)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's `nn.Dropout`: keep each entry with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate); the draws come from
    `generator` (on x's device), or from torch's default one when it is
    None.  When the batch is split over ranks, x's leading dim is this
    rank's rows, and in the points region (`mesh.points_split`) its
    second dim this rank's slice of the points: the mask is drawn for the
    global batch and all its points, and cut to them."""
    keep = 1.0 - rate
    part = mesh.points_split()
    shape = [mesh.global_rows(x.shape[0])] + list(x.shape[1:])
    if part is not None:
        shape[1] *= part[1]
    mask = mesh.local_rows(torch.rand(shape, generator=generator,
                                      device=x.device))
    if part is not None:
        mask = mask.narrow(1, part[0] * x.shape[1], x.shape[1])
    return torch.where(mask < keep, x / keep, torch.zeros_like(x))


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

    def _drops(self) -> bool:
        return self.training and self.dp_ratio > 0 and self.n_hidden > 0

    def skip_draws(self, lead_shape, generator: Optional[torch.Generator]
                   ) -> None:
        """Draw and drop the dropout mask that forward draws for an input
        of leading shape `lead_shape`: `generator` moves on as if forward
        had run."""
        if self._drops():
            width = self.PointwiseLayer_0.dense.out_features
            torch.rand(tuple(lead_shape) + (width,), generator=generator,
                       device=self.Dense_0.weight.device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = getattr(self, f'PointwiseLayer_{i}')(x)
            if i == 0 and self._drops():
                x = dropout(x, self.dp_ratio, generator)
        return dense(self.Dense_0, x, self.dtype).float()
