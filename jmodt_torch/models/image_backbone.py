"""Image CNN for LI-Fusion (counterpart of
`jmodt_tpu/models/image_backbone.py`).

Public tensors are NHWC (B, H, W, C) as in the JAX package; each
convolution views its input as NCHW in channels-last memory (a permute, no
copy) and returns NHWC the same way.  Weights are in PyTorch's layouts:
Conv2d OIHW, ConvTranspose2d (Cin, Cout, k, k).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jmodt_torch.models.layers import BatchNorm
from jmodt_torch.ops.depth_to_space import depth_to_space


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return _nhwc(F.conv2d(_nchw(x.to(dtype)), conv.weight.to(dtype), bias,
                          stride=conv.stride, padding=conv.padding))


class BasicBlock(nn.Module):
    """conv3x3(s=1) -> BN -> ReLU -> conv3x3(s=2), no bias; halves H, W."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride=1, padding=1,
                                bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device)
        self.Conv_1 = nn.Conv2d(features, features, 3, stride=2, padding=1,
                                bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.BatchNorm_0(_conv(self.Conv_0, x, self.dtype)))
        return _conv(self.Conv_1, x, self.dtype)


def feature_gather(feature_map: torch.Tensor, xy: torch.Tensor
                   ) -> torch.Tensor:
    """Bilinear sampling of (B, H, W, C) features at xy (B, N, 2) in
    [-1, 1]: grid_sample with align_corners=True and zero padding, in
    float32, returned in the map's dtype as (B, N, C)."""
    out = F.grid_sample(_nchw(feature_map).float(), xy.float()[:, None],
                        mode='bilinear', padding_mode='zeros',
                        align_corners=True)                   # (B, C, 1, N)
    return out[:, :, 0, :].transpose(1, 2).to(feature_map.dtype)


class NonOverlapDeconv(nn.Module):
    """ConvTranspose2d with kernel == stride, NHWC in and out, computed as
    the JAX package does: one matmul of every input pixel to its k*k output
    taps, (B*H*W, C) @ (C, k*k*R), then the depth-to-space move with the
    bias (K6 on a CUDA tensor).  The weight keeps ConvTranspose2d's layout
    (Cin, Cout, k, k); its (Cin, k, k, Cout) permutation is the JAX
    package's tap-major matrix.  Without autograd that matrix and the bias,
    in the compute dtype, are built once and kept until a parameter changes
    (a new tensor, or an in-place write such as load_state_dict's)."""

    def __init__(self, cin: int, features: int, kernel: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(cin, features, kernel, kernel,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self._tables = None         # (parameter key, wmat, bias), no autograd

    def _tap_major(self):
        """(Cin, k*k*R) weight matrix and (R,) bias in the compute dtype."""
        w, bias, k = self.weight, self.bias, self.kernel
        key = (w.data_ptr(), w._version, bias.data_ptr(), bias._version)
        grad = torch.is_grad_enabled()
        if not grad and self._tables is not None and self._tables[0] == key:
            return self._tables[1:]
        c, r = w.shape[:2]
        wmat = w.permute(0, 2, 3, 1).reshape(c, k * k * r).to(self.dtype)
        bias = bias.to(self.dtype)
        if not grad:
            self._tables = (key, wmat, bias)
        return wmat, bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        b, h, w, c = x.shape
        wmat, bias = self._tap_major()
        r = bias.shape[0]
        taps = torch.matmul(x.reshape(b * h * w, c).to(self.dtype), wmat)
        out = depth_to_space(taps.reshape(b, h * w, k * k * r), k, r, h, w,
                             bias)
        return out.reshape(b, h * k, w * k, r)


class ImagePyramidFusion(nn.Module):
    """Deconv each level back to full resolution, concat, 1x1 conv + BN +
    ReLU (the materialized map; sampled afterwards by feature_gather)."""

    def __init__(self, in_channels: Sequence[int],
                 reduce_channels: Sequence[int], kernels: Sequence[int],
                 out_channels: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        for i, (cin, r, k) in enumerate(zip(in_channels, reduce_channels,
                                            kernels)):
            self.add_module(f'NonOverlapDeconv_{i}', NonOverlapDeconv(
                cin, r, k, dtype=dtype, device=device))
        self.n_levels = len(kernels)
        self.Conv_0 = nn.Conv2d(sum(reduce_channels), out_channels, 1,
                                device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device=device)

    def forward(self, img_levels):
        ups = [getattr(self, f'NonOverlapDeconv_{i}')(f)
               for i, f in enumerate(img_levels)]
        x = _conv(self.Conv_0, torch.cat(ups, dim=-1), self.dtype)
        return torch.relu(self.BatchNorm_0(x))
