"""Image CNN for LI-Fusion (counterpart of
`jmodt_tpu/models/image_backbone.py`).

Public tensors are NHWC (B, H, W, C) as in the JAX package; each
convolution views its input as NCHW in channels-last memory (a permute, no
copy) and returns NHWC the same way.  Weights are in PyTorch's layouts:
Conv2d OIHW, ConvTranspose2d (Cin, Cout, k, k).

In the points region of a (data, points) mesh (`parallel.mesh`) a rank
holds the contiguous W / sp columns of every map: `BasicBlock` takes its
neighbours' edge columns (`mesh.halo`), the deconvs and 1x1 convs are
local to the slice, and `feature_gather` samples each point of the group
on the rank that holds its bilinear cell.
"""

from __future__ import annotations

import collections
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.models.layers import BatchNorm, _inputs
from perfbench.reference.ops.depth_to_space import depth_to_space
from perfbench.reference.parallel import mesh

# ImagePyramidFusion forwards by route: 'fused' (the eval gather at the
# points, FUSED_PYRAMID) or 'materialized' (the full-resolution map)
pyramid_routes: collections.Counter = collections.Counter()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
          padding=None) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    x, weight = _inputs(conv, x.to(dtype), conv.weight.to(dtype))
    return _nhwc(F.conv2d(_nchw(x), weight, bias,
                          stride=conv.stride,
                          padding=conv.padding if padding is None
                          else padding))


class BasicBlock(nn.Module):
    """conv3x3(s=1) -> BN -> ReLU -> conv3x3(s=2), no bias; halves H, W.

    On a width slice (the points region): Conv_0 takes a column of each
    neighbour, Conv_1 (whose slice starts at an even column, so its
    outputs are the slice's own) a column of the left one; the zero
    padding of the width stays at the image's true border."""

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
        if mesh.points_split() is None:
            x = torch.relu(self.BatchNorm_0(_conv(self.Conv_0, x,
                                                  self.dtype)))
            return _conv(self.Conv_1, x, self.dtype)
        if x.shape[2] % 2:
            raise ValueError(f'an image slice {x.shape[2]} columns wide '
                             'does not halve: the width must split into '
                             'even slices at every level')
        x = _conv(self.Conv_0, mesh.halo(x, 2, 1, 1), self.dtype, (1, 0))
        x = torch.relu(self.BatchNorm_0(x))
        return _conv(self.Conv_1, mesh.halo(x, 2, 1, 0), self.dtype, (1, 0))


def _bilinear_corners(h: int, w: int, xy: torch.Tensor):
    """Corner indices, in-map masks and blend weights of a grid_sample
    (align_corners=True, zero padding) at full-resolution size (h, w), as
    `jmodt_tpu/models/image_backbone.py::_bilinear_corners`: the weights
    come from the unclamped floor, and a corner outside the map counts 0.

    Returns ((u0, u1), (v0, v1), (in_u0, in_u1), (in_v0, in_v1), au, av):
    u / v clamped int64 indices, au / av float32 with a trailing axis."""
    xy = xy.float()
    u = (xy[..., 0] + 1.0) * 0.5 * (w - 1)
    v = (xy[..., 1] + 1.0) * 0.5 * (h - 1)
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    au = (u - u0f)[..., None]
    av = (v - v0f)[..., None]

    def clampi(x, hi):
        return torch.clamp(x, 0, hi).long()

    uu = (clampi(u0f, w - 1), clampi(u0f + 1, w - 1))
    vv = (clampi(v0f, h - 1), clampi(v0f + 1, h - 1))
    inu = ((u0f >= 0) & (u0f <= w - 1), (u0f + 1 >= 0) & (u0f + 1 <= w - 1))
    inv = ((v0f >= 0) & (v0f <= h - 1), (v0f + 1 >= 0) & (v0f + 1 <= h - 1))
    return uu, vv, inu, inv, au, av


def feature_gather(feature_map: torch.Tensor, xy: torch.Tensor
                   ) -> torch.Tensor:
    """Bilinear sampling of (B, H, W, C) features at xy (B, N, 2) in
    [-1, 1]: grid_sample with align_corners=True and zero padding, in
    float32, returned in the map's dtype as (B, N, C).

    In the points region the map is this rank's W / sp columns and xy its
    slice of the points: each point is sampled by the rank that holds its
    bilinear cell, with grid_sample on the whole width's coordinates, so
    it gets the one-process value bit for bit (`_owned_gather`)."""
    part = mesh.points_split()
    if part is not None:
        return _owned_gather(feature_map, xy, part)
    return _grid_sample(feature_map, xy)


def _grid_sample(feature_map: torch.Tensor, xy: torch.Tensor
                 ) -> torch.Tensor:
    out = F.grid_sample(_nchw(feature_map).float(), xy.float()[:, None],
                        mode='bilinear', padding_mode='zeros',
                        align_corners=True)                   # (B, C, 1, N)
    return out[:, :, 0, :].transpose(1, 2).to(feature_map.dtype)


def _owned_gather(feature_map: torch.Tensor, xy: torch.Tensor, part
                  ) -> torch.Tensor:
    """`feature_gather` on a width slice (`part` = (points rank, sp)): the
    rank widens its slice by a column of its left neighbour and two of its
    right one (`mesh.halo`), samples the points of its group whose cells
    it owns (`owned_sample`), and the reduce-scatter hands each point's
    value to the rank that holds the point."""
    r, sp = part
    if feature_map.shape[2] < 2:
        raise ValueError(f'an image slice {feature_map.shape[2]} column '
                         'wide: the gather needs slices of 2 columns or '
                         'more')
    band = mesh.halo(feature_map, 2, 1, 2)
    return mesh.scatter_points(owned_sample(band, mesh.gather_points(xy),
                                            r, sp))


def owned_sample(band: torch.Tensor, xy: torch.Tensor, r: int, sp: int
                 ) -> torch.Tensor:
    """A points rank's share of a split gather: (B, N, C) in the band's
    dtype, the one-process value of every point of xy (the whole group's
    points, in [-1, 1] of the whole width) whose bilinear cell is rank r's
    of sp, zeros for the others.  `band` is the rank's W / sp columns
    widened by one column on the left and two on the right.

    A point belongs to the rank whose columns hold the left corners of its
    cell (floor of its column, clamped to the image).  The band's extra
    columns hold the cell's corners even where the library's rounding of
    the column differs from this floor by one.  The band is copied to its
    place in a float32 zero map of the whole width and sampled there with
    grid_sample, so that a point's coordinate rounds as in one process
    (cuDNN's sampler scales it by the width): the owned points get the
    one-process values bit for bit.  The whole-width map is the price:
    each rank holds one (and samples every point of the group), as one
    process holds its map's float32 copy."""
    b, h, wb, c = band.shape
    w = wb - 3
    width = w * sp
    u = (xy[..., 0].float() + 1.0) * 0.5 * (width - 1)
    mine = torch.clamp(torch.floor(u), 0, width - 1).long() // w == r
    first = r * w - 1                     # the band's first column
    lo, hi = max(first, 0), min(first + wb, width)
    whole = band.new_zeros((b, h, width, c), dtype=torch.float32)
    whole[:, :, lo:hi] = band[:, :, lo - first:hi - first]
    out = _grid_sample(whole, xy)
    return torch.where(mine[..., None], out,
                       torch.zeros_like(out)).to(band.dtype)


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
        x, wmat = _inputs(self, x.reshape(b * h * w, c).to(self.dtype), wmat)
        taps = torch.matmul(x, wmat)
        out = depth_to_space(taps.reshape(b, h * w, k * k * r), k, r, h, w,
                             bias)
        return out.reshape(b, h * k, w * k, r)


class ImagePyramidFusion(nn.Module):
    """Deconv each level back to full resolution, concat, 1x1 conv + BN +
    ReLU.

    forward(img_levels) returns that map (B, H, W, out), sampled afterwards
    by feature_gather.  forward(img_levels, xy), the eval-only fused gather
    of `jmodt_tpu/models/image_backbone.py::_wide_gather` (FUSED_PYRAMID),
    returns the map sampled at xy (B, N, 2) without making it: the levels'
    pre-conv maps are concatenated to (B, H*W, sum r), the four bilinear
    corners of every point are gathered as one (B, 4N, sum r) take, the
    1x1 conv, BN with its running statistics and ReLU run on those 4N rows
    instead of H*W pixels, and the corners outside the map are zeroed after
    the ReLU before the blend, which equals feature_gather of the map.
    Both routes run the same submodules in the same order (the deconvs
    through K6 on the card)."""

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

    def forward(self, img_levels, xy=None):
        ups = [getattr(self, f'NonOverlapDeconv_{i}')(f)
               for i, f in enumerate(img_levels)]
        if xy is not None:
            if self.training:
                raise RuntimeError('the fused pyramid gather is an eval-only '
                                   'route: BatchNorm needs the whole map '
                                   'in training')
            pyramid_routes['fused'] += 1
            return self._wide_gather(ups, xy)
        pyramid_routes['materialized'] += 1
        x = _conv(self.Conv_0, torch.cat(ups, dim=-1), self.dtype)
        return torch.relu(self.BatchNorm_0(x))

    def _wide_gather(self, ups, xy):
        b, h, w, _ = ups[0].shape
        n = xy.shape[1]
        flat = torch.cat([u.reshape(b, h * w, -1) for u in ups], dim=-1)
        uu, vv, inu, inv, au, av = _bilinear_corners(h, w, xy)
        corners = [(ci, cj) for ci in range(2) for cj in range(2)]
        idx = torch.cat([vv[ci] * w + uu[cj] for ci, cj in corners], dim=1)
        g = torch.gather(flat, 1, idx[..., None].expand(-1, -1,
                                                        flat.shape[-1]))
        x = _conv(self.Conv_0, g[:, :, None, :], self.dtype)   # (B, 4N, 1, C)
        f = torch.relu(self.BatchNorm_0(x))[:, :, 0, :].reshape(b, 4, n, -1)
        ok = torch.stack([inv[ci] & inu[cj] for ci, cj in corners], dim=1)
        f = f * ok[..., None].to(f.dtype)
        au, av = au.to(f.dtype), av.to(f.dtype)
        top = f[:, 0] * (1 - au) + f[:, 1] * au
        bot = f[:, 2] * (1 - au) + f[:, 3] * au
        return top * (1 - av) + bot * av
