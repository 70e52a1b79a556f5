"""Depth-to-space of a NonOverlapDeconv's tap-major table (counterpart of
`jmodt_tpu/ops/pallas/depth_to_space.py`).

The deconv (kernel == stride == k, R output channels) is one matmul to a
table (B, h0*w0, k*k*R) followed by this move to the full-resolution map
(B, h0*k * w0*k, R): full-res pixel (y, x) reads table row
(y//k)*w0 + x//k at tap (y%k)*k + x%k.  The bias of the deconv is added in
the same pass, in the tensor's dtype.

On a CUDA tensor `depth_to_space` launches K6
(`jmodt_torch/csrc/depth_to_space.cu`, replaces
`jmodt_tpu/ops/pallas/depth_to_space.py::depth_to_space_pallas`); on a CPU
tensor it runs `depth_to_space_plain`, a view + permute + reshape, which is
also what the kernel is checked against on the card.  Under autograd (grad
mode on and the table or the bias requiring grad) the move goes through
`DepthToSpace`, a `torch.autograd.Function` whose forward is the same
dispatch, so K6 still runs on the card, and whose backward is the inverse
move (`space_to_depth_plain`) with the bias gradient as the sum over the
B * H * W pixels, in plain tensor ops: the JAX package's K6 defines no
VJP, since no JAX model path calls it.  float32 and bfloat16;
the kernel moves 16-byte vectors, so it takes k*r a multiple of 8 (bf16) or
4 (float32) and 16-byte aligned tables, which every pyramid level (r = 16)
gives.
"""

from __future__ import annotations

from typing import Optional

import torch

from jmodt_torch.ops import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def depth_to_space_plain(taps: torch.Tensor, k: int, r: int, h0: int,
                         w0: int, bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(B, h0*w0, k*k*r) -> (B, h0*k*w0*k, r) (+ bias (r,)), tensor ops."""
    b = taps.shape[0]
    y = taps.reshape(b, h0, w0, k, k, r).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(b, h0 * k * w0 * k, r)
    return y if bias is None else y + bias.to(y.dtype)


def space_to_depth_plain(full: torch.Tensor, k: int, r: int, h0: int,
                         w0: int) -> torch.Tensor:
    """The inverse move: (B, h0*k*w0*k, r) -> (B, h0*w0, k*k*r)."""
    b = full.shape[0]
    y = full.reshape(b, h0, k, w0, k, r).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h0 * w0, k * k * r)


def _check(taps, k, r, h0, w0, bias, check=kernels.check_cuda) -> None:
    """Raise unless K6 takes these arguments; `check` is
    `kernels.check_cuda`, or `kernels.check_layout` to check all but the
    device."""
    if taps.dtype not in _DTYPES:
        raise ValueError(f'taps: expected float32 or bfloat16, got '
                         f'{taps.dtype}')
    if min(k, r, h0, w0) < 1:
        raise ValueError(f'k={k}, r={r}, h0={h0}, w0={w0} must be >= 1')
    vec = 16 // taps.element_size()          # K6 moves 16-byte vectors
    if (k * r) % vec:
        raise ValueError(f'k*r={k * r} must be a multiple of {vec} for '
                         f'{taps.dtype}')
    check('taps', taps, taps.dtype, (None, h0 * w0, k * k * r))
    if taps.data_ptr() % 16:
        raise ValueError('taps: expected 16-byte aligned data')
    if bias is not None:
        check('bias', bias, taps.dtype, (r,))


class DepthToSpace(torch.autograd.Function):
    """`depth_to_space` with a backward: forward moves the table (K6 on a
    CUDA tensor), backward moves the incoming gradient back to the
    tap-major layout and sums it over pixels for the bias."""

    @staticmethod
    def forward(ctx, taps, bias, k, r, h0, w0):
        ctx.dims = (k, r, h0, w0)
        return _move(taps, k, r, h0, w0, bias)

    @staticmethod
    def backward(ctx, grad):
        k, r, h0, w0 = ctx.dims
        g_taps = g_bias = None
        if ctx.needs_input_grad[0]:
            g_taps = space_to_depth_plain(grad, k, r, h0, w0)
        if ctx.needs_input_grad[1]:
            g_bias = grad.float().sum((0, 1)).to(grad.dtype)
        return g_taps, g_bias, None, None, None, None


def depth_to_space(taps: torch.Tensor, k: int, r: int, h0: int, w0: int,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, h0*w0, k*k*r) tap-major table -> (B, h0*k*w0*k, r) full-res map,
    plus `bias` (r,) in the table's dtype.  CPU tensors take the plain
    version; CUDA tensors the kernel; under autograd both go through
    `DepthToSpace`."""
    if torch.is_grad_enabled() and (
            taps.requires_grad or (bias is not None and bias.requires_grad)):
        return DepthToSpace.apply(taps, bias, k, r, h0, w0)
    return _move(taps, k, r, h0, w0, bias)


def _move(taps, k, r, h0, w0, bias):
    """The forward move: K6 on a CUDA tensor, the plain version else."""
    if not kernels.on_card(taps):
        return depth_to_space_plain(taps, k, r, h0, w0, bias)
    _check(taps, k, r, h0, w0, bias)
    b = taps.shape[0]
    out = torch.empty((b, h0 * k * w0 * k, r), dtype=taps.dtype,
                      device=taps.device)
    kernels.launch('depth_to_space', 'jmodt_depth_to_space', taps.data_ptr(),
                   None if bias is None else bias.data_ptr(), b, h0, w0, k,
                   r, _DTYPES[taps.dtype], out.data_ptr())
    return out
