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
also what the kernel is checked against on the card.  float32 and bfloat16;
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


def depth_to_space(taps: torch.Tensor, k: int, r: int, h0: int, w0: int,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, h0*w0, k*k*r) tap-major table -> (B, h0*k*w0*k, r) full-res map,
    plus `bias` (r,) in the table's dtype.  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if not taps.is_cuda:
        return depth_to_space_plain(taps, k, r, h0, w0, bias)
    _check(taps, k, r, h0, w0, bias)
    b = taps.shape[0]
    out = torch.empty((b, h0 * k * w0 * k, r), dtype=taps.dtype,
                      device=taps.device)
    kernels.launch('depth_to_space', 'jmodt_depth_to_space', taps.data_ptr(),
                   None if bias is None else bias.data_ptr(), b, h0, w0, k,
                   r, _DTYPES[taps.dtype], out.data_ptr())
    return out
