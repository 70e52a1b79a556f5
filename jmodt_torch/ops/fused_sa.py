"""Eval-time fused single-scale set abstraction (counterpart of
`jmodt_tpu/ops/fused_sa.py`).

With catf = concat[xyz, feats] per point and the eval BatchNorm folded into
each Dense, layer 1 of the grouped MLP is hoisted before the gather:

    h1 = relu(gather(catf @ W1)[b, m, s] + b1 - (new_xyz @ W1[:3])[b, m])

and the remaining layers and the max over the S samples follow.  The two
hoisted products are plain `torch.matmul`.  On a CUDA tensor the rest runs
in K4 (`jmodt_torch/csrc/grouped_gather_mlp.cu`, replaces
`jmodt_tpu/ops/pallas/grouped_gather_mlp.py::grouped_gather_mlp_max`),
whose layers 2..L run on the tensor cores at float32 accuracy (3xTF32,
`jmodt_torch/csrc/grouped_mlp.cuh`); on a CPU tensor in
`grouped_gather_mlp_max_plain`.  K4 has no backward: with grad mode on it
refuses a CUDA input that requires grad (RuntimeError), and
`fused_sa_eval(use_kernel=False)` is the form autograd differentiates.
Always float32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from jmodt_torch.ops import kernels
from jmodt_torch.ops.grouping import group_points_fl

_BN_EPS = 1e-5
# K4 (grouped_mlp.cuh) works on 64-row blocks (centres x samples), 4 MLP
# layers after the first at most, 128-column passes over a ring of 2
# weight tiles 32 deep
_K4_ROWS = 64
_K4_MAX_LAYERS = 4
_K4_PASS = 128
_K4_TILE_K = 32
_K4_STAGES = 2
_K4_SMEM_LIMIT = 232448
# one wave of blocks on an H100: 132 SMs of 228 KB of shared memory, at
# most 2 blocks an SM (registers); a plan with fewer blocks splits the last
# layer's column passes over more, up to one wave
_K4_SMS = 132
_K4_SM_SMEM = 233472
_K4_BLOCKS_PER_SM = 2

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def fold_pointwise_mlp(mlp) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """Fold a `PointwiseMLP`'s Dense(+BatchNorm) stack into per-layer
    (W (Cin, Cout) f32, b (Cout,) f32)."""
    out = []
    for layer in mlp.layers:
        w = layer.dense.weight.float().t()
        if layer.bn is not None:
            bn = layer.bn
            s = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                + _BN_EPS)
            b = bn.bias.float() - bn.running_mean.float() * s
            w = w * s[None, :]
        else:
            b = layer.dense.bias.float()
        out.append((w.contiguous(), b.contiguous()))
    return tuple(out)


def grouped_gather_mlp_max_plain(feats1: torch.Tensor, idx: torch.Tensor,
                                 cxw: torch.Tensor, b1: torch.Tensor,
                                 layers: Layers) -> torch.Tensor:
    """max_s relu(...relu(gather(feats1)[b,m,s] + b1 - cxw[b,m]) @ W2 + b2...)
    with the grouped intermediates as tensors: (B, M, C_last) f32."""
    g = group_points_fl(feats1, idx)                       # (B, M, S, C1)
    h = torch.relu((g + b1) - cxw[:, :, None, :])
    for w, b in layers:
        h = torch.relu(h @ w + b)
    return h.amax(dim=2)


def _pad8(c: int) -> int:
    return -(-c // 8) * 8


def _k4_smem_bytes(s: int, widths: Sequence[int]) -> int:
    """Shared memory K4 needs: two activation buffers of 64 rows (+8 pad) x
    the widest layer input at even / odd depth (padded to 8 channels), two
    32 x 128 (+8 pad) weight tiles and the (64 / S) x 128 output tile."""
    ins = [_pad8(w) for w in widths[:-1]]
    even = max(ins[0::2])
    odd = max(ins[1::2], default=0)
    return 4 * ((_K4_ROWS + 8) * (even + odd)
                + _K4_STAGES * _K4_TILE_K * (_K4_PASS + 8)
                + (_K4_ROWS // s) * _K4_PASS)


class K4Plan(NamedTuple):
    rows: int               # rows (centres x samples) a block
    centres: int            # centres a block
    grid: Tuple[int, int, int]   # blocks over M, over B, column split
    passes: Tuple[int, ...]  # 128-column passes of each layer 2..L
    smem: int               # dynamic shared memory bytes a block

    @property
    def col_split(self) -> int:
        """Blocks sharing the last layer's column passes."""
        return self.grid[2]


def k4_launch_plan(b: int, m: int, s: int, widths: Sequence[int]) -> K4Plan:
    """K4's launch for B clouds of M centres with S samples each through
    the widths [C1, C2, .., CL].  Where the 64-row blocks are fewer than
    one wave of the card, the last layer's 128-column passes are split
    over more blocks, as many as still fit in one wave, each of which
    computes layers 2..L-1 in full.  Raises ValueError on what the kernel
    does not take."""
    if not 1 <= len(widths) - 1 <= _K4_MAX_LAYERS:
        raise ValueError(f'K4 takes 1..{_K4_MAX_LAYERS} layers after the '
                         f'first, got {len(widths) - 1}')
    if s < 4 or s % 4 or _K4_ROWS % s:
        raise ValueError(f'K4 needs S a multiple of 4 dividing {_K4_ROWS}, '
                         f'got S={s}')
    if any(w % 4 for w in widths[1:]):
        raise ValueError(f'K4 needs widths 2..L multiples of 4 (16-byte '
                         f'weight copies), got {list(widths)}')
    smem = _k4_smem_bytes(s, widths)
    if smem > _K4_SMEM_LIMIT:
        raise ValueError(f'K4 needs {smem} bytes of shared memory for '
                         f'widths {list(widths)}, over {_K4_SMEM_LIMIT}')
    centres = _K4_ROWS // s
    passes = tuple(-(-w // _K4_PASS) for w in widths[1:])
    blocks = -(-m // centres) * b
    per_sm = max(1, min(_K4_BLOCKS_PER_SM, _K4_SM_SMEM // (smem + 1024)))
    want = max(1, min(passes[-1], _K4_SMS * per_sm // blocks))
    share = -(-passes[-1] // want)           # passes a block, then blocks
    return K4Plan(_K4_ROWS, centres, (-(-m // centres), b,
                                      -(-passes[-1] // share)), passes, smem)


def check_weight_aligned(name: str, w: torch.Tensor) -> None:
    """K4 copies weights in 16-byte pieces: raise unless `w` starts on 16
    bytes."""
    if w.data_ptr() % 16:
        raise ValueError(f'{name}: K4 needs 16-byte aligned weights')


def grouped_gather_mlp_max(feats1: torch.Tensor, idx: torch.Tensor,
                           cxw: torch.Tensor, b1: torch.Tensor,
                           layers: Layers) -> torch.Tensor:
    """K4 on a CUDA tensor, the plain version on a CPU tensor.

    :param feats1: (B, N, C1) f32, first layer already applied per point
    :param idx: (B, M, S) int32 neighbor indices
    :param cxw: (B, M, C1) f32 per-center correction
    :param b1: (C1,) f32
    :param layers: folded (W (Cin, Cout), b (Cout,)) of layers 2..L
    :return: (B, M, C_last) f32
    """
    if not kernels.on_card(feats1):
        return grouped_gather_mlp_max_plain(feats1, idx, cxw, b1, layers)
    kernels.refuse_grad('grouped_gather_mlp_max (K4)', feats1, cxw, b1,
                        *(t for layer in layers for t in layer))
    b, n, c1 = feats1.shape
    _, m, s = idx.shape
    kernels.check_cuda('feats1', feats1, torch.float32, (b, n, c1))
    kernels.check_cuda('idx', idx, torch.int32, (b, m, s))
    kernels.check_cuda('cxw', cxw, torch.float32, (b, m, c1))
    kernels.check_cuda('b1', b1, torch.float32, (c1,))
    widths = [c1]
    for i, (w, bias) in enumerate(layers):
        kernels.check_cuda(f'W{i + 2}', w, torch.float32, (widths[-1], None))
        kernels.check_cuda(f'b{i + 2}', bias, torch.float32, (w.shape[1],))
        check_weight_aligned(f'W{i + 2}', w)
        widths.append(w.shape[1])
    plan = k4_launch_plan(b, m, s, widths)
    out = torch.empty((b, m, widths[-1]), dtype=torch.float32,
                      device=feats1.device)
    n_rest = len(layers)
    w_ptrs = (ctypes.c_void_p * _K4_MAX_LAYERS)(
        *[w.data_ptr() for w, _ in layers])
    b_ptrs = (ctypes.c_void_p * _K4_MAX_LAYERS)(
        *[bias.data_ptr() for _, bias in layers])
    dims = (ctypes.c_int * (_K4_MAX_LAYERS + 1))(*widths)
    kernels.launch('grouped_gather_mlp_max', 'jmodt_grouped_gather_mlp_max',
                   feats1.data_ptr(), idx.data_ptr(), cxw.data_ptr(),
                   b1.data_ptr(), b, n, m, s, n_rest, plan.smem,
                   plan.col_split, w_ptrs, b_ptrs, dims, out.data_ptr())
    return out


def fused_sa_eval(xyz: torch.Tensor, feats: Optional[torch.Tensor],
                  new_xyz: torch.Tensor, idx: torch.Tensor,
                  layers: Layers, use_kernel: bool = True) -> torch.Tensor:
    """One single-scale use_xyz=True SA level on folded eval weights.

    :param xyz: (B, N, 3) f32; :param feats: (B, N, C) or None
    :param new_xyz: (B, M, 3) f32 centers; :param idx: (B, M, S) int32
    :param layers: folded (W, b) per MLP layer, W1 (3 + C, C1) first
    :param use_kernel: False runs `grouped_gather_mlp_max_plain` on any
        device, the form autograd differentiates (the JAX package's
        `use_pallas=False`)
    :return: (B, M, C_last) f32
    """
    (w1, b1), rest = layers[0], layers[1:]
    catf = xyz if feats is None else torch.cat([xyz, feats.float()], dim=-1)
    feats1 = torch.matmul(catf, w1)                  # (B, N, C1) pre-gather
    cxw = torch.matmul(new_xyz, w1[:3])              # (B, M, C1)
    if not use_kernel:
        return grouped_gather_mlp_max_plain(feats1, idx, cxw, b1, rest)
    return grouped_gather_mlp_max(feats1.contiguous(), idx.contiguous(),
                                  cxw.contiguous(), b1, rest)
