"""Training over processes: the (data, points) mesh of
`jmodt_tpu/parallel/mesh.py`.

The JAX package trains one program over a global batch: GSPMD splits the
batch over the `data` axis of its mesh and, on a 2-D mesh, the point dim of
the cloud and the image width over the inner `points` axis, and makes every
reduction global (BatchNorm's batch statistics, each loss's normalizer, the
gradient).  Here a world of dp x sp processes (ranks) takes the step one
process takes on the whole batch, up to float32 summation order.  Rank r is
data index r // sp and points index r % sp (`jax`'s
`devices.reshape(dp, sp)`): a points group is sp adjacent ranks.

* `init` joins the process group, from torchrun's environment or from the
  rank, world size and rendezvous it is given, and builds one process
  group per points group and per data group; `spawn` starts the ranks
  itself, each running a function of this package.
* `shard_batch` cuts this rank's rows (a contiguous 1/dp of the batch's
  pairs) and, within them, its contiguous 1/sp of the point dim of the
  point fields and of the image width (`POINT_DIMS`); `global_rows` /
  `local_rows` let a random draw be made for the whole batch and cut the
  same way.
* `points_region()` marks the split region (the RPN: image CNN, point
  backbone, heads), where a rank holds its slice of the points and the
  width.  Inside it `points_split()` gives (points rank, sp), and
  BatchNorm's sums go over the whole world; outside it the model runs
  replicated over each points group and the sums go over the data group.
  `gather_points`, `scatter_points` and `halo` are the points group's
  collectives under autograd.
* `put_replicated` broadcasts parameters, buffers and optimizer state
  from rank 0.
* `loss_sum` and `stat_sum` are the sums the losses and BatchNorm take
  (they differ in what their backward passes on), `batch_max` a maximum,
  and `sum_grads` sums the gradients.

The batch is split while a process group is initialized, outside
`rank_local()`; otherwise every helper is the one-process identity.  The
backend is NCCL when every rank has a card of its own, gloo when ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU.
Gloo on CUDA tensors supports only broadcast, all_reduce and barrier, so
over gloo these helpers use nothing else: a gather is an all_reduce of a
zero-padded buffer, a reduce-scatter an all_reduce and a slice.

`stats` counts the collectives this process made and the host seconds
spent inside them (which include waiting for the kernels that produce
their inputs).
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import socket
import time
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# set inside rank_local(): the tensors there are this rank's own, not a
# slice of the batch
_LOCAL = contextvars.ContextVar('jmodt_rank_local', default=False)
# set inside points_region(): the tensors there are this rank's slice of
# the points (and of the image width)
_REGION = contextvars.ContextVar('jmodt_points_region', default=False)

stats = {'calls': 0, 'seconds': 0.0}

# a collective that waits longer raises (a rank that died, a hang)
TIMEOUT_S = 600.0

# batch fields with a point (or image-width) dim split over the points
# axis, and which dim it is (`jmodt_tpu/parallel/mesh.py::_POINT_DIMS`)
POINT_DIMS = {
    'pts_input': 1,      # (B, N, 3 + C)
    'pts_xy': 1,         # (B, N, 2)
    'rpn_cls_label': 1,  # (B, N)
    'rpn_reg_label': 1,  # (B, N, 7)
    'img': 2,            # (B, H, W, 3): the width
}

# the layout of the world: dp data shards of sp points ranks each, and
# this rank's process groups (None: the default group; 'self': a group of
# this rank alone, whose collectives are identities)
_layout = {'dp': 1, 'sp': 1, 'points': 'self', 'data': None}


def split() -> Optional[Tuple[int, int]]:
    """(data rank, dp) while the batch is split over a process group, None
    outside one or inside `rank_local()`."""
    if _LOCAL.get() or not dist.is_initialized():
        return None
    return dist.get_rank() // _layout['sp'], _layout['dp']


def _points_axis() -> Optional[Tuple[int, int]]:
    """(points rank, sp) where the world has a points axis (sp > 1)."""
    if _LOCAL.get() or not dist.is_initialized() or _layout['sp'] == 1:
        return None
    return dist.get_rank() % _layout['sp'], _layout['sp']


def points_split() -> Optional[Tuple[int, int]]:
    """(points rank, sp) inside `points_region()` where the world has a
    points axis; None elsewhere."""
    return _points_axis() if _REGION.get() else None


def in_points_region() -> bool:
    """Whether the caller runs inside `points_region()`, with or without
    a points axis."""
    return _REGION.get()


def layout() -> Tuple[int, int]:
    """(dp, sp) of the world: (1, 1) without a process group."""
    if not dist.is_initialized():
        return 1, 1
    return _layout['dp'], _layout['sp']


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@contextlib.contextmanager
def rank_local():
    """Inside, BatchNorm and dropout treat their inputs as this rank's
    own (the ReID heads' per-pair tensors), not as rows of the batch."""
    token = _LOCAL.set(True)
    try:
        yield
    finally:
        _LOCAL.reset(token)


@contextlib.contextmanager
def points_region():
    """Inside, a rank's tensors are its slice of the points and of the
    image width: the point backbone, the image CNN and the RPN heads split
    their work (`points_split`), and BatchNorm sums over the world."""
    token = _REGION.set(True)
    try:
        yield
    finally:
        _REGION.reset(token)


# --------------------------------------------------------------------------
# process group
# --------------------------------------------------------------------------

def _env_int(name: str, default: Optional[int] = None) -> int:
    if name in os.environ:
        return int(os.environ[name])
    if default is None:
        raise RuntimeError(f'{name} is not set: start the ranks with '
                           'torchrun, or give init() the rank and world size')
    return default


def check_layout(world: int, points: int) -> int:
    """dp for a world of `world` ranks in points groups of `points`;
    raises when it does not divide."""
    if points < 1 or world % points:
        raise ValueError(f'a world of {world} ranks does not split into '
                         f'points groups of {points}: the number of ranks '
                         f'must be a multiple of --points_parallel')
    return world // points


def _set_layout(world: int, points: int) -> None:
    """Build the points and data groups.  Every rank calls `new_group`
    for every group, in the same order."""
    dp = check_layout(world, points)
    me = dist.get_rank()
    lay = {'dp': dp, 'sp': points, 'points': 'self', 'data': None}
    if points > 1:
        for d in range(dp):
            ranks = list(range(d * points, (d + 1) * points))
            g = None if dp == 1 else dist.new_group(ranks)
            if me in ranks:
                lay['points'] = g
        lay['data'] = 'self'
        if dp > 1:
            for p in range(points):
                ranks = list(range(p, world, points))
                g = dist.new_group(ranks)
                if me in ranks:
                    lay['data'] = g
    _layout.update(lay)


def init(rank: Optional[int] = None, world: Optional[int] = None,
         init_method: Optional[str] = None, device=None,
         local_rank: Optional[int] = None,
         local_world: Optional[int] = None, points: int = 1
         ) -> torch.device:
    """Join the process group as a rank of a (world / points, points)
    mesh; returns this rank's device.

    What is not given comes from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE; rendezvous at MASTER_ADDR:MASTER_PORT).
    With `device` None the rank takes card LOCAL_RANK mod the visible
    cards; a `device` given puts every rank of this host on it ('cpu', or
    one card that the ranks share).  A collective that waits longer than
    TIMEOUT_S raises.  The world must be a multiple of `points`."""
    rank = _env_int('RANK') if rank is None else rank
    world = _env_int('WORLD_SIZE') if world is None else world
    check_layout(world, points)
    local_rank = (_env_int('LOCAL_RANK', rank) if local_rank is None
                  else local_rank)
    local_world = (_env_int('LOCAL_WORLD_SIZE', world) if local_world is None
                   else local_world)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass '
                               'device="cpu" to run the ranks on the CPU')
        cards = torch.cuda.device_count()
        dev = torch.device('cuda', local_rank % cards)
        shared = local_world > cards
    else:
        dev = torch.device(device)
        shared = local_world > 1
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    backend = 'nccl' if dev.type == 'cuda' and not shared else 'gloo'
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _set_layout(world, points)
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _layout.update(dp=1, sp=1, points='self', data=None)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, init_method: str, device,
               threads: Optional[int], fn: Callable, args: tuple,
               points: int = 1) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = init(rank, world, init_method, device, local_rank=rank,
               local_world=world, points=points)
    try:
        fn(dev, *args)
    finally:
        shutdown()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          init_method: Optional[str] = None, device=None,
          threads: Optional[int] = None, points: int = 1) -> None:
    """Run `fn(device, *args)` in `world` new processes, ranks 0..world-1
    of one process group on this host, in points groups of `points`
    (`init`'s devices: a card each when `device` is None).  `fn` is
    pickled by its import path, so it is a module-level function of a
    package.  The rendezvous is `init_method`, or a free TCP port on
    localhost; `threads` sets each rank's torch threads.  Raises when a
    rank fails; the others are then stopped."""
    check_layout(world, points)
    if init_method is None:
        init_method = f'tcp://localhost:{free_port()}'
    mp.spawn(_rank_main, args=(world, init_method, device, threads, fn,
                               tuple(args), points),
             nprocs=world, join=True)


# --------------------------------------------------------------------------
# the batch
# --------------------------------------------------------------------------

def pairs_per_rank(pairs: int, world: int) -> int:
    """Frame pairs a data shard takes from a batch of `pairs` split over
    `world` shards; raises when they cannot take equal whole pairs."""
    if pairs % world:
        raise ValueError(f'a batch of {pairs} frame pairs does not split '
                         f'over {world} ranks: every rank takes the same '
                         f'number of whole pairs, so --batch_size must be '
                         f'a multiple of {world}')
    return pairs // world


def shard_batch(batch: Mapping[str, Any], part: Optional[int] = None,
                parts: Optional[int] = None,
                point_part: Optional[int] = None,
                point_parts: Optional[int] = None) -> dict:
    """This rank's share of a global batch of interleaved (prev, next)
    frame pairs: rows [r B / D, (r + 1) B / D) of every array (numpy or
    tensor) whose leading dim is the batch's B frames, so every pair stays
    on one data shard (r is `part` of `parts`, default this rank's data
    rank and dp), then `shard_points` of those rows (`point_part` of
    `point_parts`, default this rank's points rank and sp); other entries
    as they are."""
    dp, sp = layout()
    part = rank() // sp if part is None else part
    parts = dp if parts is None else parts
    b = batch['pts_input'].shape[0]
    n = 2 * pairs_per_rank(b // 2, parts)
    out = {}
    for k, v in batch.items():
        rows = (isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0
                and v.shape[0] == b)
        out[k] = v[part * n:(part + 1) * n] if rows else v
    return shard_points(out, point_part, point_parts)


def shard_points(batch: Mapping[str, Any], part: Optional[int] = None,
                 parts: Optional[int] = None) -> dict:
    """Slice `part` of `parts` (default this rank's points rank and sp) of
    the point dim of every point field and of the image width
    (`POINT_DIMS`): the contiguous 1/parts of each.  Raises, naming the
    shape, where one does not divide."""
    _, sp = layout()
    part = rank() % sp if part is None else part
    parts = sp if parts is None else parts
    out = dict(batch)
    if parts == 1:
        return out
    for k, dim in POINT_DIMS.items():
        v = batch.get(k)
        if v is None:
            continue
        n = v.shape[dim]
        if n % parts:
            raise ValueError(f'{k} of shape {tuple(v.shape)}: dim {dim} '
                             f'({n}) does not split over {parts} points '
                             'ranks')
        m = n // parts
        index = [slice(None)] * v.ndim
        index[dim] = slice(part * m, (part + 1) * m)
        out[k] = v[tuple(index)]
    return out


def check_points_shapes(points: int, n_points: int,
                        npoints: Sequence[int], width: int,
                        levels: int) -> None:
    """Raise, naming the shape, unless a split over `points` ranks
    divides the cloud's `n_points`, each SA level's centres `npoints` and
    the image width at each of the CNN's `levels` stride-2 levels (W / (sp
    2^levels) whole, so every slice of every level starts at an even
    column)."""
    if points == 1:
        return
    if n_points % points:
        raise ValueError(f'{n_points} points do not split over {points} '
                         'points ranks')
    for k, m in enumerate(npoints):
        if m % points:
            raise ValueError(f'SA level {k}\'s {m} centres do not split '
                             f'over {points} points ranks')
    if width % (points * 2 ** levels):
        raise ValueError(f'an image {width} wide does not split over '
                         f'{points} points ranks at each of its {levels} '
                         f'levels: the width must be a multiple of '
                         f'{points * 2 ** levels}')


def global_rows(n: int) -> int:
    """The batch's leading dim for a rank holding `n` of its rows."""
    s = split()
    return n if s is None else n * s[1]


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of `t`, made for the whole batch (`global_rows`)."""
    s = split()
    if s is None:
        return t
    n = t.shape[0] // s[1]
    return t[s[0] * n:(s[0] + 1) * n]


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    fn(*args, **kw)
    stats['calls'] += 1
    stats['seconds'] += time.perf_counter() - t0


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None
                ) -> torch.Tensor:
    if group != 'self':
        _timed(dist.all_reduce, t, op=op, group=group)
    return t


def _sum_group():
    """The group a sum over the batch takes: the world inside the points
    region, the data group outside it."""
    return None if _REGION.get() else _layout['data']


def _native() -> bool:
    """Whether NCCL's all-gather and reduce-scatter are there to use."""
    return dist.get_backend() == 'nccl'


def _gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The points group's slices of `x`, concatenated along `dim` in rank
    order."""
    r, sp = _points_axis()
    group = _layout['points']
    x = x.contiguous()
    if _native():
        buf = x.new_empty((sp,) + tuple(x.shape))
        _timed(dist.all_gather_into_tensor, buf, x, group=group)
    else:
        buf = x.new_zeros((sp,) + tuple(x.shape))
        buf[r] = x
        _all_reduce(buf, group=group)
    return torch.cat(buf.unbind(0), dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x` summed over the points group, this rank's slice along `dim`."""
    r, sp = _points_axis()
    group = _layout['points']
    n = x.shape[dim] // sp
    if _native():
        parts = torch.stack(x.split(n, dim=dim)).contiguous()
        out = x.new_empty(parts.shape[1:])
        _timed(dist.reduce_scatter_tensor, out, parts, group=group)
        return out
    return _all_reduce(x.contiguous().clone(), group=group).narrow(
        dim, r * n, n).contiguous()


class _GatherPoints(torch.autograd.Function):
    """All-gather along a dim over the points group.  Where each rank
    consumes the whole differently (`replicated` False: an SA level's
    centres, an FP level's known set) the gradient of a rank's slice is
    the sum of every rank's gradient of it, a reduce-scatter; where every
    rank of the group computes the same from it (`replicated`: the
    boundary of the split region) each already holds that sum, so the
    backward keeps its own slice."""

    @staticmethod
    def forward(ctx, x, dim, replicated):
        ctx.dim, ctx.replicated, ctx.n = dim, replicated, x.shape[dim]
        return _gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.replicated:
            r, _ = _points_axis()
            return grad.narrow(ctx.dim, r * ctx.n, ctx.n), None, None
        return _reduce_scatter(grad, ctx.dim), None, None


class _ScatterPoints(torch.autograd.Function):
    """Reduce-scatter along a dim over the points group: each rank's
    partial sums for every point, summed, this rank's slice kept.  Its
    backward is the all-gather of the slices' gradients."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim), None


def gather_points(x: Optional[torch.Tensor], dim: int = 1,
                  replicated: bool = False) -> Optional[torch.Tensor]:
    """The whole of `x` along `dim` from the points group's slices, in
    rank order (the one-process order); `x` itself where the world has no
    points axis.  `replicated`: every rank of the group computes the same
    from the result (see `_GatherPoints`)."""
    if x is None or _points_axis() is None:
        return x
    return _GatherPoints.apply(x, dim, replicated)


def scatter_points(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """`x` summed over the points group, this rank's contiguous slice along
    `dim`; `x` itself where the world has no points axis."""
    if _points_axis() is None:
        return x
    return _ScatterPoints.apply(x, dim)


def halo(x: torch.Tensor, dim: int, left: int, right: int) -> torch.Tensor:
    """`x` widened along `dim` by the `left` last entries of the left
    neighbour's slice and the `right` first of the right neighbour's,
    zeros at the ends of the whole (a convolution's zero padding at the
    true border).  The gradient of a halo goes back to the neighbour that
    sent it (the gather's reduce-scatter)."""
    r, sp = _points_axis()
    n = x.shape[dim]
    edges = torch.cat([x.narrow(dim, 0, right),
                       x.narrow(dim, n - left, left)], dim=dim)
    every = gather_points(edges, dim)
    e = left + right
    lo = (every.narrow(dim, (r - 1) * e + right, left) if r > 0
          else torch.zeros_like(x.narrow(dim, 0, left)))
    hi = (every.narrow(dim, (r + 1) * e, right) if r < sp - 1
          else torch.zeros_like(x.narrow(dim, 0, right)))
    return torch.cat([lo, x, hi], dim=dim)


class _LossSum(torch.autograd.Function):
    """Sum over ranks whose consumers are the same on every rank (a loss
    normalized by it): each rank's gradient is its own rows' share, so
    the backward passes it on unchanged and `sum_grads` adds the shares."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone(), group=_sum_group())

    @staticmethod
    def backward(ctx, grad):
        return grad


class _StatSum(torch.autograd.Function):
    """Sum over ranks whose consumers are each rank's own rows
    (BatchNorm's statistics): the gradient of the sum is the sum of every
    rank's rows' gradients, so the backward sums over ranks too."""

    @staticmethod
    def forward(ctx, x):
        ctx.group = _sum_group()
        return _all_reduce(x.clone(), group=ctx.group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), group=ctx.group)


def loss_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks, for a loss term (see `_LossSum`)."""
    return x if split() is None else _LossSum.apply(x)


def stat_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks, for statistics that every rank's rows
    are normalized by (see `_StatSum`)."""
    return x if split() is None else _StatSum.apply(x)


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """`x` maximized over the ranks, without gradient."""
    if split() is None:
        return x
    return _all_reduce(x.detach().clone(), dist.ReduceOp.MAX,
                       group=_sum_group())


def sum_grads(params: Iterable[torch.nn.Parameter],
              replicated: Iterable[torch.nn.Parameter] = ()) -> None:
    """Sum every parameter's gradient over the world, in place, in one
    flat buffer: each rank then holds the gradient of the global loss.  A
    parameter without a gradient on a rank counts as 0 there, as under
    `jax.grad`; one without a gradient on every rank keeps None.  The
    parameters of `replicated`, which every rank of a points group
    computes alike, have their sum divided by sp (so every rank ends with
    the same gradient even where two ranks of a group round apart)."""
    if split() is None:
        return
    params = list(params)
    if not params:
        return
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.float32, device=params[0].device)
    live = [p for p, h in zip(params, _all_reduce(has).tolist()) if h]
    if not live:
        return
    flat = _all_reduce(torch.cat([
        (torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
        for p in live]))
    _, sp = layout()
    shared = {id(p) for p in replicated} if sp > 1 else set()
    for p, g in zip(live, flat.split([p.numel() for p in live])):
        g = g.view_as(p)
        p.grad = g / sp if id(p) in shared else g


def put_replicated(tensors: Iterable[torch.Tensor]) -> None:
    """Broadcast each tensor from rank 0 into every rank's copy, in place
    (parameters, buffers, optimizer state: each rank then starts from rank
    0's, whatever it built or loaded)."""
    if split() is None:
        return
    for t in tensors:
        dist.broadcast(t.data, src=0)


def broadcast_int(value: int, device) -> int:
    """Rank 0's `value` (an optimizer's step count, a checkpoint's epoch)."""
    if split() is None:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return int(t.item())


def barrier() -> None:
    if split() is not None:
        dist.barrier()
