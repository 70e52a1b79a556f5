"""Data-parallel training over processes (the data axis of
`jmodt_tpu/parallel/mesh.py`).

The JAX package trains one program over a global batch: GSPMD splits the
batch over a 1-D `data` mesh and makes every reduction over the batch
global (BatchNorm's batch statistics, each loss's normalizer, the
gradient).  Here N processes (ranks) each take a contiguous 1/N of the
batch's rows and together take the step one process takes on the whole
batch, up to float32 summation order:

* `init` joins the process group, from torchrun's environment or from the
  rank, world size and rendezvous it is given; `spawn` starts the ranks
  itself, each running a function of this package.
* `shard_batch` cuts this rank's rows; `global_rows` / `local_rows` let a
  random draw be made for the whole batch and cut the same way.
* `put_replicated` broadcasts parameters, buffers and optimizer state
  from rank 0.
* `loss_sum` and `stat_sum` are the sums over ranks the losses and
  BatchNorm take (they differ in what their backward passes on),
  `batch_max` a maximum, and `sum_grads` sums the gradients.

The batch is split while a process group is initialized, outside
`rank_local()`; otherwise every helper is the one-process identity.  The
backend is NCCL when every rank has a card of its own, gloo when ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU.
Gloo on CUDA tensors supports only broadcast, all_reduce and barrier, so
these helpers use nothing else.

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

stats = {'calls': 0, 'seconds': 0.0}

# a collective that waits longer raises (a rank that died, a hang)
TIMEOUT_S = 600.0


def split() -> Optional[Tuple[int, int]]:
    """(rank, world size) while the batch is split over a process group,
    None outside one or inside `rank_local()`."""
    if _LOCAL.get() or not dist.is_initialized():
        return None
    return dist.get_rank(), dist.get_world_size()


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


def init(rank: Optional[int] = None, world: Optional[int] = None,
         init_method: Optional[str] = None, device=None,
         local_rank: Optional[int] = None,
         local_world: Optional[int] = None) -> torch.device:
    """Join the process group; returns this rank's device.

    What is not given comes from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE; rendezvous at MASTER_ADDR:MASTER_PORT).
    With `device` None the rank takes card LOCAL_RANK mod the visible
    cards; a `device` given puts every rank of this host on it ('cpu', or
    one card that the ranks share).  A collective that waits longer than
    TIMEOUT_S raises."""
    rank = _env_int('RANK') if rank is None else rank
    world = _env_int('WORLD_SIZE') if world is None else world
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
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, init_method: str, device,
               threads: Optional[int], fn: Callable, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = init(rank, world, init_method, device, local_rank=rank,
               local_world=world)
    try:
        fn(dev, *args)
    finally:
        shutdown()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          init_method: Optional[str] = None, device=None,
          threads: Optional[int] = None) -> None:
    """Run `fn(device, *args)` in `world` new processes, ranks 0..world-1
    of one process group on this host (`init`'s devices: a card each when
    `device` is None).  `fn` is pickled by its import path, so it is a
    module-level function of a package.  The rendezvous is `init_method`,
    or a free TCP port on localhost; `threads` sets each rank's torch
    threads.  Raises when a rank fails; the others are then stopped."""
    if init_method is None:
        init_method = f'tcp://localhost:{free_port()}'
    mp.spawn(_rank_main, args=(world, init_method, device, threads, fn,
                               tuple(args)),
             nprocs=world, join=True)


# --------------------------------------------------------------------------
# the batch
# --------------------------------------------------------------------------

def pairs_per_rank(pairs: int, world: int) -> int:
    """Frame pairs a rank takes from a batch of `pairs`; raises when the
    ranks cannot take equal whole pairs."""
    if pairs % world:
        raise ValueError(f'a batch of {pairs} frame pairs does not split '
                         f'over {world} ranks: every rank takes the same '
                         f'number of whole pairs, so --batch_size must be '
                         f'a multiple of {world}')
    return pairs // world


def shard_batch(batch: Mapping[str, Any], part: Optional[int] = None,
                parts: Optional[int] = None) -> dict:
    """This rank's rows of a global batch of interleaved (prev, next)
    frame pairs: rows [r B / N, (r + 1) B / N) of every array (numpy or
    tensor) whose leading dim is the batch's B frames, so every pair stays
    on one rank; other entries as they are.  r is `part` of `parts`,
    default this process's rank of its world size."""
    part = rank() if part is None else part
    parts = world_size() if parts is None else parts
    b = batch['pts_input'].shape[0]
    n = 2 * pairs_per_rank(b // 2, parts)
    out = {}
    for k, v in batch.items():
        rows = (isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0
                and v.shape[0] == b)
        out[k] = v[part * n:(part + 1) * n] if rows else v
    return out


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

def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op)
    stats['calls'] += 1
    stats['seconds'] += time.perf_counter() - t0
    return t


class _LossSum(torch.autograd.Function):
    """Sum over ranks whose consumers are the same on every rank (a loss
    normalized by it): each rank's gradient is its own rows' share, so
    the backward passes it on unchanged and `sum_grads` adds the shares."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad


class _StatSum(torch.autograd.Function):
    """Sum over ranks whose consumers are each rank's own rows
    (BatchNorm's statistics): the gradient of the sum is the sum of every
    rank's rows' gradients, so the backward sums over ranks too."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone())


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
    return _all_reduce(x.detach().clone(), dist.ReduceOp.MAX)


def sum_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the ranks, in place, in one
    flat buffer: each rank then holds the gradient of the global loss.  A
    parameter without a gradient on a rank counts as 0 there, as under
    `jax.grad`; one without a gradient on every rank keeps None."""
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
    for p, g in zip(live, flat.split([p.numel() for p in live])):
        p.grad = g.view_as(p)


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
