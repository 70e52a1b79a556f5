"""Bodies of the ranks that `parallel.mesh.spawn` starts (a child imports
its function by name, and a package's `__main__` module is not imported
by name).

`cli_rank` is one rank of `python -m jmodt_torch.train --data_parallel`
(or `--points_parallel`).  `run_steps` takes a few train steps and writes
the rank's results to a file: what shows that N ranks take the step one
process takes on the global batch (the CPU tests run it over gloo, and the
smoke run on the card over gloo and NCCL); called directly, without a
process group, it is the one process the ranks are held against.
`on_ranks` spawns those ranks, on a (world / points, points) mesh, and
reads their files back (`on_ranks_each`: several runs in one spawn).  With `record` set, rank 0 also keeps the inputs
each kernel wrapper got in its first step (`record_kernel_inputs`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, List, Mapping, Optional, Sequence

import torch

from jmodt_torch.config import Config
from jmodt_torch.models.point_rcnn import PointRCNN
from jmodt_torch.ops import kernels
from jmodt_torch.parallel import mesh
from jmodt_torch.train.train_step import (make_optimizer, make_train_step,
                                          scalars)


def cli_rank(device, argv: Sequence[str]) -> None:
    """One rank of the training CLI: its run on `device`."""
    from jmodt_torch.train import __main__ as cli
    cli.train(cli.parse_args(argv)[0], device)


# the kernel wrappers `record_kernel_inputs` records, by kernel
KERNEL_NAMES = ('fps', 'fps_batched', 'three_nn', 'grouped_gather_mlp_max',
                'sa_level', 'depth_to_space', 'ball_query')


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


@contextlib.contextmanager
def record_kernel_inputs():
    """Inside, every call of a kernel wrapper on the model's path is
    recorded, its arguments copied to the host: yields {kernel name:
    [args, ...]} in call order.  An FPS call is filed under the kernel
    whose launch count it raised (K1 or K2; on the CPU, where nothing
    launches, under 'fps')."""
    import jmodt_torch.models.image_backbone as image_backbone
    import jmodt_torch.models.pointnet2 as pointnet2
    import jmodt_torch.ops.fused_sa as fused_sa
    calls = {k: [] for k in KERNEL_NAMES}
    originals = (pointnet2.farthest_point_sample, pointnet2.three_nn,
                 pointnet2.sa_level_fused, fused_sa.grouped_gather_mlp_max,
                 image_backbone.depth_to_space, pointnet2.ball_query_multi)

    def fps(xyz, npoint):
        before = kernels.launches.copy()
        out = originals[0](xyz, npoint)
        took = [n for n in ('fps', 'fps_batched')
                if kernels.launches[n] > before[n]]
        calls[took[0] if len(took) == 1 else 'fps'].append(
            _to_cpu((xyz, npoint)))
        return out

    def spy(name, fn):
        def recorded(*args):
            calls[name].append(_to_cpu(args))
            return fn(*args)
        return recorded

    pointnet2.farthest_point_sample = fps
    pointnet2.three_nn = spy('three_nn', originals[1])
    pointnet2.sa_level_fused = spy('sa_level', originals[2])
    fused_sa.grouped_gather_mlp_max = spy('grouped_gather_mlp_max',
                                          originals[3])
    image_backbone.depth_to_space = spy('depth_to_space', originals[4])
    pointnet2.ball_query_multi = spy('ball_query', originals[5])
    try:
        yield calls
    finally:
        (pointnet2.farthest_point_sample, pointnet2.three_nn,
         pointnet2.sa_level_fused, fused_sa.grouped_gather_mlp_max,
         image_backbone.depth_to_space,
         pointnet2.ball_query_multi) = originals


def run_steps(device, cfg: Config, state: Mapping[str, torch.Tensor],
              batches: Sequence[Mapping[str, Any]], out_dir: str,
              seed: int = 0, draws: Optional[Sequence] = None,
              record: bool = False) -> dict:
    """One train step of PointRCNN(mode='TRAIN') with weights `state` per
    global batch of `batches` (numpy), on this rank's share
    (`mesh.shard_batch`), with `draws[i]` as step i's RoI draws when
    given.  Writes and returns {'rank', 'layout': (dp, sp), 'build_s'
    (seconds this process spent building the kernels), 'steps': [{'tb':
    loss terms, 'launches': kernel launches, 'ms': the step's synchronized
    wall ms, 'collectives', 'collective_ms': this rank's collectives in
    the step}], 'state': the model's state after the last step, 'grads':
    its gradients, 'peak_gib': peak device memory on a card, else None},
    in `out_dir`/rank<r>.pt.  With `record`, rank 0 also writes the kernel
    inputs of its first step (`record_kernel_inputs`) to
    `out_dir`/kernel_inputs.pt."""
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    build_s = kernels.build() if cuda else 0.0
    model = PointRCNN(cfg, mode='TRAIN', device='meta').to_empty(device=dev)
    model.load_state_dict(state)
    optimizer = make_optimizer(cfg, model, steps_per_epoch=len(batches))
    drawn = (None if draws is None else
             lambda *_: draws[optimizer.count].to(dev))
    step = make_train_step(cfg, model, optimizer, seed, dev, roi_draws=drawn)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for i, batch in enumerate(batches):
        local = mesh.shard_batch(batch)
        kernels.launches.clear()
        calls, secs = mesh.stats['calls'], mesh.stats['seconds']
        recording = record and i == 0 and mesh.rank() == 0
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with (record_kernel_inputs() if recording
              else contextlib.nullcontext()) as inputs:
            tb = step(local)
        if cuda:
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        if recording:
            os.makedirs(out_dir, exist_ok=True)
            torch.save(inputs, os.path.join(out_dir, 'kernel_inputs.pt'))
        steps.append({'tb': scalars(tb), 'launches': dict(kernels.launches),
                      'ms': ms, 'collectives': mesh.stats['calls'] - calls,
                      'collective_ms': (mesh.stats['seconds'] - secs) * 1e3})
    out = {'rank': mesh.rank(), 'layout': mesh.layout(),
           'build_s': build_s, 'steps': steps,
           'state': {k: v.detach().cpu()
                     for k, v in model.state_dict().items()},
           'grads': {k: None if p.grad is None else p.grad.detach().cpu()
                     for k, p in model.named_parameters()},
           'peak_gib': (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                        if cuda else None)}
    os.makedirs(out_dir, exist_ok=True)
    torch.save(out, os.path.join(out_dir, f'rank{out["rank"]}.pt'))
    return out


def run_jobs(device, jobs: Sequence[Mapping[str, Any]]) -> None:
    """`run_steps(device, **job)` for each of `jobs` in turn: several runs
    in one process group."""
    for job in jobs:
        run_steps(device, **job)


def on_ranks(world: int, cfg: Config, state: Mapping[str, torch.Tensor],
             batches: Sequence[Mapping[str, Any]], out_dir: str,
             device=None, seed: int = 0, draws: Optional[Sequence] = None,
             threads: Optional[int] = None, points: int = 1,
             record: bool = False) -> List[dict]:
    """`run_steps` on `world` spawned ranks in points groups of `points`
    (`mesh.spawn`'s devices: a card each when `device` is None, else all
    on `device`); every rank's results, in rank order.  Raises when a rank
    fails."""
    return on_ranks_each(world, [dict(
        cfg=cfg, state=state, batches=batches, out_dir=out_dir, seed=seed,
        draws=draws, record=record)], device, threads, points)[0]


def on_ranks_each(world: int, jobs: Sequence[Mapping[str, Any]],
                  device=None, threads: Optional[int] = None,
                  points: int = 1) -> List[List[dict]]:
    """`on_ranks` for each of `jobs` (`run_steps`' keyword arguments but
    the device) in turn, in one spawn of the ranks; for each job every
    rank's results, in rank order."""
    jobs = [dict(job, state={k: v.detach().cpu()
                             for k, v in job['state'].items()})
            for job in jobs]
    for job in jobs:
        os.makedirs(job['out_dir'], exist_ok=True)
    rendezvous = os.path.join(os.path.abspath(jobs[0]['out_dir']),
                              'rendezvous')
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    mesh.spawn(run_jobs, world, args=(jobs,),
               init_method=f'file://{rendezvous}',
               device=device, threads=threads, points=points)
    return [[torch.load(os.path.join(job['out_dir'], f'rank{r}.pt'),
                        weights_only=True) for r in range(world)]
            for job in jobs]
