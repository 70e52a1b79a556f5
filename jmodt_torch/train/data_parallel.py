"""Bodies of the ranks that `parallel.mesh.spawn` starts (a child imports
its function by name, and a package's `__main__` module is not imported
by name).

`cli_rank` is one rank of `python -m jmodt_torch.train --data_parallel`.
`run_steps` takes a few train steps and writes the rank's results to a
file: what shows that N ranks take the step one process takes on the
global batch (the CPU tests run it over gloo, and the smoke run on the card
over gloo and NCCL); called directly, without a process group, it is the
one process the ranks are held against.  `on_ranks` spawns those ranks and
reads their files back.
"""

from __future__ import annotations

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


def run_steps(device, cfg: Config, state: Mapping[str, torch.Tensor],
              batches: Sequence[Mapping[str, Any]], out_dir: str,
              seed: int = 0, draws: Optional[Sequence] = None) -> dict:
    """One train step of PointRCNN(mode='TRAIN') with weights `state` per
    global batch of `batches` (numpy), on this rank's rows, with
    `draws[i]` as step i's RoI draws when given.  Writes and returns
    {'rank', 'build_s' (seconds this process spent building the kernels),
    'steps': [{'tb': loss terms, 'launches': kernel launches, 'ms': the
    step's synchronized wall ms, 'collectives', 'collective_ms': this
    rank's collectives in the step}], 'state': the model's state after the
    last step, 'grads': its gradients, 'peak_gib': peak device memory on a
    card, else None}, in `out_dir`/rank<r>.pt."""
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
    for batch in batches:
        local = mesh.shard_batch(batch)
        kernels.launches.clear()
        calls, secs = mesh.stats['calls'], mesh.stats['seconds']
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tb = step(local)
        if cuda:
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        steps.append({'tb': scalars(tb), 'launches': dict(kernels.launches),
                      'ms': ms, 'collectives': mesh.stats['calls'] - calls,
                      'collective_ms': (mesh.stats['seconds'] - secs) * 1e3})
    out = {'rank': mesh.rank(), 'build_s': build_s, 'steps': steps,
           'state': {k: v.detach().cpu()
                     for k, v in model.state_dict().items()},
           'grads': {k: None if p.grad is None else p.grad.detach().cpu()
                     for k, p in model.named_parameters()},
           'peak_gib': (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                        if cuda else None)}
    os.makedirs(out_dir, exist_ok=True)
    torch.save(out, os.path.join(out_dir, f'rank{out["rank"]}.pt'))
    return out


def on_ranks(world: int, cfg: Config, state: Mapping[str, torch.Tensor],
             batches: Sequence[Mapping[str, Any]], out_dir: str,
             device=None, seed: int = 0, draws: Optional[Sequence] = None,
             threads: Optional[int] = None) -> List[dict]:
    """`run_steps` on `world` spawned ranks (`mesh.spawn`'s devices: a
    card each when `device` is None, else all on `device`); every rank's
    results, in rank order.  Raises when a rank fails."""
    state = {k: v.detach().cpu() for k, v in state.items()}
    os.makedirs(out_dir, exist_ok=True)
    rendezvous = os.path.join(os.path.abspath(out_dir), 'rendezvous')
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    mesh.spawn(run_steps, world, args=(cfg, state, batches, out_dir, seed,
                                       draws),
               init_method=f'file://{rendezvous}',
               device=device, threads=threads)
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                       weights_only=True) for r in range(world)]
