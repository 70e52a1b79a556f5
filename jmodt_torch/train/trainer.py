"""Epoch-loop trainer and its batch loader (counterpart of
`jmodt_tpu/train/trainer.py`).

Per-epoch train and optional val epochs, a checkpoint every `ckpt_every`
epochs (the last epoch always; written in the background with an
`AsyncCheckpointWriter`), a best-model snapshot by val loss, and the
early stop when the train loss falls while the val loss rises for more
than `stop_thres` epochs in a row.  The loss is read to the host only every
`log_every` steps.  The next batch is copied to the device from pinned
memory without blocking while the current step runs.  With a tensorboardX
writer it writes the JAX trainer's scalars at its steps.

Data parallel (`parallel.mesh`): every rank runs a Trainer on its rows of
each batch.  The model and optimizer state start from rank 0's; the steps
keep them equal on every rank, and every loss the trainer logs is the
global batch's.  Rank 0 alone writes checkpoints (then all ranks meet at a
barrier) and tensorboard scalars.

`make_loader` batches a `KittiDataset`: in this process with the JAX
package's `RandomState` epoch order (each batch bit-equal to its
`make_loader`'s), or in worker processes through
`torch.utils.data.DataLoader`.  As in the JAX package, every worker starts
from a copy of the dataset's random state, so workers repeat each other's
augmentation draws.  When the batch is split over ranks it yields this
rank's rows.
"""

from __future__ import annotations

import logging
import math
import multiprocessing
import os
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from jmodt_torch.config import Config
from jmodt_torch.device import resolve_device
from jmodt_torch.parallel import mesh
from jmodt_torch.train.checkpoint import checkpoint_state, save_checkpoint
from jmodt_torch.train.train_step import (Optimizer, make_train_step,
                                          make_val_step, scalars, to_device)

logger = logging.getLogger(__name__)


class Trainer:
    """:param model: PointRCNN(mode='TRAIN')
    :param optimizer: from `make_optimizer`
    :param device: default the CUDA card (raises without one)
    :param ckpt_writer: an `AsyncCheckpointWriter`, or None to write
        checkpoints in the loop
    :param tb_log: a tensorboardX `SummaryWriter`, or None
    """

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 optimizer: Optimizer, ckpt_dir: str,
                 log: Optional[logging.Logger] = None, log_every: int = 1,
                 ckpt_every: int = 1, seed: int = 0, device=None,
                 ckpt_writer: Any = None, tb_log: Any = None):
        self.cfg = cfg
        self.ckpt_writer = ckpt_writer
        self.tb_log = tb_log
        self.model = model
        self.optimizer = optimizer
        self.device = resolve_device(device)
        self.ckpt_dir = ckpt_dir
        self.log = log or logger
        self.log_every = max(int(log_every), 1)
        self.ckpt_every = max(int(ckpt_every), 1)
        mesh.put_replicated([*model.state_dict().values(), *optimizer.mu,
                             *optimizer.nu])
        optimizer.count = mesh.broadcast_int(optimizer.count, self.device)
        self._train_step = make_train_step(cfg, model, optimizer, seed,
                                           self.device)
        self._val_step = make_val_step(cfg, model, seed, self.device)

    def _batches(self, iterable):
        """The batches on the device, each copy issued before the previous
        batch's step runs."""
        nxt = None
        for batch in iterable:
            cur, nxt = nxt, to_device(batch, self.device, non_blocking=True)
            if cur is not None:
                yield cur
        if nxt is not None:
            yield nxt

    def eval_epoch(self, val_loader: Iterable) -> tuple:
        """(the mean of the positive val losses, 0 when there is none;
        {loss term: its mean over the batches where it is not NaN})."""
        total = []
        sums: dict = {}
        nans: dict = {}
        n = 0
        for batch in self._batches(val_loader):
            n += 1
            loss, tb = self._val_step(batch)
            loss = float(loss)
            if loss > 0:
                total.append(loss)
            for k, v in scalars(tb).items():
                if math.isnan(v):
                    nans[k] = nans.get(k, 0) + 1
                else:
                    sums[k] = sums.get(k, 0.0) + v
        means = {k: v / max(n - nans.get(k, 0), 1) for k, v in sums.items()}
        return (sum(total) / len(total) if total else 0.0), means

    def _save(self, name: str, with_optimizer: bool, epoch=None, it=None):
        if mesh.rank() == 0:
            save_checkpoint(checkpoint_state(
                self.model, self.optimizer if with_optimizer else None,
                epoch, it), os.path.join(self.ckpt_dir, name),
                writer=self.ckpt_writer)
        mesh.barrier()

    def _scalar(self, name: str, value: float, step: int) -> None:
        if self.tb_log is not None:
            self.tb_log.add_scalar(name, value, step)

    def train(self, start_it: int, start_epoch: int, n_epochs: int,
              train_loader_fn: Callable[[], Iterable],
              val_loader_fn: Optional[Callable[[], Iterable]] = None,
              stop_thres: int = 5) -> torch.nn.Module:
        """`train_loader_fn()` gives a fresh epoch of numpy batches."""
        it = start_it
        min_val_loss = float('inf')
        last_logged = 0.0     # carried across epochs shorter than log_every
        prev_train_loss = prev_val_loss = -1.0
        counter = 0
        val_loss_epoch = 0.0
        for epoch in range(start_epoch, n_epochs):
            t0 = time.time()
            train_losses = []
            for batch in self._batches(train_loader_fn()):
                it += 1
                tb = self._train_step(batch)
                if it % self.log_every:
                    continue          # no host read: steps queue back to back
                vals = scalars(tb)
                if vals['loss'] > 0:
                    train_losses.append(vals['loss'])
                    self._scalar('train_loss', vals['loss'], it)
                    for k, v in vals.items():
                        self._scalar('train_' + k, v, it)
            trained_epoch = epoch + 1
            train_loss_epoch = (sum(train_losses) / len(train_losses)
                                if train_losses else last_logged)
            last_logged = train_loss_epoch
            self.log.info('epoch %d: train_loss=%.4f (%.1fs, %d its)',
                          trained_epoch, train_loss_epoch, time.time() - t0,
                          it - start_it)
            self._scalar('train_loss_epoch', train_loss_epoch, trained_epoch)
            if (trained_epoch % self.ckpt_every == 0
                    or trained_epoch == n_epochs):
                self._save('checkpoint_epoch_%d' % trained_epoch, True,
                           trained_epoch, it)

            if val_loader_fn is not None:
                val_loss_epoch, val_terms = self.eval_epoch(val_loader_fn())
                self.log.info('epoch %d: val_loss=%.4f %s', trained_epoch,
                              val_loss_epoch, ' '.join(
                                  f'{k}={v:.4f}' for k, v in
                                  sorted(val_terms.items())))
                self._scalar('val_loss_epoch', val_loss_epoch, trained_epoch)
                for k, v in val_terms.items():
                    self._scalar('val_' + k, v, trained_epoch)

            # early stop: train loss down while val loss up, stop_thres
            # epochs running
            if prev_train_loss != -1 and prev_val_loss != -1:
                if (train_loss_epoch < prev_train_loss
                        and val_loss_epoch > prev_val_loss):
                    counter += 1
                    self.log.info('Bad train')
                    if counter > stop_thres:
                        self.log.info('Early stopping')
                        break
                else:
                    counter = 0
            else:
                prev_train_loss = train_loss_epoch
                prev_val_loss = val_loss_epoch

            if val_loader_fn is not None and val_loss_epoch < min_val_loss:
                min_val_loss = val_loss_epoch
                self._save('best_model', False)
        if self.ckpt_writer is not None:
            self.ckpt_writer.wait()
        return self.model


def make_loader(dataset, batch_size: int, shuffle: bool = True,
                num_workers: int = 0, seed: int = 0, drop_last: bool = True,
                part: Optional[int] = None, parts: Optional[int] = None
                ) -> Callable[[], Iterable]:
    """A factory of epochs of collated numpy batches over a
    `KittiDataset`-style object (`__len__`, `__getitem__`,
    `collate_batch`).

    At `num_workers` 0 the epoch order is drawn from one
    `np.random.RandomState(seed)` across epochs, as the JAX package's
    `make_loader` draws it.  Otherwise `torch.utils.data.DataLoader`
    prefetches in `num_workers` processes started fresh each epoch
    (spawned: the trainer's process holds the card and a checkpoint
    thread), shuffling with a `torch.Generator` seeded `seed`.

    Each batch is data shard `part`'s pairs of the one-process batch when
    it is split over `parts` shards (default: this process's data rank and
    dp, `parallel.mesh`): every rank draws the same order.  At
    `num_workers` 0 the rank loads the whole batch, so that the dataset's
    random draws are the one process's, and keeps its rows; its worker
    processes load its pairs alone.  On a (data, points) mesh the rank
    then keeps its slice of the points and of the image width
    (`mesh.shard_points`)."""
    dp, sp = mesh.layout()
    part = mesh.rank() // sp if part is None else part
    parts = dp if parts is None else parts
    if num_workers > 0:
        gen = torch.Generator().manual_seed(seed) if shuffle else None
        order = (torch.utils.data.RandomSampler(dataset, generator=gen)
                 if shuffle else torch.utils.data.SequentialSampler(dataset))
        loader = torch.utils.data.DataLoader(
            dataset, batch_sampler=_RankBatches(
                torch.utils.data.BatchSampler(order, batch_size, drop_last),
                part, parts),
            num_workers=num_workers, collate_fn=dataset.collate_batch,
            generator=gen,
            multiprocessing_context=multiprocessing.get_context('spawn'))
        return lambda: (mesh.shard_points(b) for b in loader)

    rng = np.random.RandomState(seed)

    def epoch():
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            batch = dataset.collate_batch([dataset[j] for j in
                                           order[i:i + batch_size]])
            yield mesh.shard_batch(batch, part, parts)

    return epoch


class _RankBatches:
    """Rank `part`'s share of each batch of indices of `batches`."""

    def __init__(self, batches, part: int, parts: int):
        self.batches, self.part, self.parts = batches, part, parts

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        for idx in self.batches:
            n = mesh.pairs_per_rank(len(idx), self.parts)
            yield idx[self.part * n:(self.part + 1) * n]
