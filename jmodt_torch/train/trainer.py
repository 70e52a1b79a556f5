"""Epoch-loop trainer and its batch loader (counterpart of
`jmodt_tpu/train/trainer.py`).

Per-epoch train and optional val epochs, a checkpoint every `ckpt_every`
epochs (the last epoch always; written in the background with an
`AsyncCheckpointWriter`), a best-model snapshot by val loss, and the
early stop when the train loss falls while the val loss rises for more
than `stop_thres` epochs in a row.  The loss is read to the host only every
`log_every` steps.  The next batch is copied to the device from pinned
memory without blocking while the current step runs.  One device; no
mesh.

`make_loader` batches a `KittiDataset`: in this process with the JAX
package's `RandomState` epoch order (each batch bit-equal to its
`make_loader`'s), or in worker processes through
`torch.utils.data.DataLoader`.  As in the JAX package, every worker starts
from a copy of the dataset's random state, so workers repeat each other's
augmentation draws.
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
    """

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 optimizer: Optimizer, ckpt_dir: str,
                 log: Optional[logging.Logger] = None, log_every: int = 1,
                 ckpt_every: int = 1, seed: int = 0, device=None,
                 ckpt_writer: Any = None):
        self.cfg = cfg
        self.ckpt_writer = ckpt_writer
        self.model = model
        self.optimizer = optimizer
        self.device = resolve_device(device)
        self.ckpt_dir = ckpt_dir
        self.log = log or logger
        self.log_every = max(int(log_every), 1)
        self.ckpt_every = max(int(ckpt_every), 1)
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
        save_checkpoint(checkpoint_state(
            self.model, self.optimizer if with_optimizer else None, epoch,
            it), os.path.join(self.ckpt_dir, name), writer=self.ckpt_writer)

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
            trained_epoch = epoch + 1
            train_loss_epoch = (sum(train_losses) / len(train_losses)
                                if train_losses else last_logged)
            last_logged = train_loss_epoch
            self.log.info('epoch %d: train_loss=%.4f (%.1fs, %d its)',
                          trained_epoch, train_loss_epoch, time.time() - t0,
                          it - start_it)
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
                num_workers: int = 0, seed: int = 0,
                drop_last: bool = True) -> Callable[[], Iterable]:
    """A factory of epochs of collated numpy batches over a
    `KittiDataset`-style object (`__len__`, `__getitem__`,
    `collate_batch`).

    At `num_workers` 0 the epoch order is drawn from one
    `np.random.RandomState(seed)` across epochs, as the JAX package's
    `make_loader` draws it.  Otherwise `torch.utils.data.DataLoader`
    prefetches in `num_workers` processes started fresh each epoch
    (spawned: the trainer's process holds the card and a checkpoint
    thread), shuffling with a `torch.Generator` seeded `seed`."""
    if num_workers > 0:
        gen = torch.Generator().manual_seed(seed) if shuffle else None
        loader = torch.utils.data.DataLoader(
            dataset, batch_size=batch_size, shuffle=shuffle,
            num_workers=num_workers, collate_fn=dataset.collate_batch,
            drop_last=drop_last, generator=gen,
            multiprocessing_context=multiprocessing.get_context('spawn'))
        return lambda: iter(loader)

    rng = np.random.RandomState(seed)

    def epoch():
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            yield dataset.collate_batch([dataset[j] for j in
                                         order[i:i + batch_size]])

    return epoch
