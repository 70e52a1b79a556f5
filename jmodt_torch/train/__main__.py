"""Train or finetune the joint detection + ReID model.

    python -m jmodt_torch.train [--data_root <KITTI root>] [--small]
        [--finetune] [--batch_size 4] [--epochs N] [--workers 4]
        [--train_with_eval] [--ckpt FILE] [--async_ckpt]
        [--output_dir output] [--device cpu] [--set KEY VALUE ...]

The counterpart of `tools/train.py`, with its flags but its parallel ones
(one card, no mesh).  With `--data_root` it trains on a KITTI root's
`tracking_object/` tree (`python -m jmodt_torch.data.converter`), the pairs
of `cfg.TRAIN.SPLIT`, loaded by `--workers` processes (0: in this
process); `--train_with_eval` adds a val epoch over `cfg.TRAIN.VAL_SPLIT`.
Without it, it trains on synthetic pairs (`--synthetic_pairs` an epoch).
Finetune (the link / se heads only, the RPN frozen) is the default and
passing `--finetune` turns it off (full losses, as `tools/train.py`
does).  `--batch_size` counts frame pairs a step.  `--set` overrides
config keys (`config.config_from_overrides`) and takes the rest of the
line.  Runs on the CUDA card unless given `--device cpu`.  Writes
`train.log` and checkpoints under `<output_dir>/ckpt`, with `--async_ckpt`
on a background thread.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

from jmodt_torch.config import Config, config_from_overrides, small_config
from jmodt_torch.data.synthetic import make_pair_batch
from jmodt_torch.device import resolve_device
from jmodt_torch.models.point_rcnn import build_detector
from jmodt_torch.train.checkpoint import AsyncCheckpointWriter, load_checkpoint
from jmodt_torch.train.train_step import make_optimizer
from jmodt_torch.train.trainer import Trainer, make_loader


def create_logger(log_file: str) -> logging.Logger:
    """The trainer's logger, printing to the console; `log_file` gets the
    records of every logger, through a handler on the root logger (a
    second call, as an in-process run makes, replaces it)."""
    fmt = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        if isinstance(h, logging.FileHandler):
            root.removeHandler(h)
            h.close()
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    root.addHandler(fh)
    logger = logging.getLogger('jmodt_torch.train')
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    logger.addHandler(console)
    return logger


def kitti_set(args, cfg, split, img_hw, logger):
    from jmodt_torch.data.kitti_dataset import KittiDataset
    return KittiDataset(root_dir=args.data_root, npoints=cfg.RPN.NUM_POINTS,
                        split=split, mode='TRAIN', logger=logger,
                        classes=cfg.CLASSES, challenge=args.challenge,
                        cfg=cfg, fixed_img_size=img_hw)


def synthetic_loader_fn(cfg, pairs_per_epoch, batch_pairs, img_hw, seed0):
    def gen():
        for i in range(pairs_per_epoch // batch_pairs):
            yield make_pair_batch(seed=seed0 + i, cfg=cfg,
                                  num_pairs=batch_pairs, img_hw=img_hw)
    return gen


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--data_root', type=str, default=None,
                        help='KITTI root holding tracking_object/ (default: '
                             'synthetic pairs)')
    parser.add_argument('--challenge', type=str, default='tracking')
    parser.add_argument('--finetune', action='store_false',
                        help='finetune the link / se heads only (default '
                             'true; passing the flag turns it off)')
    parser.add_argument('--batch_size', type=int, default=4,
                        help='frame pairs a step')
    parser.add_argument('--output_dir', type=str, default='output')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--train_with_eval', action='store_true')
    parser.add_argument('--small', action='store_true',
                        help='the miniature config, for smoke runs')
    parser.add_argument('--ckpt_every', type=int, default=1)
    parser.add_argument('--log_every', type=int, default=1)
    parser.add_argument('--workers', type=int, default=4,
                        help='loader processes with --data_root (0: load '
                             'in this process)')
    parser.add_argument('--async_ckpt', action='store_true',
                        help='write checkpoints on a background thread')
    parser.add_argument('--synthetic_pairs', type=int, default=16,
                        help='pairs a synthetic epoch (no --data_root)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default=None,
                        help='default: the CUDA card')
    parser.add_argument('--set', dest='set_cfgs', default=None,
                        nargs=argparse.REMAINDER,
                        help='config overrides KEY VALUE ... (the rest of '
                             'the line)')
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = create_logger(os.path.join(args.output_dir, 'train.log'))
    cfg = small_config() if args.small else Config()
    if args.set_cfgs:
        cfg = config_from_overrides(cfg, args.set_cfgs)
    cfg = dataclasses.replace(
        cfg, RPN=dataclasses.replace(cfg.RPN, FIXED=args.finetune),
        TRAIN=dataclasses.replace(cfg.TRAIN, FINETUNE=args.finetune))
    if args.epochs is not None:
        cfg = dataclasses.replace(
            cfg, TRAIN=dataclasses.replace(cfg.TRAIN, EPOCHS=args.epochs))
    logger.info('device %s dtype %s', device, cfg.DTYPE)
    # tools/ladder_report.py parses this line
    logger.info('finetune=%s fusion=%s epochs=%d', args.finetune,
                cfg.LI_FUSION.ENABLED, cfg.TRAIN.EPOCHS)

    img_hw = (64, 128) if args.small else (384, 1280)
    if args.data_root:
        train_set = kitti_set(args, cfg, cfg.TRAIN.SPLIT, img_hw, logger)
        train_loader_fn = make_loader(train_set, args.batch_size,
                                      shuffle=True, num_workers=args.workers,
                                      seed=args.seed)
        steps_per_epoch = max(len(train_set) // args.batch_size, 1)
        val_loader_fn = None
        if args.train_with_eval:
            val_set = kitti_set(args, cfg, cfg.TRAIN.VAL_SPLIT, img_hw,
                                logger)
            val_loader_fn = make_loader(val_set, args.batch_size,
                                        shuffle=False,
                                        num_workers=min(args.workers, 2))
    else:
        logger.info('no --data_root: training on synthetic pairs')
        train_loader_fn = synthetic_loader_fn(cfg, args.synthetic_pairs,
                                              args.batch_size, img_hw, 0)
        val_loader_fn = (synthetic_loader_fn(
            cfg, max(args.synthetic_pairs // 4, args.batch_size),
            args.batch_size, img_hw, 10_000)
            if args.train_with_eval else None)
        steps_per_epoch = max(args.synthetic_pairs // args.batch_size, 1)
    logger.info('%d steps an epoch', steps_per_epoch)

    model = build_detector(cfg, mode='TRAIN', device=device, seed=args.seed)
    optimizer = make_optimizer(cfg, model, steps_per_epoch)
    it = start_epoch = 0
    if args.ckpt:
        if cfg.TRAIN.RELOAD_OPTIMIZER:
            # resume: weights, optimizer and the epoch it reached
            it, start_epoch = load_checkpoint(args.ckpt, model, optimizer,
                                              log=logger)
        else:
            # the checkpoint only seeds the weights (the finetune start)
            load_checkpoint(args.ckpt, model, strict=False, log=logger)

    ckpt_dir = os.path.join(args.output_dir, 'ckpt')
    writer = AsyncCheckpointWriter() if args.async_ckpt else None
    trainer = Trainer(cfg, model, optimizer, ckpt_dir, log=logger,
                      log_every=args.log_every, ckpt_every=args.ckpt_every,
                      seed=args.seed, device=device, ckpt_writer=writer)
    logger.info('*************** Start training ***************')
    try:
        trainer.train(it, start_epoch, cfg.TRAIN.EPOCHS, train_loader_fn,
                      val_loader_fn)
    finally:
        if writer is not None:
            writer.close()
    logger.info('*************** End training ***************')


if __name__ == '__main__':
    main()
