"""Train or finetune the joint detection + ReID model on synthetic scenes.

    python -m jmodt_torch.train [--small] [--finetune] [--batch_size 4]
        [--epochs N] [--synthetic_pairs 16] [--output_dir output]
        [--ckpt FILE] [--device cpu]

The synthetic branch of `tools/train.py`, with its flags: finetune (the
link / se heads only, the RPN frozen) is the default and passing
`--finetune` turns it off (full losses, as `tools/train.py` does).
`--batch_size` counts frame pairs a step.  Runs on the CUDA card unless
given `--device cpu`.  Writes `train.log` and checkpoints under
`<output_dir>/ckpt`.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

from jmodt_torch.config import Config, small_config
from jmodt_torch.data.synthetic import make_pair_batch
from jmodt_torch.device import resolve_device
from jmodt_torch.models.point_rcnn import build_detector
from jmodt_torch.train.checkpoint import load_checkpoint
from jmodt_torch.train.train_step import make_optimizer
from jmodt_torch.train.trainer import Trainer


def create_logger(log_file: str) -> logging.Logger:
    fmt = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    logger = logging.getLogger('jmodt_torch.train')
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    for h in (logging.FileHandler(log_file), logging.StreamHandler()):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def synthetic_loader_fn(cfg, pairs_per_epoch, batch_pairs, img_hw, seed0):
    def gen():
        for i in range(pairs_per_epoch // batch_pairs):
            yield make_pair_batch(seed=seed0 + i, cfg=cfg,
                                  num_pairs=batch_pairs, img_hw=img_hw)
    return gen


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
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
    parser.add_argument('--synthetic_pairs', type=int, default=16,
                        help='pairs a synthetic epoch')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default=None,
                        help='default: the CUDA card')
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = create_logger(os.path.join(args.output_dir, 'train.log'))
    cfg = small_config() if args.small else Config()
    cfg = dataclasses.replace(
        cfg, RPN=dataclasses.replace(cfg.RPN, FIXED=args.finetune),
        TRAIN=dataclasses.replace(cfg.TRAIN, FINETUNE=args.finetune))
    if args.epochs is not None:
        cfg = dataclasses.replace(
            cfg, TRAIN=dataclasses.replace(cfg.TRAIN, EPOCHS=args.epochs))
    logger.info('device %s finetune=%s epochs=%d dtype=%s', device,
                args.finetune, cfg.TRAIN.EPOCHS, cfg.DTYPE)

    img_hw = (64, 128) if args.small else (384, 1280)
    train_loader_fn = synthetic_loader_fn(cfg, args.synthetic_pairs,
                                          args.batch_size, img_hw, 0)
    val_loader_fn = (synthetic_loader_fn(
        cfg, max(args.synthetic_pairs // 4, args.batch_size),
        args.batch_size, img_hw, 10_000) if args.train_with_eval else None)
    steps_per_epoch = max(args.synthetic_pairs // args.batch_size, 1)

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
    trainer = Trainer(cfg, model, optimizer, ckpt_dir, log=logger,
                      log_every=args.log_every, ckpt_every=args.ckpt_every,
                      seed=args.seed, device=device)
    logger.info('*************** Start training ***************')
    trainer.train(it, start_epoch, cfg.TRAIN.EPOCHS, train_loader_fn,
                  val_loader_fn)
    logger.info('*************** End training ***************')


if __name__ == '__main__':
    main()
