"""The synthetic learning ladder through the port's own entry points.

    python -m jmodt_torch.tools.synthetic_ladder --out output/ladder
        [--frames 24] [--seqs 4] [--epochs1 500] [--epochs2 150]
        [--epochs3 60] [--device cpu] ...

The counterpart of `tools/synthetic_ladder.py`.  It writes a KITTI
tracking tree of constant-velocity cars with dense surface points
(`data/synthetic.py::write_synthetic_kitti_tree`), converts it
(`data/converter.py`), and trains the reference's three stages through
`python -m jmodt_torch.train`, in this process, at the small config:

  1. lidar-only from scratch (`--set LI_FUSION.ENABLED False`);
  2. fusion, from stage 1's checkpoint by the partial restore (the image
     and fusion parameters start fresh);
  3. the link / se finetune (the default mode), the detector frozen.

Then `python -m jmodt_torch.eval`'s stages on the validation sequences:
stage 1's official AP, stage 2 with the device tracker over all sequences
in lockstep, and CLEAR-MOT.  Prints one JSON line with the AP and MOTA,
the JAX tool's keys.  Everything runs on `--device` (default: the CUDA
card; raises without one).  At its smallest (`--frames 3 --seqs 2
--epochs1 1 --epochs2 1 --epochs3 1 --batch 2`) it takes seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import logging
import os
import re

from jmodt_torch.config import RCNNSAConfig, SAConfig, small_config
from jmodt_torch.data.converter import create_train_sample_data
from jmodt_torch.data.synthetic import write_synthetic_kitti_tree
from jmodt_torch.device import resolve_device
from jmodt_torch.eval import __main__ as eval_cli
from jmodt_torch.train import __main__ as train_cli


def wide_config(cfg):
    """The small config with its widths and point budget doubled: room
    for the ladder to learn."""
    sa = SAConfig(
        NPOINTS=(256, 128, 64, 32),
        RADIUS=cfg.RPN.SA_CONFIG.RADIUS,
        NSAMPLE=((8, 16),) * 4,
        MLPS=(((16, 16, 32), (16, 16, 32)),
              ((32, 32, 64), (32, 32, 64)),
              ((64, 64, 128), (64, 64, 128)),
              ((128, 128, 256), (128, 128, 256))))
    return dataclasses.replace(
        cfg,
        RPN=dataclasses.replace(
            cfg.RPN, NUM_POINTS=1024, SA_CONFIG=sa,
            FP_MLPS=((64, 64), (128, 128), (256, 256), (256, 256)),
            CLS_FC=(64,), REG_FC=(64,)),
        RCNN=dataclasses.replace(
            cfg.RCNN, NUM_POINTS=64,
            SA_CONFIG=RCNNSAConfig(
                NPOINTS=(32, 16, -1), RADIUS=(0.2, 0.4, 100.0),
                NSAMPLE=(8, 8, 8),
                MLPS=((64, 64, 64), (64, 64, 128), (128, 128, 256))),
            XYZ_UP_LAYER=(64, 64), CLS_FC=(128, 128), REG_FC=(128, 128)))


@contextlib.contextmanager
def training_config(cfg):
    """`python -m jmodt_torch.train --small` builds `cfg` while inside."""
    saved = train_cli.small_config
    train_cli.small_config = lambda: cfg
    try:
        yield
    finally:
        train_cli.small_config = saved


def latest_ckpt(ckpt_dir):
    """The checkpoint of the highest epoch (by number, not by time: a
    resumed run can leave older epochs beside newer files)."""
    def epoch_of(path):
        m = re.search(r'checkpoint_epoch_(\d+)', path)
        return int(m.group(1)) if m else -1
    cands = sorted(glob.glob(os.path.join(ckpt_dir, 'checkpoint_epoch_*')),
                   key=epoch_of)
    if not cands:
        raise FileNotFoundError(f'no checkpoints in {ckpt_dir}')
    return cands[-1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', type=str, default='output/ladder')
    ap.add_argument('--frames', type=int, default=24,
                    help='frames a synthetic sequence')
    ap.add_argument('--seqs', type=int, default=4,
                    help='sequences 0000.. (train / val as KITTI\'s '
                         'sequence lists split them)')
    ap.add_argument('--epochs1', type=int, default=500)
    ap.add_argument('--epochs2', type=int, default=150)
    ap.add_argument('--epochs3', type=int, default=60)
    ap.add_argument('--lr', type=float, default=1e-3)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--wide', action='store_true',
                    help='double the small config\'s widths and point '
                         'budget')
    ap.add_argument('--stage1_ckpt', type=str, default=None,
                    help='reuse this stage-1 (lidar-only) checkpoint '
                         'instead of training stage 1')
    ap.add_argument('--resume1', type=str, default=None,
                    help='checkpoint to continue stage 1 from (restores '
                         'the optimizer and epoch)')
    ap.add_argument('--stage2_ckpt', type=str, default=None,
                    help='reuse this stage-2 checkpoint instead of '
                         'training stage 2 (with --stage1_ckpt)')
    ap.add_argument('--resume2', type=str, default=None,
                    help='checkpoint to continue stage 2 from')
    ap.add_argument('--resume3', type=str, default=None,
                    help='checkpoint to continue stage 3 from')
    ap.add_argument('--eval_ckpt', type=str, default=None,
                    help='skip training and evaluate this checkpoint')
    ap.add_argument('--eval_lidar_only', action='store_true',
                    help='with --eval_ckpt: evaluate with '
                         'LI_FUSION.ENABLED False (a stage-1 checkpoint)')
    ap.add_argument('--device', type=str, default=None,
                    help='default: the CUDA card')
    ap.add_argument('--set', dest='set_kv', nargs='*', default=[],
                    help='config overrides forwarded to every training '
                         'stage, e.g. --set TRAIN.GRAD_NORM_CLIP 10')
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cfg = small_config()
    if args.wide:
        cfg = wide_config(cfg)
    root = os.path.abspath(args.out)
    data_root = os.path.join(root, 'data')
    tree = os.path.join(data_root, 'tracking')
    if not os.path.isdir(os.path.join(data_root, 'tracking_object')):
        # 128x256 with the writer's f = 2h camera: projected car heights
        # pass the official AP difficulty gates
        write_synthetic_kitti_tree(
            tree, cfg, seq_ids=tuple('%04d' % i for i in range(args.seqs)),
            n_frames=args.frames, img_hw=(128, 256), seed=args.seed)
        create_train_sample_data(
            tree, os.path.join(data_root, 'tracking_object'),
            num_seqs=args.seqs)

    device = ['--device', args.device] if args.device else []
    common = ['--data_root', data_root, '--small', '--workers', '0',
              '--log_every', '50', '--ckpt_every', '50',
              '--batch_size', str(args.batch), *device]

    def run_train(stage_argv):
        with training_config(cfg):
            train_cli.main(common + stage_argv)

    def reload(resume):
        # a continuation restores the optimizer and epoch, which the train
        # CLI does under TRAIN.RELOAD_OPTIMIZER alone
        return ['TRAIN.RELOAD_OPTIMIZER', 'True'] if resume else []

    # --finetune is store_false: passing it trains the whole detector, and
    # --set takes the rest of the line, so --ckpt comes before it.
    # TRAIN.TMAX follows each stage's epochs: the default cosine period of
    # 50 epochs anneals the rate to ~0 in a longer run.
    if args.eval_ckpt:
        ck3 = args.eval_ckpt
    else:
        if args.stage1_ckpt:
            ck1 = args.stage1_ckpt
        else:
            out1 = os.path.join(root, 'stage1')
            run_train(['--output_dir', out1, '--finetune',
                       '--epochs', str(args.epochs1)]
                      + (['--ckpt', args.resume1] if args.resume1 else [])
                      + ['--set', 'LI_FUSION.ENABLED', 'False', 'TRAIN.LR',
                         str(args.lr), 'TRAIN.TMAX', str(args.epochs1)]
                      + reload(args.resume1) + args.set_kv)
            ck1 = latest_ckpt(os.path.join(out1, 'ckpt'))
        if args.stage2_ckpt:
            ck2 = args.stage2_ckpt
        else:
            out2 = os.path.join(root, 'stage2')
            run_train(['--output_dir', out2, '--finetune',
                       '--ckpt', args.resume2 or ck1,
                       '--epochs', str(args.epochs2),
                       '--set', 'TRAIN.LR', str(args.lr / 2),
                       'TRAIN.TMAX', str(args.epochs2)]
                      + reload(args.resume2) + args.set_kv)
            ck2 = latest_ckpt(os.path.join(out2, 'ckpt'))
        out3 = os.path.join(root, 'stage3')
        run_train(['--output_dir', out3, '--ckpt', args.resume3 or ck2,
                   '--epochs', str(args.epochs3),
                   '--set', 'TRAIN.TMAX', str(args.epochs3)]
                  + reload(args.resume3) + args.set_kv)
        ck3 = latest_ckpt(os.path.join(out3, 'ckpt'))

    logger = logging.getLogger('jmodt_torch.ladder')
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler())
    if args.eval_lidar_only:
        cfg = dataclasses.replace(
            cfg, LI_FUSION=dataclasses.replace(cfg.LI_FUSION, ENABLED=False))
    eargs = eval_cli.build_parser().parse_args(
        ['--data_root', data_root, '--det_output', os.path.join(root, 'det'),
         '--output_dir', os.path.join(root, 'mot'), '--ckpt', ck3,
         '--tag', 'ladder', '--device_tracker', '--batch_seqs', '--small',
         *device])
    ap_dict = eval_cli.eval_joint_detection(eargs, cfg, logger)['ap'] or {}
    mota = eval_cli.eval_tracking(eargs, cfg, logger)['mota']

    result = {
        'ap_3d_moderate': float(ap_dict.get('Car_3d_moderate', -1.0)),
        'ap_bev_moderate': float(ap_dict.get('Car_bev_moderate', -1.0)),
        # a failed evaluation (no sequence scored) returns False, which
        # must stay apart from a MOTA of 0.0 (and bool is an int)
        'mota': (float(mota) if isinstance(mota, (int, float))
                 and not isinstance(mota, bool) else None),
        'stages': [args.epochs1, args.epochs2, args.epochs3],
    }
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
