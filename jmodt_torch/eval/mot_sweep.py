"""Offline MOT hyper-parameter sweep over persisted stage-1 detections.

    python -m jmodt_torch.eval.mot_sweep --det_output <dir> --data_root
        <KITTI root> --ckpt FILE [--output_dir output/mot_sweep]
        [--grid JSON] [--hungarian] [--top 10] [--device cpu]

The counterpart of `tools/mot_sweep.py`, with its flags.  The reference
fixes its tracking hyper-parameters (`eval/__main__.py::
MOT_PARAM_DEFAULTS`), tuned for a strong KITTI detector; a weaker one
wants a lower detection gate and a longer miss budget.  The sweep replays
the stage-1 files (`<det_output>/txt|feat`, written by `python -m
jmodt_torch.eval`) of the validation sequences through the host tracker
(`tracking/tracker.py::Tracker`, its affinity on the device) for every
config of a grid, scores each with CLEAR-MOT against the ground truth, and
writes the ranking to `<output_dir>/sweep_results.json`.

No model is built: only the link / se heads are read from the checkpoint,
their widths from its own tensors.  One tracker is kept per (w_app, w_iou,
w_dis), the weights its affinity is built with, and reset per sequence;
the other knobs (cls_thresh, t_miss, t_hit, w_cls, w_se, match_thresh) are
set on it per config.  The best config's flags are printed for a rerun of
`python -m jmodt_torch.eval --only_tracking`, with `--hungarian` when the
sweep ran with it, which `sweep_results.json` also records (the JAX tool
drops it from both, so its rerun solves with MIP).  Runs on the CUDA card
unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os

import numpy as np

from jmodt_torch.config import VALID_SEQ_ID
from jmodt_torch.device import resolve_device
from jmodt_torch.eval.__main__ import (MOT_PARAM_DEFAULTS, _load_det_frame,
                                       _seqmap_from_gt, load_tracking_heads)
from jmodt_torch.utils.kitti_io import save_kitti_tracking_format

DEFAULT_GRID = {
    # the detection gate is the dominant knob for a weak detector; the
    # rest refine around the reference defaults
    'cls_thresh': [0.3, 0.5, 0.7, 0.85],
    't_miss': [2, 4],
    't_hit': [0, 1],
}


def load_frames(det_output, data_root, logger):
    """(sequence ids, {seq: [(frame id, objs, boxes, scores, feats)]}): every
    validation frame's detections and features read once, so the sweep's
    loop parses no file.  Frames with no rows are left out, as stage 2
    skips them."""
    from jmodt_torch.data.converter import read_sample2frame, read_seq2sample
    base = os.path.join(data_root, 'tracking_object', 'training')
    seq2sample = read_seq2sample(os.path.join(base, 'seq2sample.txt'))
    sample2frame = read_sample2frame(os.path.join(base, 'sample2frame.txt'))
    seq_list = [s for s in VALID_SEQ_ID if s in seq2sample]
    frames = {}
    n_dets = 0
    for seq_id in seq_list:
        rows = []
        for sample_id in seq2sample[seq_id]:
            if not os.path.isfile(os.path.join(det_output, 'txt',
                                               f'{sample_id}.txt')):
                continue
            det = _load_det_frame(det_output, sample_id, -np.inf)
            if det is None:
                continue
            boxes, scores, feats, objs = det
            rows.append((int(sample2frame[sample_id][1]), objs, boxes,
                         scores, feats))
            n_dets += len(objs)
        frames[seq_id] = rows
    logger.info('loaded %d sequences, %d frames, %d detections',
                len(frames), sum(len(v) for v in frames.values()), n_dets)
    return seq_list, frames


def run_config(tracker, params, seq_list, frames, res_root, tag,
               part='val'):
    """Replay every sequence through `tracker` at `params`; write the
    KITTI tracking txts under <res_root>/<tag>/<part>/ (CLEAR-MOT's
    layout)."""
    res_dir = os.path.join(res_root, tag, part)
    os.makedirs(res_dir, exist_ok=True)
    tracker.t_miss = params['t_miss']
    tracker.t_hit = params['t_hit']
    tracker.w_cls = params['w_cls']
    tracker.w_se = params['w_se']
    tracker.match_thresh = params['match_thresh']
    cls_thresh = params['cls_thresh']
    for seq_id in seq_list:
        tracker.reset()
        with open(os.path.join(res_dir, f'{seq_id}.txt'), 'w') as out_file:
            for frame_id, objs, boxes, scores, feats in frames[seq_id]:
                mask = scores > cls_thresh
                results = tracker.update(frame_id, boxes[mask], scores[mask],
                                         feats[mask], objs[mask])
                save_kitti_tracking_format(results, frame_id, out_file)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--det_output', type=str, required=True,
                    help='stage-1 output directory holding txt/ and feat/')
    ap.add_argument('--data_root', type=str, required=True,
                    help='KITTI root (tracking/ gt + tracking_object/)')
    ap.add_argument('--ckpt', type=str, required=True,
                    help='checkpoint holding the link / se heads')
    ap.add_argument('--output_dir', type=str, default='output/mot_sweep')
    ap.add_argument('--grid', type=str, default=None,
                    help='JSON dict param -> list overriding the default '
                         'grid; params: cls_thresh, t_miss, t_hit, w_cls, '
                         'w_app, w_iou, w_dis, w_se, match_thresh')
    ap.add_argument('--hungarian', action='store_true')
    ap.add_argument('--top', type=int, default=10)
    ap.add_argument('--device', type=str, default=None,
                    help='default: the CUDA card')
    return ap


def main(argv=None) -> dict:
    """Runs the sweep; returns what it writes to sweep_results.json."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    from jmodt_torch.eval.clear_mot import evaluate
    from jmodt_torch.tracking.tracker import Tracker

    logger = logging.getLogger('jmodt_torch.eval.mot_sweep')
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter('%(message)s'))
        logger.addHandler(handler)
    mot_logger = logging.getLogger('jmodt_torch.eval.mot_sweep.clearmot')
    mot_logger.setLevel(logging.WARNING)   # CLEAR-MOT logs every run

    link_head, se_head = load_tracking_heads(None, args.ckpt, logger, device)
    seq_list, frames = load_frames(args.det_output, args.data_root, logger)

    grid = dict(DEFAULT_GRID)
    if args.grid:
        grid.update(json.loads(args.grid))
    base = dict(MOT_PARAM_DEFAULTS)
    keys = sorted(grid)
    combos = [dict(zip(keys, vals))
              for vals in itertools.product(*(grid[k] for k in keys))]
    logger.info('sweeping %d configs over %s', len(combos), keys)

    gt_path = os.path.join(args.data_root, 'tracking', 'training')
    seqmap = _seqmap_from_gt(gt_path)
    os.makedirs(args.output_dir, exist_ok=True)

    trackers = {}            # (w_app, w_iou, w_dis) -> Tracker
    results = []
    for i, combo in enumerate(combos):
        params = dict(base, **combo)
        key = (params['w_app'], params['w_iou'], params['w_dis'])
        if key not in trackers:
            trackers[key] = Tracker(link_head, se_head, w_app=key[0],
                                    w_iou=key[1], w_dis=key[2],
                                    hungarian=args.hungarian, device=device)
        tag = f'cfg{i:03d}'
        run_config(trackers[key], params, seq_list, frames, args.output_dir,
                   tag)
        mota = evaluate(result_sha=tag, result_root=args.output_dir,
                        part='val', gt_path=gt_path, logger=mot_logger,
                        seqmap=seqmap)
        mota = (float(mota) if isinstance(mota, (int, float))
                and not isinstance(mota, bool) else None)
        results.append({'tag': tag, 'mota': mota, **combo})
        logger.info('[%d/%d] %s -> MOTA %s', i + 1, len(combos), combo,
                    f'{mota:.4f}' if mota is not None else 'failed')

    ranked = sorted([r for r in results if r['mota'] is not None],
                    key=lambda r: -r['mota'])
    summary = {'grid': grid, 'base': base, 'hungarian': args.hungarian,
               'results': results, 'best': ranked[0] if ranked else None}
    with open(os.path.join(args.output_dir, 'sweep_results.json'), 'w') as f:
        json.dump(summary, f, indent=1)
        f.write('\n')

    logger.info('\ntop %d:', min(args.top, len(ranked)))
    for r in ranked[:args.top]:
        logger.info('  MOTA %.4f  %s', r['mota'],
                    {k: v for k, v in r.items() if k not in ('tag', 'mota')})
    if ranked:
        best = ranked[0]
        flags = ' '.join(f'--{k} {v}' for k, v in best.items()
                         if k not in ('tag', 'mota'))
        if args.hungarian:      # the assignment the ranking was made with
            flags += ' --hungarian'
        logger.info('\nbest: MOTA %.4f; rerun with: python -m '
                    'jmodt_torch.eval --only_tracking %s', best['mota'],
                    flags)
    return summary


if __name__ == '__main__':
    main()
