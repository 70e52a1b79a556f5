"""Two-stage evaluation: joint detection inference, then tracking.

    python -m jmodt_torch.eval [--data_root <KITTI root>] [--ckpt FILE]
        [--det_output output/det] [--output_dir output] [--tag mot_data]
        [--hungarian] [--device_tracker] [--batch_seqs] [--only_tracking]
        [--test] [--small] [--synthetic_frames 8] [--device cpu]

The counterpart of `tools/eval.py`, with its flags:

  * stage 1 (reference tools/eval.py:40-242): the detection step
    (`models/inference.py::make_detection_step`) frame by frame, one host
    read of its `packed` rows a frame, the KITTI txt and 512-d feature
    files, the empty-file backfill, bbox recall counted on the device
    (`make_recall_fn`) and, with `--data_root`, the official detection AP;
  * stage 2 (reference tools/eval.py:294-417): each sequence tracked over
    the stage-1 files by the host tracker (MIP, or `--hungarian`), the
    device tracker (`--device_tracker`) or all sequences in lockstep
    (`--batch_seqs`), the KITTI tracking txt and, with `--data_root`,
    CLEAR-MOT.

`--data_root` is a KITTI root holding `tracking/` and the converter's
`tracking_object/` (`python -m jmodt_torch.data.converter`).  Without it
stage 1 runs on synthetic frames and stage 2 tracks them as one sequence.
`--ckpt` is a port checkpoint or a reference PointRCNN `.pth`; without it
the weights are random.  Everything runs on the CUDA card unless given
`--device cpu`, and raises when no card is present.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import time
from datetime import datetime

import numpy as np
import torch

from jmodt_torch.config import TEST_SEQ_ID, VALID_SEQ_ID, Config, small_config
from jmodt_torch.device import resolve_device
from jmodt_torch.models.inference import (RECALL_THRESH, make_detection_step,
                                          make_recall_fn)
from jmodt_torch.models.point_rcnn import build_detector
from jmodt_torch.models.rcnn import CorrelationHead
from jmodt_torch.utils.kitti_io import (save_kitti_detection_format,
                                        save_kitti_tracking_format)
from jmodt_torch.utils.object3d import Object3d

MAX_GT = 32
MOT_PARAM_DEFAULTS = {
    # reference tools/eval.py:300-319
    't_miss': 2, 't_hit': 0, 'w_cls': 100.0, 'w_app': 2.0, 'w_iou': 10.0,
    'w_dis': 10.0, 'w_se': 1.0, 'cls_thresh': 0.85, 'match_thresh': 0.0,
}
# the synthetic frames' calibration (a KITTI-like P2)
_SYNTHETIC_P2 = np.array([[720.0, 0, 620, 0], [0, 720.0, 190, 0],
                          [0, 0, 1, 0]], np.float32)


def build_model_and_ckpt(cfg, mode, ckpt, logger, device):
    """The detector on `device`, random from seed 0 and then, with a
    checkpoint, every matching tensor of it restored."""
    from jmodt_torch.train.checkpoint import load_checkpoint
    model = build_detector(cfg, mode=mode, device=device, seed=0)
    if ckpt:
        load_checkpoint(ckpt, model, strict=False, log=logger)
    else:
        logger.info('WARNING: no --ckpt given, using random weights')
    return model.eval()


def detection_frames(args, cfg, logger):
    """(sample ids, frame iterator, dataset or None): the iterator yields
    (sample id, collated batch of 1, Calibration, image shape)."""
    mode = 'TEST' if args.test else 'EVAL'
    if args.data_root:
        from jmodt_torch.data.kitti_dataset import KittiDataset
        dataset = KittiDataset(
            root_dir=args.data_root, npoints=cfg.RPN.NUM_POINTS,
            split=cfg.TEST.SPLIT if args.test else cfg.EVAL.SPLIT,
            mode=mode, classes=cfg.CLASSES, challenge='tracking',
            logger=logger, cfg=cfg,
            # --small must match the training side's image geometry, or
            # the pts_xy normalization shifts
            fixed_img_size=(64, 128) if args.small else (384, 1280),
            raw_uint8_images=True)
        sample_ids = list(dataset.sample_id_list)

        def frames():
            for sid in sample_ids:
                yield (sid, dataset.collate_batch(
                    [dataset.get_sample_dict(sid)]),
                    dataset.get_calib(sid), dataset.get_image_shape(sid))
        return sample_ids, frames, dataset

    from jmodt_torch.data.synthetic import make_eval_frame
    from jmodt_torch.utils.calibration import Calibration
    logger.info('no --data_root: synthetic frames x%d', args.synthetic_frames)
    sample_ids = list(range(args.synthetic_frames))
    calib = Calibration({'P2': _SYNTHETIC_P2, 'R0': np.eye(3, dtype=np.float32),
                         'Tr_velo2cam': np.eye(3, 4, dtype=np.float32)})

    def frames():
        for sid in sample_ids:
            yield sid, make_eval_frame(seed=sid, cfg=cfg), calib, \
                (384, 1280, 3)
    return sample_ids, frames, None


def write_detections(sid, packed, calib, img_shape, txt_dir, feat_dir,
                     cls_name) -> int:
    """One frame's KITTI txt and feature npy from its `packed` rows
    [box(7) | score | keep | feat]; returns the rows written."""
    keep = packed[:, 8] > 0.5
    boxes, scores, feats = packed[keep, 0:7], packed[keep, 7], \
        packed[keep, 9:]
    if len(boxes):
        return save_kitti_detection_format(
            int(sid), calib, boxes, txt_dir, scores, img_shape, feats,
            feat_dir, cls_name=cls_name)
    open(os.path.join(txt_dir, '%06d.txt' % int(sid)), 'w').close()
    np.save(os.path.join(feat_dir, '%06d.npy' % int(sid)),
            np.zeros((0, feats.shape[-1]), np.float32))
    return 0


def eval_joint_detection(args, cfg, logger):
    """Stage 1.  Returns {'ap': the AP dict or None, 'recall': the (11,)
    counters [recalled(5), roi_recalled(5), n_gt], 'frames', 'ms_per_frame'
    (step call to host read of `packed`), 'ap_seconds'}."""
    logger.info('********** Start evaluate detection **********')
    device = resolve_device(args.device)
    num_list = re.findall(r'\d+', args.ckpt) if args.ckpt else []
    epoch_id = num_list[-1] if num_list else 'no_number'
    mode = 'TEST' if args.test else 'EVAL'
    txt_dir = os.path.join(args.det_output, 'txt')
    feat_dir = os.path.join(args.det_output, 'feat')
    os.makedirs(txt_dir, exist_ok=True)
    os.makedirs(feat_dir, exist_ok=True)

    sample_ids, frames, dataset = detection_frames(args, cfg, logger)
    model = build_model_and_ckpt(cfg, mode, args.ckpt, logger, device)
    step = make_detection_step(cfg, model, device=device)
    accumulate_recall = make_recall_fn(device=device)
    if device.type == 'cuda':
        # build the kernels now, so the frames' clock does not hold nvcc
        from jmodt_torch.ops import kernels
        logger.info('kernels built in %.1f s', kernels.build())

    # the recall counters stay on the device across frames; a frame reads
    # the host once, its packed rows
    recall_acc = torch.zeros(11, dtype=torch.int32, device=device)
    final_total = 0
    t_infer = 0.0
    n_frames = 0
    for sid, data, calib, img_shape in frames():
        t0 = time.perf_counter()
        out = step(data['pts_input'], data['img'], data['pts_xy'])
        if not args.test and 'gt_boxes3d' in data:
            gt = np.zeros((MAX_GT, 7), np.float32)
            g = np.asarray(data['gt_boxes3d'][0])[:MAX_GT]
            gt[:len(g)] = g
            recall_acc = accumulate_recall(recall_acc, out, gt)
        packed = out['packed'][0].cpu().numpy()        # the host read
        t_infer += time.perf_counter() - t0
        n_frames += 1
        final_total += write_detections(sid, packed, calib, img_shape,
                                        txt_dir, feat_dir, cfg.CLASSES)

    # empty-file backfill (reference tools/eval.py:203-212)
    empty_cnt = 0
    for sid in sample_ids:
        cur = os.path.join(txt_dir, '%06d.txt' % int(sid))
        if not os.path.exists(cur):
            open(cur, 'w').close()
            empty_cnt += 1
    if empty_cnt:
        logger.info('dumped %d empty files', empty_cnt)

    recall_acc = recall_acc.cpu().numpy()
    total_recalled, total_roi_recalled = recall_acc[:5], recall_acc[5:10]
    total_gt = int(recall_acc[10])
    ms = 1e3 * t_infer / max(n_frames, 1)
    logger.info('---------- performance of epoch %s ----------', epoch_id)
    logger.info('inference: %.1f ms/frame over %d frames', ms, n_frames)
    logger.info('final average detections: %.3f',
                final_total / max(len(sample_ids), 1))
    for idx, thresh in enumerate(RECALL_THRESH):
        logger.info('total roi bbox recall(thresh=%.3f): %d / %d = %f',
                    thresh, total_roi_recalled[idx], total_gt,
                    total_roi_recalled[idx] / max(total_gt, 1))
    for idx, thresh in enumerate(RECALL_THRESH):
        logger.info('total bbox recall(thresh=%.3f): %d / %d = %f',
                    thresh, total_recalled[idx], total_gt,
                    total_recalled[idx] / max(total_gt, 1))

    ap_dict, ap_seconds = None, None
    if not args.test and args.data_root:
        from jmodt_torch.eval.detection_ap import evaluate_detections
        name_to_class = {'Car': 0, 'Pedestrian': 1, 'Cyclist': 2}
        t0 = time.perf_counter()
        ap_str, ap_dict = evaluate_detections(
            dataset.label_dir, txt_dir, image_idx_list=sample_ids,
            current_class=name_to_class[cfg.CLASSES], device=device)
        ap_seconds = time.perf_counter() - t0
        logger.info(ap_str)
        logger.info('%s', ap_dict)
    logger.info('result saved to: %s', args.det_output)
    return {'ap': ap_dict, 'recall': recall_acc, 'frames': n_frames,
            'ms_per_frame': ms, 'ap_seconds': ap_seconds}


def _load_det_frame(det_output, sample_id, cls_thresh):
    """One stage-1 frame above `cls_thresh`: (boxes, scores, feats, objs),
    or None for a frame with no rows."""
    with open(os.path.join(det_output, 'txt', f'{sample_id}.txt')) as f:
        lines = f.readlines()
    if not lines:
        return None
    objs = np.array([Object3d(line) for line in lines])
    feats = np.load(os.path.join(det_output, 'feat', f'{sample_id}.npy'))
    if len(feats) != len(objs):
        raise ValueError(f'{sample_id}: {len(objs)} rows but {len(feats)} '
                         'features')
    boxes = np.stack([o.box3d for o in objs])
    scores = np.array([o.score for o in objs], np.float32)
    mask = scores > cls_thresh
    return boxes[mask], scores[mask], feats[mask], objs[mask]


def _emitted(out, objs):
    """(tid, Object3d, score) rows of a device tracker's output."""
    return [(int(out['tid'][i]), objs[int(out['det_idx'][i])],
             float(out['score'][i]))
            for i in np.flatnonzero(out['emit'])
            if 0 <= int(out['det_idx'][i]) < len(objs)]


def _track_sequences_batched(args, logger, seq_list, seq2sample,
                             sample2frame, link_head, se_head, feat_dim,
                             tracking_res_dir, p, device):
    """Every sequence in lockstep through
    `tracking/device_tracker.py::make_batched_tracker_step`; shorter
    sequences pad with empty frames.  Outputs are read to the host after
    the timed loop, one read a key, and written to the same per-sequence
    txt files as the serial path.  Returns (seconds, frames)."""
    from jmodt_torch.tracking.device_tracker import (init_batched_state,
                                                     make_batched_tracker_step)
    max_dets = args.max_dets
    seq_frames = []
    dropped = 0
    for seq_id in seq_list:
        frames = []
        for sample_id in seq2sample.get(seq_id, []):
            det = _load_det_frame(args.det_output, sample_id, p['cls_thresh'])
            if det is None:
                continue
            dropped += max(len(det[1]) - max_dets, 0)
            frames.append((int(sample2frame[sample_id][1]),) + det)
        seq_frames.append(frames)
    if dropped:
        logger.warning('--batch_seqs: %d detections above cls_thresh '
                       'dropped by the max_dets=%d cap (raise --max_dets, '
                       'keeping it <= --max_tracks)', dropped, max_dets)
    n_seq = len(seq_list)
    max_len = max((len(f) for f in seq_frames), default=0)
    if n_seq == 0 or max_len == 0:
        return 0.0, 0

    common = dict(t_miss=p['t_miss'], t_hit=p['t_hit'], w_app=p['w_app'],
                  w_iou=p['w_iou'], w_dis=p['w_dis'], device=device)
    if args.hungarian:
        step = make_batched_tracker_step(
            link_head, score_thresh=p['cls_thresh'],
            match_thresh=p['match_thresh'], assign='hungarian', **common)
    else:
        step = make_batched_tracker_step(
            link_head, assign='mip', se_head=se_head, w_cls=p['w_cls'],
            w_se=p['w_se'], **common)
    states = init_batched_state(n_seq, args.max_tracks, feat_dim, device)

    total_frames = sum(len(f) for f in seq_frames)
    outs = []
    t0 = time.perf_counter()
    for t in range(max_len):
        db = np.zeros((n_seq, max_dets, 7), np.float32)
        ds = np.zeros((n_seq, max_dets), np.float32)
        df = np.zeros((n_seq, max_dets, feat_dim), np.float32)
        dm = np.zeros((n_seq, max_dets), bool)
        fid = np.zeros((n_seq,), np.int32)
        for s, frames in enumerate(seq_frames):
            if t < len(frames):
                frame_id, boxes, scores, feats, _ = frames[t]
                n = min(len(scores), max_dets)
                db[s, :n], ds[s, :n] = boxes[:n], scores[:n]
                df[s, :n], dm[s, :n] = feats[:n], True
                fid[s] = frame_id
        states, out = step(states, fid, db, ds, df, dm)
        outs.append(out)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    total_time = time.perf_counter() - t0

    stacked = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
               for k in outs[0]}                          # (L, S, ...) each
    for s, seq_id in enumerate(seq_list):
        with open(os.path.join(tracking_res_dir, f'{seq_id}.txt'),
                  'w') as out_file:
            for t, (frame_id, *_, objs) in enumerate(seq_frames[s]):
                out = {k: v[t, s] for k, v in stacked.items()}
                save_kitti_tracking_format(_emitted(out, objs), frame_id,
                                           out_file)
    return total_time, total_frames


def _seqmap_from_gt(gt_path: str) -> dict:
    """Frame counts a sequence from the image_02 directories (frames exist
    even when unlabeled): the official SEQMAP on the real KITTI tree.
    Falls back to the last labelled frame + 1 where images are absent."""
    seqmap = {}
    img_root = os.path.join(gt_path, 'image_02')
    label_dir = os.path.join(gt_path, 'label_02')
    for name in sorted(os.listdir(label_dir)):
        if not name.endswith('.txt'):
            continue
        seq = name[:-4]
        img_dir = os.path.join(img_root, seq)
        if os.path.isdir(img_dir):
            seqmap[seq] = sum(1 for p in os.listdir(img_dir)
                              if p.endswith(('.png', '.jpg')))
            continue
        last = 0
        with open(os.path.join(label_dir, name)) as f:
            for line in f:
                if line.strip():
                    last = max(last, int(float(line.split()[0])))
        seqmap[seq] = last + 1
    return seqmap


def load_tracking_heads(cfg, ckpt, logger, device, test=False):
    """(link head, se head) on `device`.  With a checkpoint their
    architecture comes from its own tensors, so stage 2 does not depend
    on the config that trained them; without one they are the random
    heads of a detector from seed 0, as stage 1's."""
    if ckpt:
        from jmodt_torch.train.checkpoint import (infer_head_arch,
                                                  read_head_state)
        heads = []
        for state in read_head_state(ckpt):
            cin, hidden, use_bn = infer_head_arch(state)
            head = CorrelationHead(cin, hidden, use_bn=use_bn)
            head.load_state_dict(state, strict=True)
            heads.append(head.to(device).eval())
        return heads[0], heads[1]
    logger.info('WARNING: no --ckpt given, using random head weights')
    model = build_detector(cfg, mode='TEST' if test else 'EVAL',
                           device=device, seed=0)
    return model.rcnn.link_layer.eval(), model.rcnn.se_layer.eval()


def _persisted_feat_dim(det_output):
    """ReID feature width of the persisted stage-1 features, so the
    tracker state is sized from the data, not from the config."""
    feat_dir = os.path.join(det_output, 'feat')
    if os.path.isdir(feat_dir):
        for name in sorted(os.listdir(feat_dir)):
            if name.endswith('.npy'):
                arr = np.load(os.path.join(feat_dir, name), mmap_mode='r')
                if arr.ndim == 2 and arr.shape[0] > 0:
                    return int(arr.shape[1])
    return None


def mot_params_from_args(args):
    """MOT hyper-parameters, the reference defaults for absent ones."""
    return {k: getattr(args, k, None) if getattr(args, k, None) is not None
            else d for k, d in MOT_PARAM_DEFAULTS.items()}


def eval_tracking(args, cfg, logger):
    """Stage 2 (reference eval_tracking, tools/eval.py:294-417).  Returns
    {'mota': the car MOTA or None, 'frames', 'seconds' (tracker updates
    alone), 'result_dir'}."""
    device = resolve_device(args.device)
    part = 'test' if args.test else 'val'
    tracking_res_dir = os.path.join(args.output_dir, args.tag, part)
    os.makedirs(tracking_res_dir, exist_ok=True)
    p = mot_params_from_args(args)
    logger.info('********** Start evaluate tracking **********')
    logger.info('t_miss=%d t_hit=%d w_cls=%d w_app=%d w_iou=%d w_dis=%d '
                'w_se=%d', p['t_miss'], p['t_hit'], p['w_cls'], p['w_app'],
                p['w_iou'], p['w_dis'], p['w_se'])
    link_head, se_head = load_tracking_heads(cfg, args.ckpt, logger, device,
                                             test=args.test)
    feat_dim = (_persisted_feat_dim(args.det_output)
                or cfg.RCNN.SA_CONFIG.MLPS[-1][-1])
    common = dict(t_miss=p['t_miss'], t_hit=p['t_hit'], w_app=p['w_app'],
                  w_iou=p['w_iou'], w_dis=p['w_dis'])

    if args.data_root:
        from jmodt_torch.data.converter import (read_sample2frame,
                                                read_seq2sample)
        base = os.path.join(args.data_root, 'tracking_object',
                            'testing' if args.test else 'training')
        seq2sample = read_seq2sample(os.path.join(base, 'seq2sample.txt'))
        sample2frame = read_sample2frame(
            os.path.join(base, 'sample2frame.txt'))
        seq_list = (list(TEST_SEQ_ID) if args.test else
                    [s for s in VALID_SEQ_ID if s in seq2sample])
    else:
        # one sequence over the synthetic stage-1 outputs
        ids = sorted(n[:-4] for n in os.listdir(
            os.path.join(args.det_output, 'txt')) if n.endswith('.txt'))
        seq2sample = {'0000': ids}
        sample2frame = {s: ('0000', '%06d' % i) for i, s in enumerate(ids)}
        seq_list = ['0000']

    if args.batch_seqs:
        total_time, total_frames = _track_sequences_batched(
            args, logger, seq_list, seq2sample, sample2frame, link_head,
            se_head, feat_dim, tracking_res_dir, p, device)
    else:
        if args.device_tracker:
            from jmodt_torch.tracking.device_tracker import DeviceTracker
            if args.hungarian:
                tracker = DeviceTracker(
                    link_head, feat_dim, max_tracks=args.max_tracks,
                    max_dets=args.max_dets, device=device,
                    score_thresh=p['cls_thresh'],
                    match_thresh=p['match_thresh'], assign='hungarian',
                    **common)
            else:
                tracker = DeviceTracker(
                    link_head, feat_dim, max_tracks=args.max_tracks,
                    max_dets=args.max_dets, device=device, assign='mip',
                    se_head=se_head, w_cls=p['w_cls'], w_se=p['w_se'],
                    **common)
        else:
            from jmodt_torch.tracking.tracker import Tracker
            tracker = Tracker(link_head, se_head, w_cls=p['w_cls'],
                              w_se=p['w_se'], hungarian=args.hungarian,
                              score_thresh=0.0,
                              match_thresh=p['match_thresh'], device=device,
                              **common)
        total_time, total_frames = 0.0, 0
        for seq_id in seq_list:
            tracker.reset()
            out_path = os.path.join(tracking_res_dir, f'{seq_id}.txt')
            with open(out_path, 'w') as out_file:
                for sample_id in seq2sample.get(seq_id, []):
                    det = _load_det_frame(args.det_output, sample_id,
                                          p['cls_thresh'])
                    if det is None:
                        continue
                    boxes, scores, feats, objs = det
                    frame_id = int(sample2frame[sample_id][1])
                    t0 = time.perf_counter()
                    if args.device_tracker:
                        out = tracker.update(frame_id, boxes, scores, feats)
                        out = {k: v.cpu().numpy() for k, v in out.items()}
                        results = _emitted(out, objs)
                    else:
                        results = tracker.update(frame_id, boxes, scores,
                                                 feats, objs)
                    total_time += time.perf_counter() - t0
                    total_frames += 1
                    save_kitti_tracking_format(results, frame_id, out_file)
    fps = total_frames / total_time if total_time > 0 else float('nan')
    logger.info('total frames: %d, total time: %.3f, frames per second: '
                '%.1f', total_frames, total_time, fps)

    mota = None
    if not args.test and args.data_root:
        from jmodt_torch.eval.clear_mot import evaluate
        gt_path = os.path.join(args.data_root, 'tracking', 'training')
        mota = evaluate(result_sha=args.tag, result_root=args.output_dir,
                        part=part, gt_path=gt_path, logger=logger,
                        seqmap=_seqmap_from_gt(gt_path))
    return {'mota': mota, 'frames': total_frames, 'seconds': total_time,
            'result_dir': tracking_res_dir}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--data_root', type=str, default=None)
    parser.add_argument('--det_output', type=str, default='output/det')
    parser.add_argument('--output_dir', type=str, default='output')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--tag', type=str, default='mot_data')
    parser.add_argument('--hungarian', action='store_true')
    parser.add_argument('--device_tracker', action='store_true',
                        help='track with the state on the device (exact '
                             'Jonker-Volgenant assignment) instead of the '
                             'host MIP / Hungarian tracker')
    parser.add_argument('--batch_seqs', action='store_true',
                        help='track all sequences in lockstep with the '
                             'device tracker')
    parser.add_argument('--max_dets', type=int, default=32,
                        help='device-tracker detections a frame (extras '
                             'above cls_thresh are dropped, with a warning)')
    parser.add_argument('--max_tracks', type=int, default=64,
                        help='device-tracker track slots')
    for k, d in MOT_PARAM_DEFAULTS.items():
        parser.add_argument(f'--{k}', type=type(d), default=None,
                            help=f'MOT hyper-parameter (reference default '
                                 f'{d})')
    parser.add_argument('--only_tracking', action='store_true')
    parser.add_argument('--test', action='store_true')
    parser.add_argument('--synthetic_frames', type=int, default=8)
    parser.add_argument('--small', action='store_true',
                        help='the miniature config, for smoke runs')
    parser.add_argument('--device', type=str, default=None,
                        help='default: the CUDA card')
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.max_dets > args.max_tracks:
        # the exact device assignment needs a track slot a detection
        parser.error(f'--max_dets ({args.max_dets}) must be <= '
                     f'--max_tracks ({args.max_tracks})')
    resolve_device(args.device)
    np.random.seed(2333)  # reference tools/eval.py:36

    logger = logging.getLogger('jmodt_torch.eval')
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        ch = logging.StreamHandler()
        ch.setFormatter(logging.Formatter('%(message)s'))
        logger.addHandler(ch)
    cfg = small_config() if args.small else Config()

    stamp = datetime.now().strftime('%Y-%m-%d-%H-%M-%S')
    if not args.only_tracking:
        os.makedirs(args.det_output, exist_ok=True)
        fh = logging.FileHandler(os.path.join(args.det_output,
                                              f'{stamp}.log'))
        logger.addHandler(fh)
        eval_joint_detection(args, cfg, logger)
        logger.removeHandler(fh)
        fh.close()
    os.makedirs(os.path.join(args.output_dir, args.tag), exist_ok=True)
    fh = logging.FileHandler(os.path.join(args.output_dir, args.tag,
                                          f'{stamp}.log'))
    logger.addHandler(fh)
    eval_tracking(args, cfg, logger)
    logger.removeHandler(fh)
    fh.close()


if __name__ == '__main__':
    main()
