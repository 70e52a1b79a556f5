"""Where does a detector lose ground truth?

    python -m jmodt_torch.tools.recall_diagnosis --data_root ROOT
        --det_dir DET/txt [--split val] [--iou 0.5] [--json_out FILE]
        [--device cpu]

The counterpart of `tools/recall_diagnosis.py`.  For every gt car of the
split it finds the detection of best 3D IoU and files the outcome by
camera range and projected box height:
  - pure miss          best 3D IoU < 0.1 and no BEV match;
  - poor localization  matched, but below the IoU threshold;
  - orientation flip   as poor localization, with ry off by more than
                       pi / 4 (modulo pi);
  - hit                3D IoU at or above the threshold (its score is
                       kept, beside the unmatched detections' scores).

Labels are parsed and overlaps computed by `eval/detection_ap.py`, the
code the AP comes from, so the buckets split the matches the evaluator
sees.  The rotated overlaps run on `--device` (default: the CUDA card;
raises without one).  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from jmodt_torch.device import resolve_device
from jmodt_torch.eval.detection_ap import (bev_box_overlap, d3_box_overlap,
                                           get_label_anno)

RANGE_EDGES = [0.0, 10.0, 20.0, 30.0, 1e9]
HEIGHT_EDGES = [0.0, 25.0, 40.0, 1e9]  # the difficulty gates' px bands


def _boxes7(anno):
    """(N, 7) [x, y, z, l, h, w, ry] camera-frame boxes from an anno."""
    if len(anno['name']) == 0:
        return np.zeros((0, 7), np.float64)
    return np.concatenate(
        [anno['location'], anno['dimensions'], anno['rotation_y'][:, None]],
        axis=1)


def _bucket(edges, v):
    for i in range(len(edges) - 1):
        if edges[i] <= v < edges[i + 1]:
            return i
    return len(edges) - 2


def _ry_gap(a, b):
    """|a - b| folded to [0, pi / 2]: ry is symmetric under a half turn."""
    return abs(((a - b) + np.pi / 2) % np.pi - np.pi / 2)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--data_root', required=True,
                    help='root holding tracking_object/')
    ap.add_argument('--det_dir', required=True,
                    help='detection txt dir (stage 1\'s det/txt)')
    ap.add_argument('--split', default='val')
    ap.add_argument('--iou', type=float, default=0.5)
    ap.add_argument('--json_out', default=None)
    ap.add_argument('--device', type=str, default=None,
                    help='default: the CUDA card')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    obj_root = os.path.join(args.data_root, 'tracking_object')
    with open(os.path.join(obj_root, 'ImageSets', f'{args.split}.txt')) as f:
        ids = [ln.strip() for ln in f if ln.strip()]

    n_range = len(RANGE_EDGES) - 1
    n_height = len(HEIGHT_EDGES) - 1
    stats = {
        'n_gt': 0, 'recall_hit': 0, 'pure_miss': 0, 'poor_loc': 0,
        'ry_flip': 0,
        'range': np.zeros((n_range, 2), np.int64),   # [n_gt, hits]
        'height': np.zeros((n_height, 2), np.int64),
        'best_ious': [], 'matched_scores': [], 'fp_scores': [], 'n_det': 0,
    }

    for fid in ids:
        gt = get_label_anno(os.path.join(obj_root, 'training',
                                         'label_2', f'{fid}.txt'))
        det_path = os.path.join(args.det_dir, f'{fid}.txt')
        det = (get_label_anno(det_path) if os.path.exists(det_path)
               else {'name': np.array([])})
        car_gt = gt['name'] == 'Car'
        gtb = _boxes7(gt)[car_gt]
        gt_bbox = gt['bbox'][car_gt]
        car_dt = (det['name'] == 'Car') if len(det['name']) else car_gt[:0]
        dtb = _boxes7(det)[car_dt] if len(det['name']) else np.zeros((0, 7))
        scores = (det['score'][car_dt] if len(det['name'])
                  else np.zeros((0,)))
        stats['n_det'] += len(dtb)
        if len(gtb) == 0:
            stats['fp_scores'].extend(scores.tolist())
            continue
        if len(dtb) == 0:
            iou3d = np.zeros((len(gtb), 0))
            ioubev = iou3d
        else:
            iou3d = d3_box_overlap(gtb, dtb, device=device)
            ioubev = bev_box_overlap(gtb[:, [0, 2, 3, 5, 6]],
                                     dtb[:, [0, 2, 3, 5, 6]], device=device)
        best = iou3d.max(axis=1) if iou3d.shape[1] else np.zeros(len(gtb))
        best_j = (iou3d.argmax(axis=1) if iou3d.shape[1]
                  else np.zeros(len(gtb), np.int64))
        det_matched = np.zeros(len(dtb), bool)
        for i in range(len(gtb)):
            stats['n_gt'] += 1
            stats['best_ious'].append(float(best[i]))
            rb = _bucket(RANGE_EDGES, float(gtb[i, 2]))
            hb = _bucket(HEIGHT_EDGES, float(gt_bbox[i, 3] - gt_bbox[i, 1]))
            stats['range'][rb, 0] += 1
            stats['height'][hb, 0] += 1
            if best[i] >= args.iou:
                stats['recall_hit'] += 1
                stats['range'][rb, 1] += 1
                stats['height'][hb, 1] += 1
                stats['matched_scores'].append(float(scores[best_j[i]]))
                det_matched[best_j[i]] = True
            elif best[i] < 0.1:
                # BEV-good but 3D-bad is a height / ry fault, not a miss
                bev_best = (ioubev[i].max() if ioubev.shape[1] else 0.0)
                if bev_best >= args.iou:
                    j = int(ioubev[i].argmax())
                    stats['ry_flip' if _ry_gap(gtb[i, 6], dtb[j, 6])
                          > np.pi / 4 else 'poor_loc'] += 1
                else:
                    stats['pure_miss'] += 1
            else:
                j = int(best_j[i])
                stats['ry_flip' if _ry_gap(gtb[i, 6], dtb[j, 6])
                      > np.pi / 4 else 'poor_loc'] += 1
        stats['fp_scores'].extend(scores[~det_matched].tolist())

    n = max(stats['n_gt'], 1)
    ms = np.array(stats['matched_scores'] or [0.0])
    fs = np.array(stats['fp_scores'] or [0.0])

    def banded(edges, counts):
        return {f'{int(edges[i])}-{int(min(edges[i + 1], 999))}':
                [int(counts[i, 0]),
                 round(counts[i, 1] / max(counts[i, 0], 1), 3)]
                for i in range(len(edges) - 1)}

    out = {
        'split': args.split,
        'iou': args.iou,
        'n_gt': stats['n_gt'],
        'n_det': stats['n_det'],
        'recall': stats['recall_hit'] / n,
        'pure_miss_frac': stats['pure_miss'] / n,
        'poor_loc_frac': stats['poor_loc'] / n,
        'ry_flip_frac': stats['ry_flip'] / n,
        'recall_by_range_m': banded(RANGE_EDGES, stats['range']),
        'recall_by_height_px': banded(HEIGHT_EDGES, stats['height']),
        'median_best_iou': float(np.median(stats['best_ious'] or [0.0])),
        'matched_score_median': float(np.median(ms)),
        'fp_count': len(stats['fp_scores']),
        'fp_score_median': float(np.median(fs)),
        'fp_score_p90': float(np.percentile(fs, 90)),
    }
    print(json.dumps(out, indent=1))
    if args.json_out:
        with open(args.json_out, 'w') as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == '__main__':
    main()
