"""The AP ceiling of a split: its own ground truth as detections.

    python -m jmodt_torch.tools.oracle_ap --data_root ROOT [--split val]
        [--classes Car] [--out DIR] [--jitter 0.1] [--device cpu]

The counterpart of `tools/oracle_ap.py`.  Each gt line of the class is
written back as a detection of score 1.0 and scored by the official
evaluator (`eval/detection_ap.py`), so the result is the most that the
difficulty gates (MIN_HEIGHT 40/25/25 px, MAX_OCCLUSION, MAX_TRUNCATION)
let a detector reach on this split: near 100 when the gates pass, and
otherwise the scale that a trained detector's AP must be read against.
Also prints the valid-gt counts a difficulty (the AP denominators) and,
with `--jitter`, the AP of the gt moved by N(0, sigma) on its centre and
size, to show how fast AP falls off the perfect match.

`--data_root` is a root holding the converter's `tracking_object/`.  The
rotated overlaps run on `--device` (default: the CUDA card; raises without
one).  Prints the evaluator's tables and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from jmodt_torch.device import resolve_device
from jmodt_torch.eval.detection_ap import evaluate_detections, get_label_anno

NAME_TO_CLASS = {'Car': 0, 'Pedestrian': 1, 'Cyclist': 2}
# the official difficulty gates (eval/detection_ap.py::clean_data)
MIN_HEIGHT = (40, 25, 25)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)


def read_split_ids(data_root, split):
    split_file = os.path.join(data_root, 'tracking_object', 'ImageSets',
                              split + '.txt')
    with open(split_file) as f:
        return [int(line.split()[0]) for line in f if line.strip()]


def write_oracle_dets(label_dir, out_dir, ids, cls_name, rng=None,
                      jitter=0.0):
    """Copy each gt line of `cls_name` as a detection with score 1.0.
    With jitter > 0, move the 3D centre (x, z) by N(0, jitter) and the
    size (h, w, l) by N(0, jitter / 2) a field; the 2D box stays exact so
    the loss is the 3D / BEV IoU's alone.  Returns the lines written."""
    os.makedirs(out_dir, exist_ok=True)
    n_lines = 0
    for sid in ids:
        src = os.path.join(label_dir, '%06d.txt' % sid)
        out = []
        if os.path.exists(src):
            with open(src) as f:
                for line in f:
                    p = line.split()
                    if not p or p[0] != cls_name:
                        continue
                    if jitter > 0.0:
                        # fields: 8-10 = h, w, l; 11-13 = x, y, z
                        for i in (8, 9, 10):
                            p[i] = '%.4f' % (float(p[i])
                                             + rng.normal(0, jitter / 2))
                        for i in (11, 13):
                            p[i] = '%.4f' % (float(p[i])
                                             + rng.normal(0, jitter))
                    out.append(' '.join(p) + ' 1.0')
                    n_lines += 1
        with open(os.path.join(out_dir, '%06d.txt' % sid), 'w') as f:
            f.write('\n'.join(out) + ('\n' if out else ''))
    return n_lines


def count_valid_gts(label_dir, ids, current_class):
    """(all gts of the class, valid gts a difficulty under the official
    gates): the AP denominators."""
    cls_name = [k for k, v in NAME_TO_CLASS.items()
                if v == current_class][0].lower()
    counts = [0, 0, 0]
    total = 0
    for sid in ids:
        anno = get_label_anno(os.path.join(label_dir, '%06d.txt' % sid))
        for i, name in enumerate(anno['name']):
            if name.lower() != cls_name:
                continue
            total += 1
            height = anno['bbox'][i, 3] - anno['bbox'][i, 1]
            for d in range(3):
                if (anno['occluded'][i] <= MAX_OCCLUSION[d]
                        and anno['truncated'][i] <= MAX_TRUNCATION[d]
                        and height > MIN_HEIGHT[d]):
                    counts[d] += 1
    return total, counts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--data_root', required=True)
    ap.add_argument('--split', default='val')
    ap.add_argument('--classes', default='Car')
    ap.add_argument('--out', default=None,
                    help='oracle det dir (default <data_root>/../oracle)')
    ap.add_argument('--jitter', type=float, default=0.0,
                    help='also run a noise-degraded oracle at this sigma')
    ap.add_argument('--device', type=str, default=None,
                    help='default: the CUDA card')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    data_root = os.path.abspath(args.data_root)
    label_dir = os.path.join(data_root, 'tracking_object', 'training',
                             'label_2')
    ids = read_split_ids(data_root, args.split)
    out_root = args.out or os.path.join(os.path.dirname(data_root),
                                        'oracle')
    cur = NAME_TO_CLASS[args.classes]

    total, valid = count_valid_gts(label_dir, ids, cur)
    result = {'split': args.split, 'frames': len(ids),
              'gt_total': total,
              'gt_valid_easy_mod_hard': valid}

    txt = os.path.join(out_root, 'txt')
    n = write_oracle_dets(label_dir, txt, ids, args.classes)
    ap_str, ap_dict = evaluate_detections(label_dir, txt,
                                          image_idx_list=ids,
                                          current_class=cur, device=device)
    print(ap_str)
    result['oracle_dets'] = n
    result['ceiling'] = {k: round(float(v), 4) for k, v in ap_dict.items()}

    if args.jitter > 0.0:
        rng = np.random.RandomState(0)
        txt_j = os.path.join(out_root, 'txt_jitter')
        write_oracle_dets(label_dir, txt_j, ids, args.classes, rng=rng,
                          jitter=args.jitter)
        ap_str_j, ap_dict_j = evaluate_detections(
            label_dir, txt_j, image_idx_list=ids, current_class=cur,
            device=device)
        print(ap_str_j)
        result['jitter_sigma'] = args.jitter
        result['jittered'] = {k: round(float(v), 4)
                              for k, v in ap_dict_j.items()}

    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
