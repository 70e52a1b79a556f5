"""Official KITTI detection AP evaluator (40 recall positions); the
counterpart of `jmodt_tpu/eval/detection_ap.py`.

Port of reference jmodt/detection/evaluation/{eval.py, evaluate.py}
with the identical protocol — threshold sweep (eval.py:10-27), difficulty
gates (eval.py:30-84), partitioned IoU (eval.py:335-408), greedy TP/FP/FN
statistics (eval.py:158-333), 41-point sampling with /40*100 mAP
(eval.py:549-553).

The reference needs numba + numba.cuda (rotated IoU); here the rotated BEV
overlap reuses jmodt_torch.ops.rotated_iou on the device it is given (same
clockwise-positive rotation convention as the reference's rbbox_to_corners,
rotate_iou.py:206-229) and the greedy loops are plain numpy: the evaluator
is offline and file-based.
"""

from __future__ import annotations

import io as sysio
import pathlib
import re
from typing import Dict, List, Sequence

import numpy as np
import torch

from jmodt_torch.device import resolve_device
from jmodt_torch.ops.rotated_iou import boxes_overlap_bev

_N_SAMPLE_PTS = 41


# --------------------------------------------------------------------------
# label IO (reference evaluate.py:10-63)
# --------------------------------------------------------------------------

def get_label_anno(label_path) -> Dict[str, np.ndarray]:
    annotations = {}
    with open(label_path, 'r') as f:
        lines = f.readlines()
    content = [line.strip().split(' ') for line in lines if line.strip()]
    annotations['name'] = np.array([x[0] for x in content])
    annotations['truncated'] = np.array([float(x[1]) for x in content])
    annotations['occluded'] = np.array([int(float(x[2])) for x in content])
    annotations['alpha'] = np.array([float(x[3]) for x in content])
    annotations['bbox'] = np.array(
        [[float(v) for v in x[4:8]] for x in content]).reshape(-1, 4)
    # hwl -> lhw (camera) (evaluate.py:35-38)
    annotations['dimensions'] = np.array(
        [[float(v) for v in x[8:11]] for x in content]).reshape(-1, 3)[:, [2, 0, 1]]
    annotations['location'] = np.array(
        [[float(v) for v in x[11:14]] for x in content]).reshape(-1, 3)
    annotations['rotation_y'] = np.array(
        [float(x[14]) for x in content]).reshape(-1)
    if len(content) != 0 and len(content[0]) == 16:
        annotations['score'] = np.array([float(x[15]) for x in content])
    else:
        annotations['score'] = np.zeros(len(annotations['bbox']))
    return annotations


def get_label_annos(label_folder, image_ids=None) -> List[dict]:
    if image_ids is None:
        paths = pathlib.Path(label_folder).glob('*.txt')
        prog = re.compile(r'^\d{6}.txt$')
        image_ids = sorted(int(p.stem) for p in paths if prog.match(p.name))
    if not isinstance(image_ids, list):
        image_ids = list(range(image_ids))
    folder = pathlib.Path(label_folder)
    return [get_label_anno(folder / ('%06d.txt' % int(i)))
            for i in image_ids]


# --------------------------------------------------------------------------
# overlaps
# --------------------------------------------------------------------------

def image_box_overlap(boxes: np.ndarray, query_boxes: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """2D box overlap, vectorized (reference eval.py:86-114)."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_n = ((boxes[:, 2] - boxes[:, 0])
              * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_k = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        ua = area_n + area_k - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_n, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_k, inter.shape)
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / ua, 0.0)


def rotate_iou_eval(boxes: np.ndarray, qboxes: np.ndarray,
                    criterion: int = -1, device=None) -> np.ndarray:
    """Rotated BEV overlap matrix with the reference's criterion semantics
    (rotate_iou.py:249-261).  boxes: (N, 5) [cx, cy, x_d, y_d, angle].

    The pairwise intersection areas are `ops.rotated_iou.boxes_overlap_bev`
    in float32 on `device` (default: the CUDA card; raises without one),
    at the inputs' own shapes; the criterion's division runs on the host
    in float64 on those areas, as the JAX package's does."""
    if boxes.shape[0] == 0 or qboxes.shape[0] == 0:
        return np.zeros((boxes.shape[0], qboxes.shape[0]), np.float32)
    dev = resolve_device(device)

    def to_corner_fmt(b):
        return torch.from_numpy(np.stack(
            [b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
             b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2,
             b[:, 4]], axis=1).astype(np.float32)).to(dev)

    with torch.no_grad():
        inter = boxes_overlap_bev(to_corner_fmt(boxes),
                                  to_corner_fmt(qboxes)).cpu().numpy()
    area1 = (boxes[:, 2] * boxes[:, 3])[:, None]
    area2 = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        return inter / (area1 + area2 - inter)
    if criterion == 0:
        return inter / area1
    if criterion == 1:
        return inter / area2
    return inter


def bev_box_overlap(boxes, qboxes, criterion=-1, device=None):
    return rotate_iou_eval(boxes, qboxes, criterion, device)


def d3_box_overlap(boxes: np.ndarray, qboxes: np.ndarray,
                   criterion: int = -1, device=None) -> np.ndarray:
    """3D overlap in camera coords (reference eval.py:121-154): rotated BEV
    intersection x height overlap.  boxes: (N, 7) [x, y, z, l, h, w, ry]."""
    rinc = rotate_iou_eval(boxes[:, [0, 2, 3, 5, 6]],
                           qboxes[:, [0, 2, 3, 5, 6]], 2, device)
    n, k = rinc.shape
    if n == 0 or k == 0:
        return rinc
    iw = (np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
          - np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                       qboxes[None, :, 1] - qboxes[None, :, 4]))
    area1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    area2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = iw * rinc
    if criterion == -1:
        ua = area1 + area2 - inc
    elif criterion == 0:
        ua = np.broadcast_to(area1, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area2, inc.shape)
    else:
        ua = inc
    return np.where((rinc > 0) & (iw > 0), inc / ua, 0.0)


# --------------------------------------------------------------------------
# protocol (reference eval.py:10-333)
# --------------------------------------------------------------------------

def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = _N_SAMPLE_PTS) -> List[float]:
    """Score thresholds hitting ~41 evenly-spaced recall points
    (reference eval.py:10-27)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (((r_recall - current_recall) < (current_recall - l_recall))
                and (i < len(scores) - 1)):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


_CLASS_NAMES = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting']
_MIN_HEIGHT = [40, 25, 25]
_MAX_OCCLUSION = [0, 1, 2]
_MAX_TRUNCATION = [0.15, 0.3, 0.5]


def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int):
    """Difficulty/type gating (reference eval.py:30-84)."""
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    cls_name = _CLASS_NAMES[current_class]
    num_valid_gt = 0
    for i in range(len(gt_anno['name'])):
        bbox = gt_anno['bbox'][i]
        gt_name = gt_anno['name'][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == cls_name:
            valid_class = 1
        elif cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno['occluded'][i] > _MAX_OCCLUSION[difficulty]
                  or gt_anno['truncated'][i] > _MAX_TRUNCATION[difficulty]
                  or height <= _MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno['name'][i] == 'DontCare':
            dc_bboxes.append(gt_anno['bbox'][i])
    for i in range(len(dt_anno['name'])):
        valid_class = 1 if dt_anno['name'][i].lower() == cls_name else -1
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < _MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


_NO_DETECTION = -10000000


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt,
                       ignored_det, dc_bboxes, metric, min_overlap,
                       thresh=0.0, compute_fp=False, compute_aos=False):
    """Greedy per-frame TP/FP/FN accumulation (reference
    compute_statistics_jit, eval.py:158-275).  overlaps is (num_dt, num_gt)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [False] * det_size
    if compute_fp:
        for i in range(det_size):
            if dt_scores[i] < thresh:
                ignored_threshold[i] = True
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = np.zeros(gt_size)
    thresh_idx = 0
    delta = np.zeros(gt_size)
    delta_idx = 0
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = _NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] \
                    or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap
                    and dt_score > valid_detection):
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == _NO_DETECTION
                  and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == _NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != _NO_DETECTION
              and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned_detection[det_idx] = True
        elif valid_detection != _NO_DETECTION:
            tp += 1
            thresholds[thresh_idx] = dt_scores[det_idx]
            thresh_idx += 1
            if compute_aos:
                delta[delta_idx] = gt_alphas[i] - dt_alphas[det_idx]
                delta_idx += 1
            assigned_detection[det_idx] = True
    if compute_fp:
        for i in range(det_size):
            if not (assigned_detection[i] or ignored_det[i] == -1
                    or ignored_det[i] == 1 or ignored_threshold[i]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(
                dt_bboxes, np.asarray(dc_bboxes), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if assigned_detection[j] or ignored_det[j] in (-1, 1) \
                            or ignored_threshold[j]:
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = np.zeros(fp + delta_idx)
            for i in range(delta_idx):
                tmp[i + fp] = (1.0 + np.cos(delta[i])) / 2.0
            similarity = np.sum(tmp) if (tp > 0 or fp > 0) else -1
    return tp, fp, fn, similarity, thresholds[:thresh_idx]


def gather_match_scores(overlaps, dt_scores, ignored_gt, ignored_det,
                        min_overlap):
    """Matched-detection scores of the threshold-gathering pass — the
    vectorized form of `compute_statistics(..., thresh=0.0,
    compute_fp=False)` (reference eval.py:158-275).  With compute_fp off
    the per-gt choice is simply "highest-score unassigned candidate above
    min_overlap" (first index on ties, like the reference's strict `>`
    scan); a score is recorded only when both the gt and the chosen det
    are same-class (ignored flag 0).  The sequential gt loop carries the
    assignment state; the det scan is a masked argmax.

    :param overlaps: (num_dt, num_gt)
    :return: list of matched dt scores (the reference's `thresholds`)
    """
    det_size = len(dt_scores)
    out = []
    if det_size == 0:
        return out
    assigned = np.zeros(det_size, bool)
    considered = np.asarray(ignored_det) != -1
    dt_scores = np.asarray(dt_scores, np.float64)
    for i in range(len(ignored_gt)):
        gi = ignored_gt[i]
        if gi == -1:
            continue
        cand = considered & ~assigned & (overlaps[:, i] > min_overlap)
        if not cand.any():
            continue
        j = int(np.argmax(np.where(cand, dt_scores, -np.inf)))
        assigned[j] = True
        if gi == 0 and ignored_det[j] == 0:
            out.append(float(dt_scores[j]))
    return out


def compute_statistics_batch(overlaps, gt_datas, dt_datas, ignored_gt,
                             ignored_det, dc_bboxes, metric, min_overlap,
                             thresholds, compute_aos=False):
    """All score thresholds of one frame in one pass — the vectorized
    re-expression of the compute_fp=True greedy (reference eval.py:158-275,
    where numba re-runs the whole frame per threshold).

    The sequential gt loop carries per-threshold assignment state as a
    (T, det) bool matrix; the per-gt detection choice collapses to two
    reductions because the reference's j-ordered state machine is equivalent
    to: "argmax-overlap over unassigned same-class candidates above
    min_overlap, else first unassigned ignored-class candidate" (the
    assigned_ignored_det flag only lets a real candidate displace an
    ignored one, which argmax-over-reals already guarantees).

    :return: (tp (T,), fp (T,), fn (T,), similarity (T,)) — similarity is
        -1 where tp + fp == 0, matching the scalar protocol.
    """
    thr = np.asarray(thresholds, np.float64)
    t_num = thr.shape[0]
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    ignored_gt = np.asarray(ignored_gt)
    ignored_det = np.asarray(ignored_det)
    tp = np.zeros(t_num, np.int64)
    fn = np.zeros(t_num, np.int64)
    sim_sum = np.zeros(t_num, np.float64)

    if det_size == 0:
        fn += np.sum(ignored_gt == 0)
        fp = np.zeros(t_num, np.int64)
        return tp, fp, fn, np.full(t_num, -1.0)

    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    score_ok = dt_scores[None, :] >= thr[:, None]          # (T, det)
    assigned = np.zeros((t_num, det_size), bool)
    type0 = ignored_det == 0
    type1 = ignored_det == 1

    for i in range(gt_size):
        gi = ignored_gt[i]
        if gi == -1:
            continue
        ov_ok = overlaps[:, i] > min_overlap               # (det,)
        elig = (~assigned) & score_ok
        c0 = elig & (type0 & ov_ok)[None, :]
        has0 = c0.any(axis=1)
        ov_masked = np.where(c0, overlaps[:, i][None, :], -np.inf)
        j0 = np.argmax(ov_masked, axis=1)                  # first max on ties
        c1 = elig & (type1 & ov_ok)[None, :]
        has1 = c1.any(axis=1)
        j1 = np.argmax(c1, axis=1)                         # first True
        found = has0 | has1
        det_idx = np.where(has0, j0, j1)
        assigned[found, det_idx[found]] = True
        if gi == 0:
            fn += ~found
            is_tp = has0                                   # real det matched
            tp += is_tp
            if compute_aos:
                delta = gt_alphas[i] - dt_alphas[det_idx]
                sim_sum += np.where(is_tp, (1.0 + np.cos(delta)) / 2.0, 0.0)
        # gi == 1: a found det is consumed (assigned) but never a TP

    fp_mask = (~assigned) & type0[None, :] & score_ok
    fp = fp_mask.sum(axis=1)
    if metric == 0 and len(dc_bboxes) > 0:
        overlaps_dt_dc = image_box_overlap(
            dt_datas[:, :4], np.asarray(dc_bboxes), 0)     # (det, ndc)
        hits_dc = (overlaps_dt_dc > min_overlap).any(axis=1)
        fp -= (fp_mask & hits_dc[None, :]).sum(axis=1)
    similarity = np.where(tp + fp > 0, sim_sum, -1.0)
    return tp, fp, fn, similarity


def _get_split_parts(num, num_part):
    same, rem = num // num_part, num % num_part
    if same == 0:
        return [rem]
    return [same] * num_part + ([rem] if rem else [])


def _boxes_for_metric(annos, metric):
    if metric == 0:
        return np.concatenate([a['bbox'] for a in annos], 0)
    if metric == 1:
        loc = np.concatenate([a['location'][:, [0, 2]] for a in annos], 0)
        dims = np.concatenate([a['dimensions'][:, [0, 2]] for a in annos], 0)
        rots = np.concatenate([a['rotation_y'] for a in annos], 0)
        return np.concatenate([loc, dims, rots[..., None]], axis=1)
    loc = np.concatenate([a['location'] for a in annos], 0)
    dims = np.concatenate([a['dimensions'] for a in annos], 0)
    rots = np.concatenate([a['rotation_y'] for a in annos], 0)
    return np.concatenate([loc, dims, rots[..., None]], axis=1)


def calculate_iou_partly(gt_annos, dt_annos, metric, num_parts=50,
                         device=None):
    """Part-batched overlap computation (reference eval.py:335-408).
    Returns per-frame (num_dt, num_gt)-sliced views when called as
    (dt, gt) like eval_class does."""
    assert len(gt_annos) == len(dt_annos)
    total_dt_num = np.array([len(a['name']) for a in dt_annos])
    total_gt_num = np.array([len(a['name']) for a in gt_annos])
    split_parts = _get_split_parts(len(gt_annos), num_parts)
    parted_overlaps = []
    example_idx = 0
    for num_part in split_parts:
        gt_part = gt_annos[example_idx:example_idx + num_part]
        dt_part = dt_annos[example_idx:example_idx + num_part]
        gt_boxes = _boxes_for_metric(gt_part, metric)
        dt_boxes = _boxes_for_metric(dt_part, metric)
        if metric == 0:
            overlap_part = image_box_overlap(gt_boxes, dt_boxes)
        elif metric == 1:
            overlap_part = bev_box_overlap(
                gt_boxes, dt_boxes, device=device).astype(
                np.float64)
        elif metric == 2:
            overlap_part = d3_box_overlap(
                gt_boxes, dt_boxes, device=device).astype(
                np.float64)
        else:
            raise ValueError('unknown metric')
        parted_overlaps.append(overlap_part)
        example_idx += num_part
    overlaps = []
    example_idx = 0
    for j, num_part in enumerate(split_parts):
        gt_num_idx = dt_num_idx = 0
        for i in range(num_part):
            g = total_gt_num[example_idx + i]
            d = total_dt_num[example_idx + i]
            overlaps.append(parted_overlaps[j][gt_num_idx:gt_num_idx + g,
                                               dt_num_idx:dt_num_idx + d])
            gt_num_idx += g
            dt_num_idx += d
        example_idx += num_part
    return overlaps, parted_overlaps, total_gt_num, total_dt_num


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    total_dc_num, ignored_gts, ignored_dets, dontcares = [], [], [], []
    total_num_valid_gt = 0
    for i in range(len(gt_annos)):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt_annos[i], dt_annos[i], current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, np.int64))
        ignored_dets.append(np.array(ignored_det, np.int64))
        dc = (np.stack(dc_bboxes, 0).astype(np.float64) if dc_bboxes
              else np.zeros((0, 4)))
        total_dc_num.append(dc.shape[0])
        dontcares.append(dc)
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate(
            [gt_annos[i]['bbox'], gt_annos[i]['alpha'][..., None]], 1))
        dt_datas_list.append(np.concatenate(
            [dt_annos[i]['bbox'], dt_annos[i]['alpha'][..., None],
             dt_annos[i]['score'][..., None]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
            dontcares, np.array(total_dc_num), total_num_valid_gt)


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, num_parts=50, device=None):
    """Reference eval_class (eval.py:445-553).  The rotated overlaps run on
    `device` (default: the CUDA card)."""
    assert len(gt_annos) == len(dt_annos)
    overlaps, _, _, _ = calculate_iou_partly(
        dt_annos, gt_annos, metric, num_parts, device)
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros(
        [num_class, num_difficulty, num_minoverlap, _N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)
    for m, current_class in enumerate(current_classes):
        for li, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
             dontcares, _, total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    thresholdss += gather_match_scores(
                        overlaps[i], dt_datas_list[i][:, -1],
                        ignored_gts[i], ignored_dets[i], min_overlap)
                thresholds = np.array(
                    get_thresholds(np.array(thresholdss),
                                   total_num_valid_gt))
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    tp, fp, fn, sim = compute_statistics_batch(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap=min_overlap,
                        thresholds=thresholds, compute_aos=compute_aos)
                    pr[:, 0] += tp
                    pr[:, 1] += fp
                    pr[:, 2] += fn
                    pr[:, 3] += np.where(sim != -1, sim, 0.0)
                for i in range(len(thresholds)):
                    recall[m, li, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, li, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, li, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, li, k, i] = np.max(
                        precision[m, li, k, i:], axis=-1)
                    recall[m, li, k, i] = np.max(recall[m, li, k, i:],
                                                 axis=-1)
                    if compute_aos:
                        aos[m, li, k, i] = np.max(aos[m, li, k, i:], axis=-1)
    return {'recall': recall, 'precision': precision, 'orientation': aos}


def get_mAP(prec: np.ndarray) -> np.ndarray:
    """AP over 40 recall positions (reference eval.py:549-553)."""
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def _print_str(value, *arg, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, device=None):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos, device=device)
    mAP_bbox = get_mAP(ret['precision'])
    mAP_aos = get_mAP(ret['orientation']) if compute_aos else None
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps, device=device)
    mAP_bev = get_mAP(ret['precision'])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps, device=device)
    mAP_3d = get_mAP(ret['precision'])
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             device=None):
    """Reference get_official_eval_result (eval.py:606-676); the rotated
    overlaps run on `device` (default: the CUDA card; raises without
    one)."""
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.7, 0.5, 0.5, 0.7, 0.5]])
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25],
                            [0.5, 0.25, 0.25, 0.5, 0.25]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    class_to_name = {0: 'Car', 1: 'Pedestrian', 2: 'Cyclist', 3: 'Van',
                     4: 'Person_sitting'}
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else c
                       for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]
    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break
    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos,
        device)

    result = ''
    for j, curcls in enumerate(current_classes):
        for i in range(min_overlaps.shape[0]):
            result += _print_str(
                f'{class_to_name[curcls]} '
                + 'AP@{:.2f}, {:.2f}, {:.2f}:'.format(*min_overlaps[i, :, j]))
            result += _print_str(f'bbox AP:{mAPbbox[j, 0, i]:.4f}, '
                                 f'{mAPbbox[j, 1, i]:.4f}, '
                                 f'{mAPbbox[j, 2, i]:.4f}')
            result += _print_str(f'bev  AP:{mAPbev[j, 0, i]:.4f}, '
                                 f'{mAPbev[j, 1, i]:.4f}, '
                                 f'{mAPbev[j, 2, i]:.4f}')
            result += _print_str(f'3d   AP:{mAP3d[j, 0, i]:.4f}, '
                                 f'{mAP3d[j, 1, i]:.4f}, '
                                 f'{mAP3d[j, 2, i]:.4f}')
            if compute_aos:
                result += _print_str(f'aos  AP:{mAPaos[j, 0, i]:.2f}, '
                                     f'{mAPaos[j, 1, i]:.2f}, '
                                     f'{mAPaos[j, 2, i]:.2f}')
    ret_dict = {
        'Car_3d_easy': mAP3d[0, 0, 0],
        'Car_3d_moderate': mAP3d[0, 1, 0],
        'Car_3d_hard': mAP3d[0, 2, 0],
        'Car_bev_easy': mAPbev[0, 0, 0],
        'Car_bev_moderate': mAPbev[0, 1, 0],
        'Car_bev_hard': mAPbev[0, 2, 0],
        'Car_image_easy': mAPbbox[0, 0, 0],
        'Car_image_moderate': mAPbbox[0, 1, 0],
        'Car_image_hard': mAPbbox[0, 2, 0],
    }
    return result, ret_dict


def evaluate_detections(label_path: str, result_path: str,
                        image_idx_list: Sequence, current_class=0,
                        score_thresh: float = -1, device=None):
    """File-based entry (reference evaluate.py:80-93); the rotated overlaps
    run on `device` (default: the CUDA card; raises without one)."""
    dt_annos = get_label_annos(result_path)
    if score_thresh > 0:
        dt_annos = [
            {k: v[np.asarray(a['score']) >= score_thresh]
             for k, v in a.items()} for a in dt_annos]
    gt_annos = get_label_annos(label_path, list(image_idx_list))
    return get_official_eval_result(gt_annos, dt_annos, current_class,
                                    device)
